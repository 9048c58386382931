"""High-level alignment API: configure once, align many.

Port of ``ksw2_tpu/api.py`` for one-piece (extz) and two-piece (extd)
costs on the strips and rows routes.  Costs and flags are bound at
construction; the methods accept raw DNA strings or encoded arrays and
return :class:`~ksw2_tpu_torch.core.result.ExtzResult` records with the
exact ``ksw_extz_t`` field contract.

    >>> from ksw2_tpu_torch import Aligner
    >>> aln = Aligner(a=2, b=4, q=4, e=2, q2=13, e2=1, zdrop=100)
    >>> ezs = aln.extend_batch(pairs)                     # device="cuda"

``device="cuda"`` (the default) runs the CUDA kernels and raises when
there is no card; ``device="cpu"`` runs the kernels' plain PyTorch
versions.  Splice costs, global alignment, meshes, pluggable engines,
and two-piece SCORE_ONLY batches with ``end_bonus`` or EXTZ_ONLY raise
``NotImplementedError`` naming the ROADMAP.md item that brings them;
so does any job outside the strips envelope.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .batch.scheduler import (AlignJob, align_batch, align_batch_async,
                              resolve_device)
from .core.flags import Flag
from .core.matrix import encode_dna, simple_mat
from .core.result import ExtzResult

Seq = Union[str, np.ndarray]


def _enc(s: Seq) -> np.ndarray:
    if isinstance(s, str):
        return encode_dna(s)
    return np.asarray(s)


class Aligner:
    """Pairwise extension aligner with fixed scoring.

    Parameters mirror ``ksw2_tpu.Aligner``: match ``a``, mismatch ``b``
    (positive), gap open/extend ``q``/``e``, optional two-piece
    ``q2``/``e2`` (extd2), band ``w``, Z-drop ``zdrop``, ``end_bonus``
    and ``flag``.  A custom ``mat`` (m*m int8) overrides ``a``/``b`` and
    implies GENERIC_SC unless it is a simple matrix.  ``device`` selects
    the CUDA kernels or their plain versions.
    """

    def __init__(self, a: int = 2, b: int = 4, q: int = 4, e: int = 2,
                 q2: Optional[int] = None, e2: Optional[int] = None,
                 w: int = -1, zdrop: int = -1, end_bonus: int = 0,
                 flag: Flag | int = Flag.NONE, m: int = 5,
                 mat: Optional[np.ndarray] = None,
                 splice: bool = False, device="cuda"):
        if splice:
            raise NotImplementedError(
                "splice (exts) costs: strips prm.spl (ROADMAP item 9)")
        if (q2 is None) != (e2 is None):
            raise ValueError("two-piece costs need both q2 and e2")
        self.q2 = None if q2 is None else int(q2)
        self.e2 = None if e2 is None else int(e2)
        self.device = resolve_device(device)
        self.m = int(m)
        self.flag = Flag(int(flag))
        if mat is not None:
            self.mat = np.asarray(mat, np.int8).reshape(-1)
            if not self._is_simple(self.mat, self.m):
                self.flag |= Flag.GENERIC_SC
        else:
            self.mat = simple_mat(self.m, int(a), -int(b))
        self.q, self.e = int(q), int(e)
        self.w, self.zdrop = int(w), int(zdrop)
        self.end_bonus = int(end_bonus)

    @staticmethod
    def _is_simple(mat: np.ndarray, m: int) -> bool:
        sq = mat.reshape(m, m)
        a, b = int(sq[0, 0]), int(sq[0, 1])
        want = np.full((m, m), b, np.int8)
        np.fill_diagonal(want, a)
        want[m - 1, :] = 0
        want[:, m - 1] = 0
        return bool((sq == want).all())

    def extend(self, query: Seq, target: Seq, junc=None) -> ExtzResult:
        """Extension alignment of one pair: one pair through
        :meth:`extend_batch`, within the strips envelope."""
        if junc is not None:
            raise NotImplementedError("junction tracks (ROADMAP item 9)")
        return self.extend_batch([(query, target)])[0]

    def global_align(self, query: Seq, target: Seq) -> ExtzResult:
        raise NotImplementedError(
            "global alignment: the gg2 engines (ROADMAP items 11, 12)")

    def _jobs(self, pairs, w) -> List[AlignJob]:
        return [AlignJob(query=_enc(qy), target=_enc(tg),
                         w=int(w[i]) if w is not None else self.w)
                for i, (qy, tg) in enumerate(pairs)]

    def extend_batch(self, pairs: Sequence[Tuple[Seq, Seq]],
                     w: Optional[Sequence[int]] = None, run_fn=None,
                     juncs=None, mesh=None) -> List[ExtzResult]:
        """Extension alignment of many pairs through the bucketing
        scheduler (scores + CIGARs; score-only when SCORE_ONLY is set).
        ``w`` optionally gives per-pair bands."""
        if run_fn is not None or mesh is not None:
            raise NotImplementedError(
                "pluggable engines and multi-device meshes (ROADMAP "
                "item 15)")
        if juncs is not None:
            raise NotImplementedError("junction tracks (ROADMAP item 9)")
        return align_batch(self._jobs(pairs, w), self.m, self.mat, self.q,
                           self.e, q2=self.q2, e2=self.e2, zdrop=self.zdrop,
                           end_bonus=self.end_bonus, flag=self.flag,
                           device=self.device)

    def extend_batch_async(self, pairs: Sequence[Tuple[Seq, Seq]],
                           w: Optional[Sequence[int]] = None, juncs=None):
        """Submit a batch without waiting; the handle's ``.result()``
        yields the list :meth:`extend_batch` would.  The launches are
        enqueued on the current CUDA stream; ``result()`` synchronises."""
        if juncs is not None:
            raise NotImplementedError("junction tracks (ROADMAP item 9)")
        return align_batch_async(self._jobs(pairs, w), self.m, self.mat,
                                 self.q, self.e, q2=self.q2, e2=self.e2,
                                 zdrop=self.zdrop, end_bonus=self.end_bonus,
                                 flag=self.flag, device=self.device)


__all__ = ["Aligner"]
