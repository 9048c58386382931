"""High-level alignment API: configure once, align many.

Port of ``ksw2_tpu/api.py`` for one-piece (extz), two-piece (extd) and
splice (exts) costs on the rows, strips, band, batched, any-device and
single-pair routes, and for global alignment (gg2).  Costs
and flags are bound at construction; the methods accept raw DNA strings
or encoded arrays and return
:class:`~ksw2_tpu_torch.core.result.ExtzResult` records with the exact
``ksw_extz_t`` field contract.

    >>> from ksw2_tpu_torch import Aligner
    >>> aln = Aligner(a=2, b=4, q=4, e=2, q2=13, e2=1, zdrop=100)
    >>> ezs = aln.extend_batch(pairs)                     # device="cuda"
    >>> spl = Aligner(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=9,
    ...               zdrop=200, flag=Flag.SPLICE_FOR)
    >>> ezs = spl.extend_batch(pairs, juncs=tracks)       # N-op CIGARs

``device="cuda"`` (the default) runs the CUDA kernels and raises when
there is no card; ``device="cpu"`` runs the kernels' plain PyTorch
versions.  :meth:`Aligner.extend` runs the single-pair engine of its
costs, as ``ksw2_tpu/api.py:96-112`` does: one-piece ``ops/extz.py``
(M ops under EQX), two-piece ``ops/extd.py`` (=/X under EQX) and splice
``ops/exts.py`` (N ops, with the pair's junction track), and
:meth:`Aligner.global_align` runs ``ops/gg2.py``.  Every bucket of a
batch has a route.  Meshes and pluggable engines raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .batch.scheduler import (AlignJob, align_batch_async,
                              align_batch_splice_async, resolve_device)
from .core.flags import Flag
from .core.matrix import encode_dna, simple_mat
from .core.result import ExtzResult
from .ops.extd import extd2_device
from .ops.exts import exts2_device
from .ops.extz import extz2_device
from .ops.gg2 import gg2_device

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
    and ``flag``; ``splice`` selects exts2 with the intron open ``q2``,
    the non-canonical site cost ``noncan`` and the junction bonus
    ``junc_bonus``.  A custom ``mat`` (m*m int8) overrides ``a``/``b``
    and implies GENERIC_SC unless it is a simple matrix.  ``device``
    selects the CUDA kernels or their plain versions.
    """

    def __init__(self, a: int = 2, b: int = 4, q: int = 4, e: int = 2,
                 q2: Optional[int] = None, e2: Optional[int] = None,
                 w: int = -1, zdrop: int = -1, end_bonus: int = 0,
                 flag: Flag | int = Flag.NONE, m: int = 5,
                 mat: Optional[np.ndarray] = None,
                 splice: bool = False, noncan: int = 0,
                 junc_bonus: int = 0, device="cuda"):
        self.splice = bool(splice)
        self.noncan = int(noncan)
        self.junc_bonus = int(junc_bonus)
        if self.splice and q2 is None:
            raise ValueError("splice mode needs q2 (intron open cost)")
        if (q2 is None) != (e2 is None) and not self.splice:
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
        """Extension alignment of one pair on the single-pair engine of
        the costs: ``ops/exts.py:exts2_device`` (splice; ``junc`` the
        pair's junction track), ``ops/extd.py:extd2_device`` (two-piece)
        or ``ops/extz.py:extz2_device`` (one-piece)."""
        query, target = _enc(query), _enc(target)
        if self.splice:
            return exts2_device(query, target, self.m, self.mat, self.q,
                                self.e, self.q2, self.noncan,
                                zdrop=self.zdrop, junc_bonus=self.junc_bonus,
                                flag=self.flag, junc=junc,
                                device=self.device)
        if junc is not None:
            raise ValueError("juncs requires splice=True")
        if self.q2 is not None:
            return extd2_device(query, target, self.m, self.mat, self.q,
                                self.e, self.q2, self.e2, w=self.w,
                                zdrop=self.zdrop, end_bonus=self.end_bonus,
                                flag=self.flag, device=self.device)
        return extz2_device(query, target, self.m, self.mat, self.q, self.e,
                            w=self.w, zdrop=self.zdrop,
                            end_bonus=self.end_bonus, flag=self.flag,
                            device=self.device)

    def global_align(self, query: Seq, target: Seq) -> ExtzResult:
        """Global (NW) alignment of one pair (ksw_gg2_sse semantics) on
        ``ops/gg2.py:gg2_device`` (kernel 16 and the flat walk), as
        ``ksw2_tpu/api.py:115-141``.  The reference's ``ksw_gg*`` return
        a bare score, so the max/mqe/mte fields are filled from the one
        cell a global alignment determines, the corner ``(tlen - 1,
        qlen - 1)``, and ``reach_end`` is set."""
        qs, ts = _enc(query), _enc(target)
        score, cig, _ = gg2_device(qs, ts, self.m, self.mat, self.q, self.e,
                                   w=self.w, device=self.device)
        qlen, tlen = len(qs), len(ts)
        ez = ExtzResult()
        ez.reset()
        ez.score = score
        ez.max = score
        ez.max_t, ez.max_q = tlen - 1, qlen - 1
        ez.mqe, ez.mqe_t = score, tlen - 1
        ez.mte, ez.mte_q = score, qlen - 1
        ez.reach_end = True
        ez.cigar = cig
        return ez

    def _jobs(self, pairs, w) -> List[AlignJob]:
        return [AlignJob(query=_enc(qy), target=_enc(tg),
                         w=int(w[i]) if w is not None else self.w)
                for i, (qy, tg) in enumerate(pairs)]

    def extend_batch(self, pairs: Sequence[Tuple[Seq, Seq]],
                     w: Optional[Sequence[int]] = None, run_fn=None,
                     juncs=None, mesh=None) -> List[ExtzResult]:
        """Extension alignment of many pairs through the bucketing
        scheduler (scores + CIGARs; score-only when SCORE_ONLY is set).
        ``w`` optionally gives per-pair bands; ``juncs`` per-pair
        junction tracks (splice mode, one array or None a pair)."""
        if run_fn is not None or mesh is not None:
            raise NotImplementedError(
                "pluggable engines and multi-device meshes (ROADMAP "
                "item 15)")
        return self.extend_batch_async(pairs, w, juncs).result()

    def extend_batch_async(self, pairs: Sequence[Tuple[Seq, Seq]],
                           w: Optional[Sequence[int]] = None, juncs=None):
        """Submit a batch without waiting; the handle's ``.result()``
        yields the list :meth:`extend_batch` would.  The launches are
        enqueued on the current CUDA stream; ``result()`` synchronises."""
        if juncs is not None and not self.splice:
            raise ValueError("juncs requires splice=True")
        if self.splice:
            return align_batch_splice_async(
                self._jobs(pairs, w), self.m, self.mat, self.q, self.e,
                self.q2, self.noncan, zdrop=self.zdrop,
                junc_bonus=self.junc_bonus, flag=self.flag, juncs=juncs,
                device=self.device)
        return align_batch_async(self._jobs(pairs, w), self.m, self.mat,
                                 self.q, self.e, q2=self.q2, e2=self.e2,
                                 zdrop=self.zdrop, end_bonus=self.end_bonus,
                                 flag=self.flag, device=self.device)


__all__ = ["Aligner"]
