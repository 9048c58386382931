"""The single-pair two-piece engine: kernel 13, its plain version, the
host side and bucket form.

Port of ``ksw2_tpu/ops/wavefront_extd.py``'s ``ExtdParams``,
``_extd_kernel_body`` and ``build_extd_call`` (the row-windowed
``_extd_phase_body`` / ``build_extd_phased`` fold in: they exist for the
TPU's static shapes) and of ``ksw2_tpu/ops/extd.py:extd2_device``.  The
forward is ``csrc/extz_fwd.cu`` in its two-piece form (counted as
``extd_fwd``): kernel 12's tiles, boundary history, replay and compact
store with the Suzuki-Kasahara deltas of ``spec/diagdiff.py:extd2``
(``ksw2_extd2_sse.c``): u, v, x, y and x2, y2 in signed bytes clamped at
``mat[0]``, the ``long_thres`` / ``long_diff`` first column, H seeded at
r = 0 with the PRE-swap ``q + e``, and Z-drop with the gap slope ``e2``.
Its plain version is the band route's ``band.band_forward_plain`` with
``prm.two``, laid out as the store by ``extz_fwd.compact_store``, as
``extz_forward_plain`` does for kernel 12.  Kernel 17 walks the store with
``min_intron = 0``.

The host side follows ``extd2_device``: the reset when ``m <= 1`` or
when ``-min_sc > 2 (q + e)`` on the POST-swap costs (``extd.py:82-87``),
the canonical swap (``band.make_band_params``), ``sc_N = -e2`` on a zero
N row, ``w < 0`` as ``max(qlen, tlen)``, the start cell with
``reach_end`` and ``end_bonus`` (``strips_walker.start_cells``), REV_CIGAR
honoured by ``unpack_cigars`` and the EQX post-pass (``extd.py:205-206``,
``band_walker.to_eqx``).  GENERIC_SC travels as the score table:
``_extd_prof``'s planes are the TPU's layout of it.  A launch is one pair
or a bucket (``extz.single_prep``).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from ..core.flags import Flag
from ..core.result import ExtzResult
from .band import make_band_params
from .band_walker import to_eqx
from .extz import (ExtzLaunch, _ez_of_fields, extz_cigar_launch,
                   extz_records, single_prep, unpack_extz_cigars)
from .extz_fwd import ExtzLayout, extz_forward_plain, single_forward_cuda
from .records import unpack_records
from .strips import canonical_costs, long_params


class ExtdParams(NamedTuple):
    """One pair's configuration: ``wavefront_extd.ExtdParams`` without the
    TPU layout (``chunk``, ``n_rows``, ``p_rows``); POST-swap costs."""
    qlen: int
    tlen: int
    m: int
    sc_mch: int
    sc_mis: int
    sc_N: int
    q: int
    e: int
    q2: int
    e2: int
    qe_pre_swap: int       # q + e before the swap: the H seed at r = 0
    long_thres: int
    long_diff: int
    w: int                 # resolved (>= 0)
    zdrop: int
    flag: int
    n_diag: int


def extd_params(query, target, m: int, mat, q: int, e: int, q2: int,
                e2: int, w: int = -1, zdrop: int = -1,
                flag: int = 0) -> ExtdParams:
    """One pair's :class:`ExtdParams` (``w < 0`` resolved, costs
    swapped), as ``extd2_device`` builds ``wfd.ExtdParams``."""
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, np.int8).reshape(-1)
    qe_pre = int(q) + int(e)
    q, e, q2, e2, _ = canonical_costs(q, e, q2, e2)
    lt, ld = long_params(q, e, q2, e2)
    sc_N = -e2 if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    return ExtdParams(qlen=qlen, tlen=tlen, m=int(m), sc_mch=int(mat[0]),
                      sc_mis=int(mat[1]), sc_N=sc_N, q=q, e=e, q2=q2, e2=e2,
                      qe_pre_swap=qe_pre, long_thres=int(lt),
                      long_diff=int(ld),
                      w=max(qlen, tlen) if w < 0 else int(w),
                      zdrop=int(zdrop), flag=int(flag),
                      n_diag=qlen + tlen - 1)


def extd_prep(query, target, qlen, tlen, w, m, mat, q, e, q2, e2, zdrop,
              flag, cig: bool) -> List[ExtzLaunch]:
    """Plan and pad one bucket's launches (host only): PRE-swap costs in,
    the launches carry the post-swap ones; ``w`` resolved (>= 0).  See
    ``extz.single_prep``."""
    prm = make_band_params(m, mat, q, e, zdrop, flag, cig, two=True, q2=q2,
                           e2=e2)
    return single_prep(prm, query, target, qlen, tlen, w)


# --------------------------------------------------------------------------
# Kernel 13: the forward, its plain version and its wrapper


def extd_forward_plain(qs, ts, qlen, tlen, w, table, prm, lay: ExtzLayout):
    """Plain PyTorch version of kernel 13: ``band_forward_plain`` with
    ``prm.two`` laid out as the compact store (``extz_forward_plain``);
    returns ``rec``, ``p`` and ``stop``."""
    if not prm.two:
        raise ValueError("kernel 13 is the two-piece (extd) forward")
    return extz_forward_plain(qs, ts, qlen, tlen, w, table, prm, lay)


def extd_forward_cuda(qs, ts, qlen, tlen, w, table, prm, lay: ExtzLayout):
    """Launch kernel 13 (``csrc/extz_fwd.cu`` in its two-piece form) on the
    current stream; the contract of ``extz_fwd.single_forward_cuda``."""
    return single_forward_cuda("extd_fwd", qs, ts, qlen, tlen, w, table, prm,
                               lay)


def extd_forward(qs, ts, qlen, tlen, w, table, prm, lay: ExtzLayout):
    """The forward on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if qs.is_cuda:
        return extd_forward_cuda(qs, ts, qlen, tlen, w, table, prm, lay)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return extd_forward_plain(qs, ts, qlen, tlen, w, table, prm, lay)


# --------------------------------------------------------------------------
# One launch end to end: the single-pair glue with kernel 13


extd_records = functools.partial(extz_records, forward=extd_forward)
extd_cigar_launch = functools.partial(extz_cigar_launch,
                                      forward=extd_forward)


def unpack_extd_cigars(launch: ExtzLaunch, rec: np.ndarray, res: np.ndarray,
                       runs: np.ndarray, mat,
                       end_bonus: int) -> List[ExtzResult]:
    """One launch's host records and walker output -> ExtzResults, their
    CIGARs in =/X ops when the flag has EQX (``extd.py:205-206``)."""
    return to_eqx(launch, unpack_extz_cigars(launch, rec, res, runs, mat,
                                             end_bonus))


def extd2_device(query, target, m: int, mat, q: int, e: int, q2: int,
                 e2: int, w: int = -1, zdrop: int = -1, end_bonus: int = 0,
                 flag=Flag.NONE, device="cuda") -> ExtzResult:
    """One pair on the single-pair two-piece engine
    (``extd.py:extd2_device``): the ``ksw_extz_t`` fields and, unless
    SCORE_ONLY, the CIGAR.  ``device`` runs the kernels ("cuda") or their
    plain versions ("cpu")."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    query, target = np.asarray(query), np.asarray(target)
    qlen, tlen = len(query), len(target)
    if m <= 1 or qlen <= 0 or tlen <= 0:
        return ez
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    qc, ec = canonical_costs(q, e, q2, e2)[:2]
    if -int(mat[1:].min()) > 2 * (qc + ec):
        return ez
    w = max(qlen, tlen) if w < 0 else w
    cig = not flag & Flag.SCORE_ONLY
    launch, = extd_prep([query], [target], [qlen], [tlen], [w], m, mat, q, e,
                        q2, e2, zdrop, int(flag), cig)
    dev = torch.device(device)
    if not cig:
        rec = extd_records(launch, dev).cpu().numpy()
        return _ez_of_fields(unpack_records(rec, int(mat[1:].min()), qc, ec),
                             0)
    rec, res, runs = (t.cpu().numpy() for t in
                      extd_cigar_launch(launch, end_bonus, dev))
    return unpack_extd_cigars(launch, rec, res, runs, mat, end_bonus)[0]


__all__ = ["ExtdParams", "extd_params", "extd_prep", "extd_forward_plain",
           "extd_forward_cuda", "extd_forward", "extd_records",
           "extd_cigar_launch", "unpack_extd_cigars", "extd2_device"]
