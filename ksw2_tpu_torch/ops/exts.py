"""The single-pair splice engine: kernel 14, its plain version, the host
side and bucket form.

Port of ``ksw2_tpu/ops/wavefront_exts.py``'s ``ExtsParams`` and
``_exts_kernel_body`` (the row-windowed ``_exts_phase_body`` /
``build_exts_phased`` fold in: they exist for the TPU's static shapes) and
of ``ksw2_tpu/ops/exts.py:exts2_device``.  The forward is
``csrc/extz_fwd.cu`` in its splice form (counted as ``exts_fwd``): kernel
12's tiles, boundary history, replay and compact store with the spliced
recurrence of ``spec/diagdiff.py:exts2`` (``ksw2_exts2_sse.c``): the
intron delta x2 (deletion side only), the donor and acceptor rows of each
tile's own positions, the junction bonus folded into them, no per-cell
clamp, H without offsets and Z-drop with no gap slope.  exts has no band:
its bounds come from the shape alone, which is the band ``w = max(qlen,
tlen)`` (the JAX fused walker's choice, ``exts.py:48-55``), so the store,
the kernel and the walker take that ``w``.  The plain version is the
batched route's ``batch_exts.batch_exts_forward_plain`` laid out as the
store by ``extz_fwd.compact_store``.  Kernel 17 walks the store with
``min_intron = long_thres``, so introns print N.

The host side follows ``exts2_device``: the reset when ``m <= 1``, ``q2
<= q + e`` or ``-min_sc > 2 (q + e)`` (``exts.py:87-92``), ``long_thres``
/ ``long_diff`` with ``e2 = 0``, the site rows from ``splice.
splice_profiles`` with the pair's junction track, the start cell with no
``reach_end`` and no end bonus (``exts.py:184-189``), REV_CIGAR honoured
by ``unpack_cigars`` and no EQX pass (``exts.py:221``).  A launch is one
pair or a bucket (``extz.single_prep``).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from ..core.flags import Flag
from ..core.result import ExtzResult
from .bands import n_col_bytes
from .batch_exts import (ExtsParams, batch_exts_forward_plain,
                         batch_exts_resets, make_exts_params)
from .extz import (ExtzLaunch, _ez_of_fields, extz_cigar_launch,
                   extz_records, single_prep, unpack_extz_cigars)
from .extz_fwd import ExtzLayout, compact_store, single_forward_cuda
from .records import unpack_records
from .splice import pad_juncs, splice_profiles


class ExtsPairParams(NamedTuple):
    """One pair's configuration: ``wavefront_exts.ExtsParams`` without
    the TPU layout (``chunk``, ``n_rows``, ``p_rows``)."""
    qlen: int
    tlen: int
    m: int
    sc_mch: int
    sc_mis: int
    sc_N: int
    q: int
    e: int
    q2: int                # intron open
    long_thres: int
    long_diff: int
    zdrop: int
    flag: int
    n_diag: int


def exts_params(query, target, m: int, mat, q: int, e: int, q2: int,
                zdrop: int = -1, flag: int = 0) -> ExtsPairParams:
    """One pair's :class:`ExtsPairParams`, as ``exts2_device`` builds
    ``wfs.ExtsParams``."""
    prm = make_exts_params(m, mat, q, e, q2, zdrop, flag)
    qlen, tlen = len(query), len(target)
    return ExtsPairParams(qlen=qlen, tlen=tlen, m=prm.m, sc_mch=prm.sc_mch,
                          sc_mis=prm.sc_mis, sc_N=prm.sc_N, q=prm.q, e=prm.e,
                          q2=prm.q2, long_thres=prm.lt, long_diff=prm.ld,
                          zdrop=prm.zdrop, flag=prm.flag,
                          n_diag=qlen + tlen - 1)


def exts_prep(query, target, qlen, tlen, m, mat, q, e, q2, noncan, zdrop,
              flag, juncs=None, junc_bonus: int = 0,
              cig: bool = True) -> List[ExtzLaunch]:
    """Plan and pad one splice bucket's launches (host only) at ``w =
    max(qlen, tlen)``, each with its int8 donor and acceptor rows (its
    ``sites``) and the pairs' junction tracks (``juncs``: one array or
    None a pair, in the bucket's order) folded in as ``junc_bonus``.
    Callers must have checked the reset guard
    (``batch_exts.batch_exts_resets``).  See ``extz.single_prep``."""
    qlen = np.asarray(qlen, np.int32)
    tlen = np.asarray(tlen, np.int32)
    w = np.maximum(qlen, tlen).astype(np.int32)
    prm = make_exts_params(m, mat, q, e, q2, zdrop, flag, cig)

    def sites(i0, tpad, tl):
        Lt = tpad.shape[1]
        jb = pad_juncs(None if juncs is None else juncs[i0:i0 + len(tl)],
                       tl, Lt)
        return splice_profiles(tpad, tl, Lt, noncan, flag, jb, junc_bonus)
    return single_prep(prm, query, target, qlen, tlen, w, sites)


# --------------------------------------------------------------------------
# Kernel 14: the forward, its plain version and its wrapper


def exts_forward_plain(qs, ts, qlen, tlen, w, table, don, acc,
                       prm: ExtsParams, lay: ExtzLayout):
    """Plain PyTorch version of kernel 14: kernel 6's plain version with
    its bytes laid out as the compact store at ``w`` (``max(qlen, tlen)``
    a pair); returns ``rec``, ``p`` (rows past a pair's stop are 0) and
    ``stop``."""
    ql, tl, wl = (a.cpu().numpy() for a in (qlen, tlen, w))
    nd = int((ql.astype(np.int64) + tl - 1).max())
    ncol = max(n_col_bytes(int(a), int(b), int(c))
               for a, b, c in zip(ql, tl, wl)) if prm.cig else 16
    rec, pb, stop = batch_exts_forward_plain(qs, ts, qlen, tlen, w, table,
                                             don, acc, prm, nd, ncol,
                                             with_stop=True)
    p = compact_store(pb, ql, tl, wl, lay) if prm.cig else None
    return rec, p, stop


def exts_forward_cuda(qs, ts, qlen, tlen, w, table, don, acc,
                      prm: ExtsParams, lay: ExtzLayout):
    """Launch kernel 14 (``csrc/extz_fwd.cu`` in its splice form) on the
    current stream; the contract of ``extz_fwd.single_forward_cuda``."""
    return single_forward_cuda("exts_fwd", qs, ts, qlen, tlen, w, table, prm,
                               lay, (don, acc))


def exts_forward(qs, ts, qlen, tlen, w, table, don, acc, prm: ExtsParams,
                 lay: ExtzLayout):
    """The forward on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    args = (qs, ts, qlen, tlen, w, table, don, acc, prm, lay)
    if qs.is_cuda:
        return exts_forward_cuda(*args)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return exts_forward_plain(*args)


# --------------------------------------------------------------------------
# One launch end to end: the single-pair glue with kernel 14, walked with
# min_intron = long_thres and no end bonus


exts_records = functools.partial(extz_records, forward=exts_forward)


def exts_cigar_launch(launch: ExtzLaunch, device):
    """Forward with bytes, start cells (no ``reach_end``, no end bonus)
    and walker with ``min_intron = long_thres`` for one launch; returns
    (rec, res, runs) tensors on ``device`` (enqueued, not synchronised)."""
    return extz_cigar_launch(launch, 0, device, forward=exts_forward,
                             min_intron=launch.prm.lt)


def unpack_single_exts_cigars(launch: ExtzLaunch, rec: np.ndarray,
                              res: np.ndarray, runs: np.ndarray,
                              mat) -> List[ExtzResult]:
    """One launch's host records and walker output -> ExtzResults with N
    ops for introns (``min_intron = long_thres``, the tail N too); no EQX
    pass."""
    return unpack_extz_cigars(launch, rec, res, runs, mat, 0, launch.prm.lt)


def exts2_device(query, target, m: int, mat, q: int, e: int, q2: int,
                 noncan: int, zdrop: int = -1, junc_bonus: int = 0,
                 flag=Flag.NONE, junc=None, device="cuda") -> ExtzResult:
    """One pair on the single-pair splice engine
    (``exts.py:exts2_device``): the ``ksw_extz_t`` fields and, unless
    SCORE_ONLY, the CIGAR with N ops; ``junc`` is the pair's junction
    track.  ``device`` runs the kernels ("cuda") or their plain versions
    ("cpu")."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    query, target = np.asarray(query), np.asarray(target)
    qlen, tlen = len(query), len(target)
    if qlen <= 0 or tlen <= 0 or batch_exts_resets(m, mat, q, e, q2):
        return ez
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    cig = not flag & Flag.SCORE_ONLY
    launch, = exts_prep([query], [target], [qlen], [tlen], m, mat, q, e, q2,
                        noncan, zdrop, int(flag),
                        None if junc is None else [junc], junc_bonus, cig)
    dev = torch.device(device)
    if not cig:
        rec = exts_records(launch, dev).cpu().numpy()
        return _ez_of_fields(unpack_records(rec, int(mat[1:].min()), q, e),
                             0)
    rec, res, runs = (t.cpu().numpy() for t in exts_cigar_launch(launch,
                                                                 dev))
    return unpack_single_exts_cigars(launch, rec, res, runs, mat)[0]


__all__ = ["ExtsPairParams", "exts_params", "exts_prep",
           "exts_forward_plain", "exts_forward_cuda", "exts_forward",
           "exts_records", "exts_cigar_launch", "unpack_single_exts_cigars",
           "exts2_device"]
