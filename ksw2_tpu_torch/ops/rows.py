"""Rows route: the one-piece score route for short pairs (q, t <= 128).

Port of ``ksw2_tpu/ops/wavefront_rows.py``.  The JAX package tries this
engine first for every score bucket that :func:`rows_eligible` accepts
(``batch/scheduler.py:242-247``).  Its kernel, ``csrc/rows_fwd.cu``,
gives each pair one warp, and writes the same D / Dq / hl streams as the
strips forward at the launch's canonical ``tv`` (<= 128), so
:func:`ops.strips.replay_records` turns them into the 9-field records
and a launch is planned by :func:`ops.strips.strips_prep`.  The TPU's
(128, B) sublane layout, its own packing and ``_postprocess`` are not
ported.  Score-only and one-piece, as the JAX engine is
(``wavefront_rows.py:48``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import Flag
from .strips import (Launch, StripParams, _check_cuda, key_params,
                     replay_records, strips_forward_plain, upload)

LQ_MAX = 128               # one warp of 32 lanes x 4 query columns


def rows_eligible(qlen, tlen, w, flag, zdrop, m, mat) -> bool:
    """True when every pair's band never clips the matrix bounds (the
    SSE diagonal band equals the matrix-shape bounds for all diagonals),
    qlen/tlen fit one lane row, and the mode is plain score-only (a copy
    of ``wavefront_rows.rows_eligible``)."""
    flag = int(flag)
    if flag & (int(Flag.APPROX_MAX) | int(Flag.APPROX_DROP)):
        return False
    if not (flag & int(Flag.SCORE_ONLY)):
        return False
    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)
    if qlen.size == 0 or qlen.max(initial=0) > 128 or \
            tlen.max(initial=0) > 128:
        return False
    if qlen.min(initial=1) < 1 or tlen.min(initial=1) < 1:
        return False
    w = np.asarray(w)
    r = np.arange(256, dtype=np.int64)[None, :]
    ql = qlen.astype(np.int64)[:, None]
    tl = tlen.astype(np.int64)[:, None]
    wl = w.astype(np.int64)[:, None]
    live = r < ql + tl - 1
    st_clip = (r - wl + 1) >> 1 > np.maximum(0, r - ql + 1)
    en_clip = (r + wl) >> 1 < np.minimum(tl - 1, r)
    return not bool(((st_clip | en_clip) & live).any())


def rows_forward_plain(qs, ts, qlen, tlen, table, prm: StripParams):
    """Plain version of ``csrc/rows_fwd.cu``.  The rows kernel computes
    the same function as the strips forward's one-piece score form, so
    this is :func:`ops.strips.strips_forward_plain`."""
    return strips_forward_plain(qs, ts, qlen, tlen, table, prm)


def _check_prm(Lq: int, prm: StripParams) -> None:
    if prm.two or prm.cig:
        raise ValueError("the rows kernel is one-piece and score-only")
    if Lq > LQ_MAX or prm.tv > LQ_MAX:
        raise ValueError(f"the rows kernel takes Lq, tv <= {LQ_MAX}, got "
                         f"{Lq}, {prm.tv}")
    if prm.m > 8:
        raise ValueError("the rows kernel takes m <= 8")


def rows_forward_cuda(qs, ts, qlen, tlen, table, prm: StripParams):
    """Launch ``csrc/rows_fwd.cu`` on the current stream; same contract
    as :func:`rows_forward_plain` (D, Dq, hl; no bytes)."""
    B, Lq = qs.shape
    tv = prm.tv
    nd = Lq + tv
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, tv), "target", dev)
    _check_cuda(qlen, torch.int32, (B,), "qlen", dev)
    _check_cuda(tlen, torch.int32, (B,), "tlen", dev)
    _check_cuda(table, torch.int32, (prm.m * prm.m,), "table", dev)
    _check_prm(Lq, prm)
    D = torch.empty((B, nd), dtype=torch.int32, device=dev)
    Dq = torch.empty((B, nd), dtype=torch.int32, device=dev)
    hl = torch.empty((B, Lq), dtype=torch.int32, device=dev)
    KB, _ = key_params(tv)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_rows_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            table.data_ptr(), B, Lq, tv, prm.m, prm.q, prm.e, prm.mat0, KB,
            D.data_ptr(), Dq.data_ptr(), hl.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "rows_fwd")
    LAUNCHES["rows_fwd"] += 1
    return D, Dq, hl, None


def rows_forward(qs, ts, qlen, tlen, table, prm: StripParams):
    """The rows forward on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if qs.is_cuda:
        return rows_forward_cuda(qs, ts, qlen, tlen, table, prm)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    _check_prm(qs.shape[1], prm)
    return rows_forward_plain(qs, ts, qlen, tlen, table, prm)


def rows_records(launch: Launch, device):
    """Rows forward + replay of one score launch; (B, 9) int32 records
    on ``device`` (enqueued, not synchronised)."""
    qs, ts, ql, tl, table = upload(launch, device)
    D, Dq, hl, _ = rows_forward(qs, ts, ql, tl, table, launch.prm)
    return replay_records(launch.prm, D, Dq, hl, ql, tl)


__all__ = ["LQ_MAX", "rows_eligible", "rows_forward", "rows_forward_plain",
           "rows_forward_cuda", "rows_records"]
