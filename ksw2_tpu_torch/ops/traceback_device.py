"""Kernel 17: the single-pair walker, its plain version and its wrapper.

Port of ``ksw2_tpu/ops/traceback_device.py`` (``TbParams``, ``_tb_kernel``;
``finish_cigar``'s tail flush, intron rule and reverse are
``strips_walker.finish_runs_batch``'s).  The walker runs ``ksw_backtrack``
(ksw2.h:129-161) with ``is_rot = 1`` from each pair's start cell over the
compact store of the single-pair forward (``ops/extz_fwd.py``): the byte of
cell (i, r - i) at ``pbase[b] + off(r) + i - st(r)``, with the band-edge
force states from the closed-form rounded band, 2 below it and, with
``upper_force`` (extz), 1 above it.  With ``upper_force = 0`` (gg2, whose
reference call passes no ``off_end``) a walk that goes above the band would
read past its row: it stops there and sets the escape flag, and its runs
must not be used.  ``min_intron > 0`` walks state 3 as N.  It emits BAM
runs ``len << 4 | op`` in walk order and ``(i_end, j_end, count,
escaped)`` into ``qlen + tlen + 2`` entries per pair, so the TPU walker's
op rows, block streaming and 2-bit packing are gone.

The walker has two implementations: ``csrc/extz_walk.cu`` for CUDA tensors
and :func:`extz_walk_plain` for CPU tensors, which finds each row's offset
by a running sum of the row widths where the kernel uses the closed form.
The kernel (``csrc/walk.cuh``) gives each pair a block of two warps, one
staging windows of the store in shared memory in whole 16-byte copies,
the other walking them: the store must start on a 16-byte boundary (the
compact layout's pair bases and rows are multiples of 16).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import CigarOp
from .bands import band_bounds_rounded
from .strips_walker import state_op


class TbParams(NamedTuple):
    """One walk's configuration: ``traceback_device.TbParams`` without the
    TPU store's layout (``p_rows``, ``blk``, ``n_blocks``, ``full_rows``)."""
    qlen: int
    tlen: int
    w: int
    n_diag: int
    min_intron: int
    upper_force: int


def extz_walk_plain(p, pbase, starts, qlen, tlen, w, wr: int,
                    min_intron: int = 0, upper_force: int = 1):
    """Plain version of ``csrc/extz_walk.cu``: ``ksw_backtrack`` pair by
    pair.  Returns ``res`` (B, 4) int32 (i_end, j_end, count, escaped)
    and ``runs`` (B, wr) int32 on ``p``'s device; a walk takes at most
    ``qlen + tlen`` steps, so ``wr = qlen + tlen + 2`` holds it."""
    d = p.cpu().numpy()
    pb = np.asarray(pbase.cpu().numpy() if torch.is_tensor(pbase) else pbase,
                    np.int64)
    st_ = starts.cpu().numpy()
    ql, tl, wl = (a.cpu().numpy() for a in (qlen, tlen, w))
    B = len(ql)
    res = np.zeros((B, 4), np.int32)
    runs = np.zeros((B, wr), np.int32)
    for b in range(B):
        i, j = int(st_[b, 0]), int(st_[b, 1])
        n = int(ql[b] + tl[b]) - 1
        _, _, sts, ens = band_bounds_rounded(n, int(ql[b]), int(tl[b]),
                                             int(wl[b]))
        off = np.zeros(n + 1, np.int64)
        np.cumsum(ens - sts + 1, out=off[1:])
        state = k = cnt = esc = 0
        op = -1
        while i >= 0 and j >= 0:
            r = i + j
            force = 2 if i < sts[r] else -1
            if i > ens[r]:
                if not upper_force:
                    esc = 1
                    break
                force = 1
            tmp = (int(d[pb[b] + off[r] + i - sts[r]]) if force < 0
                   else 0)
            if state == 0:
                state = tmp & 7
            elif not (tmp >> (state + 2)) & 1:
                state = 0
            if state == 0:
                state = tmp & 7
            if force >= 0:
                state = force
            o = state_op(state, min_intron)
            if o != int(CigarOp.INS):
                i -= 1
            if o in (int(CigarOp.MATCH), int(CigarOp.INS)):
                j -= 1
            if o == op:
                cnt += 1
            else:
                if cnt > 0:
                    runs[b, k] = (cnt << 4) | op
                    k += 1
                op, cnt = o, 1
        if cnt > 0:
            runs[b, k] = (cnt << 4) | op
            k += 1
        res[b] = (i, j, k, esc)
    return (torch.from_numpy(res).to(p.device),
            torch.from_numpy(runs).to(p.device))


def extz_walk_cuda(p, pbase, starts, qlen, tlen, w, wr: int,
                   min_intron: int = 0, upper_force: int = 1):
    """Launch ``csrc/extz_walk.cu`` on the current stream; same contract
    as :func:`extz_walk_plain` (runs past each pair's count are left
    unwritten)."""
    if not (p.is_cuda and starts.is_cuda):
        raise ValueError("p and starts must be CUDA tensors")
    dev = p.device
    if p.dtype != torch.uint8 or p.dim() != 1 or not p.is_contiguous():
        raise ValueError("p must be a contiguous 1-D uint8 tensor")
    if p.data_ptr() % 16:
        raise ValueError("p must start on a 16-byte boundary")
    B = len(qlen)
    for t, name, shape, dt in ((pbase, "pbase", (B,), torch.int64),
                               (starts, "starts", (B, 2), torch.int32),
                               (qlen, "qlen", (B,), torch.int32),
                               (tlen, "tlen", (B,), torch.int32),
                               (w, "w", (B,), torch.int32)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dt} "
                             f"tensor on {dev}")
    res = torch.empty((B, 4), dtype=torch.int32, device=dev)
    runs = torch.empty((B, wr), dtype=torch.int32, device=dev)
    ops = torch.empty(B * wr, dtype=torch.uint8, device=dev)   # scratch
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_extz_walk(
            p.data_ptr(), pbase.data_ptr(), starts.data_ptr(),
            qlen.data_ptr(), tlen.data_ptr(), w.data_ptr(), B, wr,
            int(min_intron), int(upper_force), res.data_ptr(),
            runs.data_ptr(), ops.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "extz_walk")
    LAUNCHES["extz_walk"] += 1
    return res, runs


def extz_walk(p, pbase, starts, qlen, tlen, w, wr: int, min_intron: int = 0,
              upper_force: int = 1):
    """The walker on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if p.is_cuda:
        return extz_walk_cuda(p, pbase, starts, qlen, tlen, w, wr,
                              min_intron, upper_force)
    if p.device.type != "cpu":
        raise ValueError(f"unsupported device {p.device}")
    return extz_walk_plain(p, pbase, starts, qlen, tlen, w, wr, min_intron,
                           upper_force)


__all__ = ["TbParams", "extz_walk", "extz_walk_plain", "extz_walk_cuda"]
