"""Band CIGARs: the walker over the band forward's rotated byte store.

Port of ``ksw2_tpu/ops/traceback_band.py`` and of ``band_batch.py:
device_walk_*``.  The forward (``ops/band.py`` with ``cig``) stores the
reference's direction bytes per diagonal, ``p[b, r, t - st(r)]``; the
walker runs ``ksw_backtrack`` (ksw2.h:129-161) with ``is_rot = 1`` from
each pair's start cell: ``r = i + j``, the byte at ``p[b, r, i - st(r)]``,
and the band-edge force states (2 when ``i < st(r)``, 1 when
``i > en(r)``), with ``st(r)`` and ``en(r)``, the 16-rounded band bounds,
recomputed in closed form from (r, qlen, tlen, w).  It emits BAM runs
``len << 4 | op`` in walk order and ``(i_end, j_end, count)``, like the
strips walker, into ``qlen + tlen + 2`` entries per pair, so the JAX
route's device RLE, its ``MAXR`` cap and its overflow fallback are gone.
:func:`ops.strips_walker.finish_runs_batch` and ``unpack_cigars`` finish
the CIGARs.  On the band route two-piece CIGARs turn to EQX after the
walk (``band_batch.py:833-838``) and one-piece ones keep M ops, as the
reference's extz2 ignores ``KSW_EZ_EQX``; the batched route, whose
forward (``csrc/batch_fwd.cu``) writes the same store, converts both.

The walker has two implementations: ``csrc/band_walk.cu`` for CUDA
tensors and :func:`band_walk_plain` for CPU tensors.  Its flat form
(:func:`flat_walk`, the same source) walks gg2's flat store
(``ops/batch_gg2.py``) from the corner as ``ksw_gg2_sse`` calls
``ksw_backtrack`` (``ksw2_gg2_sse.c:124``): no upper force state (NULL
``off_end``), so a walk that leaves the band upward reads on into the
next rows, and past the pair's store it reads 0 (``spec/backtrack.py``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core import cigar as cigarmod
from ..core.flags import CigarOp, Flag
from ..core.result import ExtzResult
from .band import (BandLaunch, band_forward, band_forward_cuda,
                   band_forward_plain, band_upload)
from .bands import band_bounds_rounded
from .strips_walker import (finish_runs_batch, start_cells, state_op,
                            unpack_cigars, walk_min_intron)


def _walk(i: int, j: int, cell, min_intron: int):
    """``ksw_backtrack``'s loop (ksw2.h:129-161) from (i, j) over a store
    read through ``cell(r, i) -> (force, byte)`` (force -1 for none):
    returns the end cell and the BAM runs ``len << 4 | op`` in walk
    order."""
    runs = []
    state = n = 0
    op = -1
    while i >= 0 and j >= 0:
        force, tmp = cell(i + j, i)
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
            n += 1
        else:
            if n > 0:
                runs.append((n << 4) | op)
            op, n = o, 1
    if n > 0:
        runs.append((n << 4) | op)
    return i, j, runs


def band_walk_plain(p, starts, qlen, tlen, w, min_intron: int = 0):
    """Plain version of ``csrc/band_walk.cu``: ``ksw_backtrack`` with
    ``is_rot = 1`` pair by pair (state 3 emits N when ``min_intron >
    0``).  Returns ``res`` (B, 3) int32 (i_end, j_end, count) and
    ``runs`` (B, nd + 3) int32 on ``p``'s device; a pair's walk takes at
    most ``qlen + tlen <= nd + 1`` steps."""
    d = p.cpu().numpy()
    st = starts.cpu().numpy()
    ql, tl, wl = (a.cpu().numpy() for a in (qlen, tlen, w))
    B = d.shape[0]
    res = np.zeros((B, 3), np.int32)
    runs = np.zeros((B, d.shape[1] + 3), np.int32)
    for b in range(B):
        _, _, sts, ens = band_bounds_rounded(int(ql[b] + tl[b]) - 1,
                                             int(ql[b]), int(tl[b]),
                                             int(wl[b]))

        def cell(r, i, b=b, sts=sts, ens=ens):
            force = 1 if i > ens[r] else 2 if i < sts[r] else -1
            return force, int(d[b, r, i - sts[r]]) if force < 0 else 0
        i, j, rl = _walk(int(st[b, 0]), int(st[b, 1]), cell, min_intron)
        runs[b, :len(rl)] = rl
        res[b] = (i, j, len(rl))
    return (torch.from_numpy(res).to(p.device),
            torch.from_numpy(runs).to(p.device))


def band_walk_cuda(p, starts, qlen, tlen, w, min_intron: int = 0):
    """Launch ``csrc/band_walk.cu`` on the current stream; same contract
    as :func:`band_walk_plain` (runs past each pair's count are left
    unwritten)."""
    if not (p.is_cuda and starts.is_cuda):
        raise ValueError("p and starts must be CUDA tensors")
    dev = p.device
    if p.dtype != torch.uint8 or p.dim() != 3 or not p.is_contiguous():
        raise ValueError("p must be a contiguous (B, nd, ncol) uint8 tensor")
    B, nd, ncol = p.shape
    for t, name, shape in ((starts, "starts", (B, 2)), (qlen, "qlen", (B,)),
                           (tlen, "tlen", (B,)), (w, "w", (B,))):
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} int32 "
                             f"tensor on {dev}")
    wr = nd + 3                 # from the shape: no device read
    res = torch.empty((B, 3), dtype=torch.int32, device=dev)
    runs = torch.empty((B, wr), dtype=torch.int32, device=dev)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_band_walk(
            p.data_ptr(), starts.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), w.data_ptr(), B, nd, ncol, wr, int(min_intron),
            res.data_ptr(), runs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "band_walk")
    LAUNCHES["band_walk"] += 1
    return res, runs


def band_walk(p, starts, qlen, tlen, w, min_intron: int = 0):
    """The walker on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if p.is_cuda:
        return band_walk_cuda(p, starts, qlen, tlen, w, min_intron)
    if p.device.type != "cpu":
        raise ValueError(f"unsupported device {p.device}")
    return band_walk_plain(p, starts, qlen, tlen, w, min_intron)


def flat_walk_plain(p, pbase, qlen, tlen, w):
    """Plain version of ``csrc/band_walk.cu``'s flat form: ``ksw_backtrack``
    with ``is_rot = 1``, ``off = st(r)`` and no ``off_end`` from each
    pair's corner over the flat store ``p`` (pair b's rows from
    ``pbase[b]``, ``n_col`` bytes a row).  Returns ``res`` (B, 3) int32
    (i_end, j_end, count) and ``runs`` (B, max(qlen + tlen) + 2) int32 on
    ``p``'s device."""
    from .batch_gg2 import gg2_ncol

    d = p.cpu().numpy()
    pb = pbase.cpu().numpy()
    ql, tl, wl = (a.cpu().numpy().astype(np.int64) for a in (qlen, tlen, w))
    B = len(ql)
    ncol = gg2_ncol(tl, wl)
    res = np.zeros((B, 3), np.int32)
    runs = np.zeros((B, int(np.max(ql + tl, initial=0)) + 2), np.int32)
    for b in range(B):
        nc, base = int(ncol[b]), int(pb[b])
        size = int(ql[b] + tl[b]) * nc

        def cell(r, i, b=b, nc=nc, base=base, size=size):
            st = max(0, r - int(ql[b]) + 1, (r - int(wl[b]) + 1) >> 1) & ~15
            k = r * nc + i - st
            if i < st:
                return 2, 0
            return -1, int(d[base + k]) if k < size else 0
        i, j, rl = _walk(int(tl[b]) - 1, int(ql[b]) - 1, cell, 0)
        runs[b, :len(rl)] = rl
        res[b] = (i, j, len(rl))
    return (torch.from_numpy(res).to(p.device),
            torch.from_numpy(runs).to(p.device))


def flat_walk_cuda(p, pbase, qlen, tlen, w):
    """Launch ``csrc/band_walk.cu``'s flat form on the current stream
    (counted as ``band_walk``); same contract as :func:`flat_walk_plain`
    (runs past each pair's count are left unwritten)."""
    if not (p.is_cuda and pbase.is_cuda):
        raise ValueError("p and pbase must be CUDA tensors")
    dev = p.device
    if p.dtype != torch.uint8 or p.dim() != 1 or not p.is_contiguous():
        raise ValueError("p must be a contiguous 1-d uint8 tensor")
    B = qlen.shape[0]
    for t, name in ((qlen, "qlen"), (tlen, "tlen"), (w, "w")):
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B},) int32 "
                             f"tensor on {dev}")
    if pbase.dtype != torch.int64 or tuple(pbase.shape) != (B,):
        raise ValueError(f"pbase must be a ({B},) int64 tensor")
    # gg2's start cell: the corner (tlen - 1, qlen - 1)
    starts = torch.stack([tlen - 1, qlen - 1], 1).to(torch.int32)
    wr = int((qlen + tlen).max()) + 2 if B else 2
    res = torch.empty((B, 3), dtype=torch.int32, device=dev)
    runs = torch.empty((B, wr), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.ksw2t_flat_walk(
            p.data_ptr(), pbase.data_ptr(), starts.data_ptr(),
            qlen.data_ptr(), tlen.data_ptr(), w.data_ptr(), B, wr,
            res.data_ptr(), runs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "band_walk")
    LAUNCHES["band_walk"] += 1
    return res, runs


def flat_walk(p, pbase, qlen, tlen, w):
    """The flat walk on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if p.is_cuda:
        return flat_walk_cuda(p, pbase, qlen, tlen, w)
    if p.device.type != "cpu":
        raise ValueError(f"unsupported device {p.device}")
    return flat_walk_plain(p, pbase, qlen, tlen, w)


def flat_walk_cigars(res, runs) -> List[list]:
    """The flat walk's output -> CIGARs: the tail D then I, merged and
    reversed (``ksw_backtrack``'s end, ``is_rev`` 0)."""
    res = res.cpu().numpy()
    return finish_runs_batch(runs.cpu().numpy(), res[:, 2], res[:, 0],
                             res[:, 1], 0, False)


def band_cigar_launch(launch: BandLaunch, end_bonus: int, device,
                      cuda=band_forward_cuda, plain=band_forward_plain):
    """Forward with bytes (the pair ``cuda`` / ``plain``, see
    :func:`ops.band.band_forward`), start cells (ksw2_extz2_sse.c:292-301,
    ksw2_exts2_sse.c:407-410) and walker for one launch; a splice launch
    (one with site rows) walks state 3 as N.  Returns (rec, res, runs)
    tensors on ``device`` (enqueued, not synchronised).  The byte store is
    freed when this returns."""
    prm = launch.prm
    if not prm.cig:
        raise ValueError("a CIGAR launch needs cig=1 params")
    args = band_upload(launch, device)
    rec, p = band_forward(*args, prm, launch.nd, launch.ncol, cuda=cuda,
                          plain=plain)
    _, _, ql, tl, w = args[:5]
    starts = start_cells(rec, ql, tl, prm.flag, end_bonus)
    res, runs = band_walk(p, starts, ql, tl, w,
                          walk_min_intron(prm.lt, bool(launch.sites)))
    return rec, res, runs


def to_eqx(launch: BandLaunch, ezs: List[ExtzResult]) -> List[ExtzResult]:
    """Turn the launch's CIGARs into =/X ops when its flag has EQX (a host
    pass over the finished CIGARs)."""
    if launch.prm.flag & int(Flag.EQX):
        for k, ez in enumerate(ezs):
            if ez.cigar:
                ez.cigar = cigarmod.to_eqx(
                    ez.cigar, launch.query[k, :launch.qlen[k]],
                    launch.target[k, :launch.tlen[k]])
    return ezs


def unpack_band_cigars(launch: BandLaunch, rec: np.ndarray, res: np.ndarray,
                       runs: np.ndarray, mat, end_bonus: int,
                       eqx_one_piece: bool = False) -> List[ExtzResult]:
    """One launch's host records and walker output -> ExtzResults.  When
    the flag asks, two-piece CIGARs turn to EQX ops
    (``band_batch.py:833-838``), and one-piece ones too with
    ``eqx_one_piece``, as the JAX batched route converts them
    (``batch_pallas.py:499-505, 773-782``)."""
    prm = launch.prm
    ezs = unpack_cigars(rec, res, runs, mat, prm.q, prm.e, end_bonus,
                        prm.flag)
    return to_eqx(launch, ezs) if prm.two or eqx_one_piece else ezs


__all__ = ["band_walk", "band_walk_plain", "band_walk_cuda",
           "flat_walk_plain", "flat_walk_cuda", "flat_walk",
           "flat_walk_cigars",
           "band_cigar_launch", "to_eqx", "unpack_band_cigars"]
