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
tensors and :func:`band_walk_plain` for CPU tensors.
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
from .strips_walker import (start_cells, state_op, unpack_cigars,
                            walk_min_intron)


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
        i, j = int(st[b, 0]), int(st[b, 1])
        _, _, sts, ens = band_bounds_rounded(int(ql[b] + tl[b]) - 1,
                                             int(ql[b]), int(tl[b]),
                                             int(wl[b]))
        state = k = n = 0
        op = -1
        while i >= 0 and j >= 0:
            r = i + j
            force = 2 if i < sts[r] else -1
            if i > ens[r]:
                force = 1
            tmp = int(d[b, r, i - sts[r]]) if force < 0 else 0
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
                    runs[b, k] = (n << 4) | op
                    k += 1
                op, n = o, 1
        if n > 0:
            runs[b, k] = (n << 4) | op
            k += 1
        res[b] = (i, j, k)
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
           "band_cigar_launch", "to_eqx", "unpack_band_cigars"]
