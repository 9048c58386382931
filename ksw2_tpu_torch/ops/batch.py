"""Batched route: the envelope and the batched forward's CUDA wrapper.

Port of ``ksw2_tpu/ops/batch_pallas.py``'s ``extz/extd_batch_records``,
``_device`` and ``_align`` functions with the forward kernels
``wavefront_batch.py:_batch_kernel_body`` (one-piece, extz) and
``wavefront_batch_extd.py:_batch_extd_kernel`` (two-piece, extd): the
anti-diagonal engines that take every bucket of targets up to 3072
(scores) or 1536 (CIGARs) which the rows, strips and band routes refuse,
such as bands that clip on short reads, APPROX_MAX/APPROX_DROP, EQX
CIGARs and two-piece scores with ``end_bonus``.

Everything around the kernel is the band route's, and the scheduler runs
this route through it with :func:`batch_forward_cuda` as the forward:

* params: ``band.make_band_params`` is ``_extd_batch_params``
  (``batch_pallas.py:853-882``: the post-swap costs, the pre-swap H seed,
  ``long_thres`` / ``long_diff`` truncated as C does, ``sc_N`` and the
  GENERIC_SC matrix);
* prep: ``band.band_prep`` pads a bucket and splits it into launches by
  the byte budget of the direction bytes;
* the plain version: ``band.band_forward_plain`` is the reference
  recurrence for any ``w`` (``w = 0`` and unbanded included) with the
  rotated byte store ``p[b, r, t - st(r)]``; the tests hold it to the JAX
  batched engines' records, bytes and CIGARs on this envelope;
* the launch glue: ``band.band_records`` and
  ``band_walker.band_cigar_launch`` with ``cuda=batch_forward_cuda``;
  the walker ``band_walker.band_walk`` (kernel ``band_walk.cu``) walks
  the same store from ``strips_walker.start_cells``, and
  ``band_walker.unpack_band_cigars`` converts one- and two-piece CIGARs
  to EQX on this route (``batch_pallas.py:499-505, 773-782``).

The degenerate-scoring guard (``batch_pallas.py:79-93, 551-552,
612-615``) is the scheduler's reset.  The forward kernel is
``csrc/batch_fwd.cu`` (one warp per pair); the first empty-band diagonal
``rlim`` it stops at is ``bands.first_empty_diag``'s closed form.  The
TPU layout (P sublane rows per pair, the query injection plane, the
packed 13-bit argmax key, ``chunk_early_exit``, the ``RMAX`` launch caps
and the jit caches) is not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import Flag
from .band import BandParams, beyond
from .strips import SMEM_MAX, _check_cuda, round_up

LT_SCORES = 3072           # the batched engines' score targets
LT_CIGARS = 1536           # ... and CIGAR targets
MAX_WARPS = 4              # pairs (warps) a block


def zdrop_ok(Lt: int, mat, qlen, tlen, zdrop: int, flag) -> bool:
    """``scheduler.py:328-335``: the TPU kernel packs an exact Z-drop's
    (H, key) into int32 at P = ceil(Lt / 128) rows a pair, so the JAX
    route takes the bucket only when the scores fit.  The CUDA kernel
    packs into 64 bits and has no such limit; the test is kept so that
    the route table stays the JAX package's."""
    if zdrop < 0 or int(flag) & int(Flag.APPROX_MAX):
        return True
    P = (Lt + 127) // 128
    KB = 1 << (5 * P * 128 + 2).bit_length()
    hmax = int(np.asarray(mat).max()) * min(int(np.max(qlen)),
                                            int(np.max(tlen)))
    return (hmax + 1) * KB + KB < (1 << 31)


def batch_ineligible_reason(Lt: int, qlen, tlen, mat, flag, zdrop: int,
                            cigar: bool, two: bool = False) -> Optional[str]:
    """Why a bucket cannot run on the batched route, or None when it can.

    The JAX route's conditions: scores ``Lt <= 3072`` and
    :func:`zdrop_ok` (``scheduler.py:265-269, 500-503``); CIGARs, and the
    two-piece SCORE_ONLY batches with ``end_bonus`` that share their path
    (``scheduler.py:614-617, 732-742``), ``Lt <= 1536`` and no EXTZ_ONLY
    (``scheduler.py:666-667``).  ``Lt`` is the bucket's target length
    key.  The reason names the engine the JAX package takes next
    (``scheduler.py:278-285, 514-521, 755-767``): the single-pair engine
    for one-piece CIGARs, the any-device route for one-piece scores, the
    single-pair two-piece engine for two-piece buckets."""
    if cigar:
        nxt = "extd" if two else "single"
        if Lt > LT_CIGARS:
            return beyond(nxt, "CIGARs (and two-piece end_bonus scores) on "
                          "targets over 1536")
        if int(flag) & int(Flag.EXTZ_ONLY):
            return beyond(nxt, "EXTZ_ONLY CIGARs and two-piece EXTZ_ONLY "
                          "scores")
        return None
    nxt = "extd" if two else "any"
    if Lt > LT_SCORES:
        return beyond(nxt, "scores on targets over 3072")
    if not zdrop_ok(Lt, mat, qlen, tlen, zdrop, flag):
        return beyond(nxt, "exact Z-drop scores outside the packed-argmax "
                      "range")
    return None


# --------------------------------------------------------------------------
# The forward: kernel E / E2


def strip_len(Lt: int) -> int:
    """Positions of a warp's state strip: the 16-rounded band and the
    score fill's overshoot of at most 15 past the last target position,
    rounded to the 32 lanes."""
    return round_up(Lt + 16, 32)


def warp_smem_bytes(Lt: int, prm: BandParams) -> int:
    """Shared memory of one warp (one pair) of ``csrc/batch_fwd.cu``: the
    int32 H row, the int8 delta planes (6 two-piece), the score bytes and
    the target, each ``strip_len(Lt)`` long."""
    return strip_len(Lt) * ((6 if prm.two else 4) + 6)


def batch_forward_cuda(qs, ts, qlen, tlen, w, table, prm: BandParams,
                       nd: int, ncol: int):
    """Launch ``csrc/batch_fwd.cu`` on the current stream; the contract of
    its plain version ``band.band_forward_plain`` (``rec`` (B, 9) int32
    and, with ``cig``, ``p`` (B, nd, ncol) uint8).  Nothing here reads the
    device; a pair whose rounded band outgrows ``ncol`` traps in the
    kernel."""
    B, Lq = qs.shape
    Lt = ts.shape[1]
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, Lt), "target", dev)
    for t, name in ((qlen, "qlen"), (tlen, "tlen"), (w, "w")):
        _check_cuda(t, torch.int32, (B,), name, dev)
    _check_cuda(table, torch.int32, (prm.m * prm.m,), "table", dev)
    if Lt > LT_SCORES:
        raise ValueError(f"targets of {Lt}: the batched kernel takes "
                         f"{LT_SCORES} or less")
    if ncol % 16:
        raise ValueError(f"ncol {ncol} is not a multiple of 16")
    per_warp = warp_smem_bytes(Lt, prm)
    warps = min(MAX_WARPS, SMEM_MAX // per_warp)
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    p = (torch.zeros((B, nd, ncol), dtype=torch.uint8, device=dev)
         if prm.cig else None)
    f = prm.flag
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), table.data_ptr(), B, Lq, Lt, prm.m, prm.q, prm.e,
            prm.q2, prm.e2, prm.qe_pre, prm.lt, prm.ld, prm.sc_mch,
            prm.sc_mis, prm.sc_N, prm.zdrop,
            int(bool(f & int(Flag.RIGHT))),
            int(bool(f & int(Flag.GENERIC_SC))),
            int(bool(f & int(Flag.APPROX_MAX))),
            int(bool(f & int(Flag.APPROX_DROP))), prm.cig, prm.two, nd,
            ncol, strip_len(Lt), warps, rec.data_ptr(),
            p.data_ptr() if p is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_fwd")
    LAUNCHES["batch_extd_fwd" if prm.two else "batch_fwd"] += 1
    return rec, p


__all__ = ["LT_SCORES", "LT_CIGARS", "zdrop_ok", "batch_ineligible_reason",
           "strip_len", "warp_smem_bytes", "batch_forward_cuda"]
