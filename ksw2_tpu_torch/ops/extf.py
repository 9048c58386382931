"""The single-pair linear-gap extension: kernel 15's wrapper and
``extf2_device``.

Port of ``ksw2_tpu/ops/extf.py:extf2_device`` with the kernel
``wavefront_extf.py:_extf_kernel_body``: ``csrc/batch_extf_fwd.cu`` in
its single-pair form (one block a pair, the strips in global scratch;
counted as ``extf_fwd``), whose plain version is kernel 7's,
``ops.batch_extf.extf_forward_plain``.  The host side follows
``extf2_device``: the reset ez for an empty sequence, ``mis``
canonicalised to <= 0 and ``w < 0`` as ``max(qlen, tlen)``.  Score only
(``ksw2_extf2_sse.c:12-15``).  A launch takes any number of pairs, one
block each: :func:`extf_pairs` runs the pairs the batched route refuses in
one launch.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.result import ExtzResult
from .bands import resolve_bands
from .batch import strip_len
from .batch_extf import _check_args, canonical_mis, extf_forward, pack_pairs

MAX_BLOCK_WARPS = 32


def block_warps(band: int) -> int:
    """Warps of a single-pair block for a band of ``band`` positions: one
    per 256, 1 to 32."""
    return max(1, min(MAX_BLOCK_WARPS, -(-int(band) // 256)))


def widest_band(qlen, tlen, w) -> int:
    """The widest 16-rounded band of a launch's pairs (positions)."""
    ql = np.asarray(qlen, np.int64)
    tl = np.asarray(tlen, np.int64)
    wl = np.asarray(w, np.int64)
    return int(np.max(np.minimum(np.minimum(ql, tl), wl + 1) + 32,
                      initial=32))


def extf_single_forward_cuda(qs, ts, qlen, tlen, w, mch: int, mis: int,
                             e: int, xdrop: int):
    """Launch kernel 15 (``csrc/batch_extf_fwd.cu``, one block a pair) on
    the current stream; the contract of
    :func:`ops.batch_extf.extf_forward_plain` for targets of any length."""
    B, Lq, Lt, dev = _check_args(qs, ts, qlen, tlen, w)
    TP = strip_len(Lt)
    warps = block_warps(widest_band(qlen.cpu(), tlen.cpu(), w.cpu()))
    scratch = torch.zeros((B, 3 * TP), dtype=torch.int8, device=dev)
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.ksw2t_extf_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), B, Lq, Lt, int(mch), int(mis), int(e), int(xdrop),
            TP, warps, scratch.data_ptr(), rec.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "extf_fwd")
    LAUNCHES["extf_fwd"] += 1
    return rec


def _ez(rec_row) -> ExtzResult:
    ez = ExtzResult()
    ez.reset()
    ez.max, ez.max_t, ez.max_q = (int(rec_row[0]), int(rec_row[1]),
                                  int(rec_row[2]))
    ez.score = int(rec_row[7])
    ez.zdropped = bool(rec_row[8])
    return ez


def extf_pairs(pairs: Sequence, mch: int, mis: int, e: int, w,
               xdrop: int = -1, device="cuda") -> List[ExtzResult]:
    """extf2 of every (query, target) pair in one launch of kernel 15 (its
    plain version on the CPU); ``w`` a band per pair, < 0 unbanded."""
    if not pairs:
        return []
    args = pack_pairs(pairs, resolve_bands(pairs, w), torch.device(device))
    rec = extf_forward(*args, int(mch), canonical_mis(mis), int(e),
                       int(xdrop),
                       cuda=extf_single_forward_cuda).cpu().numpy()
    return [_ez(rec[k]) for k in range(len(pairs))]


def extf2_device(query: np.ndarray, target: np.ndarray, mch: int, mis: int,
                 e: int, w: int = -1, xdrop: int = -1,
                 device="cuda") -> ExtzResult:
    """Run the extf forward for one pair; returns the ez record (score,
    max, max_t, max_q, zdropped)."""
    if len(query) <= 0 or len(target) <= 0:
        ez = ExtzResult()
        ez.reset()
        return ez
    return extf_pairs([(np.asarray(query), np.asarray(target))], mch, mis,
                      e, [w], xdrop, device)[0]


__all__ = ["block_warps", "widest_band", "extf_single_forward_cuda",
           "extf_pairs", "extf2_device"]
