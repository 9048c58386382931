"""The single-pair banded global alignment: kernel 16's wrapper and
``gg2_device``.

Port of ``ksw2_tpu/ops/gg2.py:gg2_device`` with the kernel
``wavefront_gg2.py:_gg2_kernel_body``: ``csrc/gg2_fwd.cu`` in its
single-pair form (one block a pair, the reference's contiguous u, v, x,
y, s block in global scratch, so the H0 walk's overrun when ``qlen > tlen
+ w`` reads the reference's bytes; counted as ``gg2_fwd``), whose plain
version is kernel 8's, ``ops.batch_gg2.gg2_forward_plain`` with
``overrun``.  It writes the same flat store as kernel 8, walked on the
card by ``band_walk.cu``'s flat form from the corner, so the JAX
host wrapper's escape and replay (``gg2.py:114-138``) and kernel 17's
escape flag are not needed.  ``w < 0`` is ``max(qlen, tlen)``.  A launch
takes any number of pairs, one block each (:func:`gg2_pairs`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from .bands import resolve_bands
from .batch_gg2 import _gg2_check, gg2_run
from .extf import block_warps, widest_band


def gg2_single_forward_cuda(qs, ts, qlen, tlen, w, table, m: int, q: int,
                            e: int, pbase, total: int):
    """Launch kernel 16 (``csrc/gg2_fwd.cu``, one block a pair) on the
    current stream; the contract of ``batch_gg2.gg2_forward_plain`` with
    ``overrun`` True, for targets of any length."""
    B, Lq, Lt, dev = _gg2_check(qs, ts, qlen, tlen, w, table, m, pbase)
    blk = 5 * ((Lt + 15) // 16 * 16) + 16
    warps = block_warps(widest_band(qlen.cpu(), tlen.cpu(), w.cpu()))
    scratch = torch.zeros((B, blk), dtype=torch.int8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    p = torch.zeros(max(total, 1), dtype=torch.uint8, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.ksw2t_gg2_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), table.data_ptr(), pbase.data_ptr(), B, Lq, Lt,
            int(m), int(q), int(e), blk, warps, scratch.data_ptr(),
            score.data_ptr(), p.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gg2_fwd")
    LAUNCHES["gg2_fwd"] += 1
    return score, p[:total]


def gg2_pairs(pairs: Sequence, m: int, mat, q: int, e: int, w,
              device="cuda") -> List[Tuple[int, list]]:
    """gg2_sse of every (query, target) pair on kernel 16 and the flat
    walk (their plain versions on the CPU), in as few launches as the
    byte budget allows; ``w`` a band per pair, < 0 unbanded.  Returns
    (score, cigar) a pair."""
    if not pairs:
        return []
    return gg2_run(list(pairs), m, mat, q, e, resolve_bands(pairs, w), True,
                   device)


def gg2_device(query: np.ndarray, target: np.ndarray, m: int, mat, q: int,
               e: int, w: int = -1, device="cuda"
               ) -> Tuple[int, List[int], Optional[object]]:
    """Run the gg2 forward and walk for one pair; returns (score, cigar,
    None), the JAX function's triple without its host ``Trace``."""
    score, cig = gg2_pairs([(np.asarray(query), np.asarray(target))], m,
                           mat, q, e, [w], device)[0]
    return score, cig, None


__all__ = ["gg2_single_forward_cuda", "gg2_pairs", "gg2_device"]
