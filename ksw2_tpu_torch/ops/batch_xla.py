"""The any-device score route: kernel 12 in score form over a bucket.

Port of ``ksw2_tpu/ops/batch_xla.py:extz_batch_scores``, the JAX
scheduler's default engine for the one-piece score buckets that the rows,
strips, band and batched routes refuse (``scheduler.py:202, 278-285``):
targets over 3072 and exact Z-drop outside the packed-argmax range.  It is
not a Pallas kernel there (an XLA scan over the batch, one diagonal a
step); here it is the single-pair forward (``ops/extz_fwd.py``, kernel
12) in score form over all the bucket's pairs in one launch (more where
its buffers exceed ``ops.strips.LAUNCH_BYTES``), on CUDA tensors, and its
plain version on CPU tensors.  The 9 fields do not
depend on the route.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..core.flags import Flag
from .extz import ExtzLaunch, extz_prep, extz_records
from .records import FIELD_ORDER


class BatchSpec(NamedTuple):
    """A bucket's scalar configuration (``batch_xla.BatchSpec``); SCORE_ONLY
    is implied, APPROX_MAX / APPROX_DROP are honoured."""
    Lq: int
    Lt: int
    m: int
    sc_mch: int
    sc_mis: int
    sc_N: int
    q: int
    e: int
    zdrop: int
    flag: int


def any_device_prep(query, target, qlen, tlen, w, m, mat, q, e, zdrop,
                    flag) -> List[ExtzLaunch]:
    """A bucket's score launches (``w`` resolved, >= 0)."""
    return extz_prep(query, target, qlen, tlen, w, m, mat, q, e, zdrop,
                     int(flag) | int(Flag.SCORE_ONLY), cig=False)


def extz_batch_scores(spec: BatchSpec, query, target, qlen, tlen, w,
                      mat=None, device="cuda") -> Dict[str, np.ndarray]:
    """Batched one-piece extension scores of padded ``(B, Lq)`` /
    ``(B, Lt)`` sequences with per-pair ``qlen``, ``tlen`` and resolved
    ``w``: a dict of ``(B,)`` int32 fields as ``ksw_extz_t`` names them.
    ``mat`` is the m*m matrix under GENERIC_SC (else the simple one the
    spec's match / mismatch / wildcard scores give)."""
    qlen, tlen, w = (np.asarray(a, np.int32) for a in (qlen, tlen, w))
    if mat is None:
        mat = np.full((spec.m, spec.m), spec.sc_mis, np.int8)
        np.fill_diagonal(mat, spec.sc_mch)
        mat[-1, :] = mat[:, -1] = 0 if spec.sc_N == -spec.e else spec.sc_N
    qs = [np.asarray(query)[k, :qlen[k]] for k in range(len(qlen))]
    ts = [np.asarray(target)[k, :tlen[k]] for k in range(len(tlen))]
    launches = any_device_prep(qs, ts, qlen, tlen, w, spec.m, mat, spec.q,
                               spec.e, spec.zdrop, spec.flag)
    rec = torch.cat([extz_records(ln, torch.device(device))
                     for ln in launches]).cpu().numpy()
    return {k: rec[:, i].copy() for i, k in enumerate(FIELD_ORDER)}


__all__ = ["BatchSpec", "any_device_prep", "extz_batch_scores"]
