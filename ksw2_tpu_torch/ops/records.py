"""The (B, NFIELDS) int32 score-record contract shared by every route.

Port of ``ksw2_tpu/ops/batch_pallas.py:75-94``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.flags import NEG_INF

# column order of the (B, NFIELDS) score records
FIELD_ORDER = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q",
               "score", "zdropped")
NFIELDS = len(FIELD_ORDER)


def degenerate(mat, q: int, e: int) -> bool:
    """The reference guard (ksw2_extz2_sse.c:78-82): mismatches are
    invisible in the delta range (``-min_sc > 2 (q + e)``), and every pair
    gets a reset ez."""
    return -int(np.asarray(mat).reshape(-1)[1:].min()) > 2 * (q + e)


def unpack_records(res: np.ndarray, min_sc: int, q: int, e: int
                   ) -> Dict[str, np.ndarray]:
    """(B, NFIELDS) int32 records -> per-pair ez field dict.

    Applies the reference guard (ksw2_extz2_sse.c:78-82): when mismatches
    are invisible in the delta range every pair gets a reset ez.
    """
    out = {k: res[:, i].copy() for i, k in enumerate(FIELD_ORDER)}
    if -min_sc > 2 * (q + e):
        for k in out:
            out[k][:] = 0 if k in ("max", "zdropped") else (
                -1 if k.endswith(("_t", "_q")) else NEG_INF)
        out["max_t"][:] = -1
        out["max_q"][:] = -1
    return out


__all__ = ["FIELD_ORDER", "NFIELDS", "degenerate", "unpack_records"]
