"""Band bookkeeping of the reference's rotated band.

A copy of the JAX-free ``ksw2_tpu/ops/bands.py:12-44`` (``band_bounds``,
``band_bounds_rounded``, ``n_col_bytes``) and of the closed-form first
empty diagonal of ``ksw2_tpu/ops/band_batch.py:76-82``.  Every quantity
is a function of (r, qlen, tlen, w) and follows ksw2_extz2_sse.c:107-116,
the 16-lane rounding included: the rounding is observable through the
band-edge reads and the direction bytes.
"""
from __future__ import annotations

import numpy as np


def band_bounds(n_diag: int, qlen: int, tlen: int, w: int):
    """True (unrounded) band [st0, en0] per diagonal."""
    r = np.arange(n_diag, dtype=np.int64)
    st0 = np.maximum(0, np.maximum(r - qlen + 1, (r - w + 1) >> 1))
    en0 = np.minimum(tlen - 1, np.minimum(r, (r + w) >> 1))
    return st0, en0


def band_bounds_rounded(n_diag: int, qlen: int, tlen: int, w: int):
    """(st0, en0, st, en): true and 16-rounded band bounds per diagonal."""
    st0, en0 = band_bounds(n_diag, qlen, tlen, w)
    st = st0 // 16 * 16
    en = (en0 + 16) // 16 * 16 - 1
    return st0, en0, st, en


def n_col_bytes(qlen: int, tlen: int, w: int) -> int:
    """The reference's stored row width in bytes (``n_col_ * 16``)."""
    n_col = min(qlen, tlen)
    n_col = (min(n_col, w + 1) + 15) // 16 + 1
    return n_col * 16


def first_empty_diag(qlen, tlen, w):
    """The first diagonal whose band is empty (``qlen + tlen - 1`` when
    none is): the forward's last diagonal is the one before it.  Works
    on ints and on numpy arrays."""
    ndb = np.asarray(qlen, np.int64) + np.asarray(tlen, np.int64) - 1
    w = np.asarray(w, np.int64)
    return np.minimum(np.minimum(ndb, 2 * np.asarray(qlen, np.int64) + w - 1),
                      np.minimum(2 * np.asarray(tlen, np.int64) + w - 1,
                                 np.where(w == 0, 1, ndb)))


def resolve_bands(pairs, w):
    """Bands ``w`` (one a (query, target) pair, or one for all; < 0
    unbanded) resolved as the linear-gap and global engines resolve
    them: ``max(qlen, tlen)``."""
    return [int(wk) if int(wk) >= 0 else max(len(q), len(t))
            for (q, t), wk in zip(pairs, np.broadcast_to(w, (len(pairs),)))]


__all__ = ["band_bounds", "band_bounds_rounded", "n_col_bytes",
           "first_empty_diag", "resolve_bands"]
