"""Splice (exts) site profiles and costs shared by the strips and batched
exts routes.

Port of ``ksw2_tpu/ops/batch_pallas.py:splice_profiles_batch`` and of the
semi-canonical site cost of ``strips_walker.py:819``; the exts
``long_thres`` / ``long_diff`` are ``strips.long_params`` with ``e2 =
0``.  A target position ``i`` pays ``donor[i]`` when an intron
opens after it and ``acceptor[i]`` when one closes at it
(ksw2_exts2_sse.c:119-171): 0 at a canonical GT..AG (SPLICE_FOR) or
CT..AC (SPLICE_REV) site, ``semi = -noncan / 2`` (C division) at a
canonical site without its high-confidence flank under SPLICE_FLANK,
``-noncan`` elsewhere; a junction track (``junc[i] & 1`` / ``& 8`` donor,
``& 2`` / ``& 4`` acceptor; the roles swap under REV_CIGAR) adds
``junc_bonus``.

The batched route reads the rows as int8 with the spec's wraparound,
as ``splice_profiles_batch`` does.  The strips route takes the JAX
strips kernel's site CLASSES (``_splice_classes_batch``: 0, ``semi``,
``-noncan`` as int32 scalars, no junction track) and so reads them
unwrapped (``wrap=False``): the two differ only for ``noncan > 128``
(ROADMAP Queue 3).  The TPU's 2-bit class word planes are layout and
are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.flags import Flag


def c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def semi_cost(noncan: int, flag) -> int:
    """The cost of a canonical site without its flank: ``-noncan / 2``
    (C division) under SPLICE_FLANK, else 0."""
    return c_div(-int(noncan), 2) if int(flag) & int(Flag.SPLICE_FLANK) \
        else 0


def splice_profiles(target: np.ndarray, tlen, N: int, noncan: int, flag,
                    junc: Optional[np.ndarray] = None, junc_bonus: int = 0,
                    wrap: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair donor and acceptor rows, ``(B, N)`` each, of the padded
    targets ``target`` (B, Lt) with lengths ``tlen``; ``junc`` (B, Lt)
    junction bits or None.  int8 with the spec's wraparound, or int16
    unwrapped when ``wrap`` is False.  Positions at or past a pair's
    length are ``-noncan`` (0 without SPLICE_FOR / SPLICE_REV)."""
    flag = int(flag)
    B, Lt = target.shape
    if not flag & (int(Flag.SPLICE_FOR) | int(Flag.SPLICE_REV)):
        z = np.zeros((B, N), np.int8 if wrap else np.int16)
        return z, z.copy()
    noncan = int(noncan)
    fwd = bool(flag & int(Flag.SPLICE_FOR))
    rev = bool(flag & int(Flag.SPLICE_REV))
    revc = bool(flag & int(Flag.REV_CIGAR))
    semi = semi_cost(noncan, flag)
    idx = np.arange(N, dtype=np.int64)[None, :]
    tl = np.asarray(tlen, np.int64)[:, None]
    # tp[:, i + k] is t[i + k], tm[:, i + 2 - k] is t[i - k]; -1 (no
    # base) outside the target
    tp = np.full((B, N + 4), -1, np.int64)
    tp[:, :Lt] = target
    tm = np.full((B, N + 2), -1, np.int64)
    tm[:, 2:Lt + 2] = target
    t0, t1, t2, t3 = (tp[:, k:k + N] for k in range(4))
    tm1, tm2 = tm[:, 1:N + 1], tm[:, 0:N]
    if not revc:
        dcan1 = (fwd & (t1 == 2) & (t2 == 3)) | (rev & (t1 == 1) & (t2 == 3))
        dcan2 = dcan1 & ((t3 == 0) | (t3 == 2))
        acan1 = (fwd & (tm1 == 0) & (t0 == 2)) | (rev & (tm1 == 0) & (t0 == 1))
        acan2 = acan1 & ((tm2 == 1) | (tm2 == 3))
        dbit_f, dbit_r, abit_f, abit_r = 1, 8, 2, 4
    else:
        dcan1 = (fwd & (t1 == 2) & (t2 == 0)) | (rev & (t1 == 1) & (t2 == 0))
        dcan2 = dcan1 & ((t3 == 1) | (t3 == 3))
        acan1 = (fwd & (tm1 == 3) & (t0 == 2)) | (rev & (tm1 == 3) & (t0 == 1))
        acan2 = acan1 & ((tm2 == 0) | (tm2 == 2))
        dbit_f, dbit_r, abit_f, abit_r = 2, 4, 1, 8
    din = idx < tl - 4
    don = np.where(din & dcan2, 0, np.where(din & dcan1, semi, -noncan))
    ain = (idx >= 2) & (idx < tl)
    acc = np.where(ain & acan2, 0, np.where(ain & acan1, semi, -noncan))
    if junc is not None:
        jp = np.zeros((B, N + 1), np.int64)
        jp[:, :Lt] = junc
        j1, j0 = jp[:, 1:N + 1], jp[:, 0:N]
        dj = ((fwd & ((j1 & dbit_f) != 0)) | (rev & ((j1 & dbit_r) != 0))) \
            & (idx < tl - 1)
        aj = ((fwd & ((j0 & abit_f) != 0)) | (rev & ((j0 & abit_r) != 0))) \
            & (idx < tl)
        don = np.where(dj, don + junc_bonus, don)
        acc = np.where(aj, acc + junc_bonus, acc)
    if not wrap:
        return don.astype(np.int16), acc.astype(np.int16)
    w8 = lambda x: (((x + 128) & 255) - 128).astype(np.int8)  # noqa: E731
    return w8(don), w8(acc)


def pad_juncs(juncs, tlen, width: int) -> Optional[np.ndarray]:
    """``(B, width)`` uint8 junction bits of per-pair tracks (None for a
    pair without one; bits past a pair's target are dropped), or None
    when no pair has a track."""
    if juncs is None or all(j is None for j in juncs):
        return None
    out = np.zeros((len(juncs), width), np.uint8)
    for k, j in enumerate(juncs):
        if j is not None:
            n = min(len(j), int(tlen[k]))
            out[k, :n] = np.asarray(j)[:n]
    return out


__all__ = ["c_div", "semi_cost", "splice_profiles",
           "pad_juncs"]
