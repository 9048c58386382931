"""Spec engine of ``ksw_gg2``: global alignment, scalar diagonal form.

The port's own copy of ``ksw2_tpu/spec/diagdiff.py:gg2`` (with the helpers
it uses).  ``ksw_gg2`` has no Pallas kernel: every backend of the JAX CLI
runs this NumPy engine for it (``ksw2_tpu/cli.py:66-71``), and so does the
port's CLI.  It replicates the reference bit for bit: the difference
state u, v, x, y in wrapping int8 per anti-diagonal over the exact band,
the O(1) H0 walk to the corner, and the direction bytes walked by
:func:`~ksw2_tpu_torch.spec.backtrack.backtrack` with ``is_rot``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .backtrack import backtrack
from .common import sra1

_I8 = np.int8
_U8 = np.uint8


def _i8(v: int) -> np.int8:
    """Python int -> wrapping int8 (C truncating conversion)."""
    return np.int8((int(v) + 128) % 256 - 128)


def _bounds(r: int, qlen: int, tlen: int, wl: int, wr: int) -> tuple[int, int]:
    """Band bounds on diagonal r in rotated coords (ksw2_extz2_sse.c:107-110)."""
    st = max(0, r - qlen + 1, sra1(r - wr + 1))
    en = min(tlen - 1, r, sra1(r + wl))
    return st, en


def _shift1(arr: np.ndarray, first: np.int8) -> np.ndarray:
    """``out[k] = arr[k-1]`` with ``out[0] = first`` (the SSE lane shift)."""
    out = np.empty_like(arr)
    out[0] = first
    out[1:] = arr[:-1]
    return out


def gg2(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    w: int = -1,
    with_cigar: bool = True,
) -> tuple[int, List[int], Optional[tuple]]:
    """Global alignment, scalar diagonal form (spec of ``ksw_gg2``)."""
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, dtype=_I8).reshape(-1)
    q, e = int(q), int(e)
    qe = q + e
    if w < 0:
        w = max(tlen, qlen)
    n_col = min(w + 1, tlen)

    u = np.zeros(tlen + 1, _I8)
    v = np.zeros(tlen + 1, _I8)
    x = np.zeros(tlen + 1, _I8)
    y = np.zeros(tlen + 1, _I8)
    s = np.zeros(tlen, _I8)
    qr = np.asarray(query[::-1], dtype=_U8)
    tgt = np.asarray(target, dtype=_U8)
    n_diag = qlen + tlen - 1
    if with_cigar:
        p = np.zeros((qlen + tlen, n_col), _U8)
        off = np.zeros(qlen + tlen, np.int32)
    else:
        p = off = None

    H0 = 0
    last_H0_t = 0
    for r in range(n_diag):
        st, en = _bounds(r, qlen, tlen, w, w)
        if st != 0:
            if r > st + st + w - 1 or st - 1 > tlen:
                # second clause: the reference reads x[st-1] out of bounds for
                # pathological bands; the value is unused (empty core loop)
                x1 = v1 = _i8(0)
            else:
                x1, v1 = x[st - 1], v[st - 1]
        else:
            x1, v1 = _i8(0), _i8(q if r else 0)
        if en != r:
            if r < en + en - w - 1:
                y[en] = 0
                u[en] = 0
        else:
            y[r] = 0
            u[r] = _i8(q if r else 0)
        if with_cigar:
            off[r] = st
        if st > en:  # empty band: core loop does not run (no break in ksw_gg2)
            if r > 0:
                if st <= last_H0_t <= en:
                    H0 += int(v[last_H0_t]) - qe
                else:
                    last_H0_t += 1
                    # beyond the array the reference reads heap garbage
                    # (allocator-dependent, verified undefined); read 0 here
                    H0 += (int(u[last_H0_t]) if last_H0_t <= tlen else 0) - qe
            continue
        offq = qlen - 1 - r
        ti = tgt[st : en + 1].astype(np.int32)
        qi = qr[st + offq : en + 1 + offq].astype(np.int32)
        s[st : en + 1] = mat[ti * m + qi]

        sl = slice(st, en + 1)
        zz = s[sl] + _i8(2 * qe)
        xt1 = _shift1(x[sl], x1)
        vt1 = _shift1(v[sl], v1)
        ut = u[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        d = np.where(a > zz, np.uint8(1), np.uint8(0))
        z = np.maximum(zz, a)
        d = np.where(b > z, np.uint8(2), d)
        z = np.maximum(z, b)
        u[sl] = z - vt1
        v[sl] = z - ut
        z2 = z - _i8(q)
        a = a - z2
        b = b - z2
        d |= np.where(a > 0, np.uint8(0x08), np.uint8(0))
        x[sl] = np.where(a > 0, a, _i8(0))
        d |= np.where(b > 0, np.uint8(0x10), np.uint8(0))
        y[sl] = np.where(b > 0, b, _i8(0))
        if with_cigar:
            p[r, : en - st + 1] = d

        if r > 0:
            if st <= last_H0_t <= en:
                H0 += int(v[last_H0_t]) - qe
            else:
                last_H0_t += 1
                H0 += int(u[last_H0_t]) - qe
        else:
            H0 = int(v[0]) - 2 * qe
            last_H0_t = 0

    cig: List[int] = []
    trace = None
    if with_cigar:
        cig = backtrack(p, off, None, n_col, tlen - 1, qlen - 1, is_rot=True)
        trace = (p, off, None, n_col)
    return H0, cig, trace


__all__ = ["gg2"]
