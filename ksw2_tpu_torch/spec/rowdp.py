"""Spec engines for the scalar row-DP family: ``ksw_gg``, ``ksw_extz``,
``ksw_extd``.

The port's own copy of ``ksw2_tpu/spec/rowdp.py`` (the port never imports
the JAX package).  These three algorithms have no Pallas kernel: every
backend of the JAX CLI runs this NumPy engine for them
(``ksw2_tpu/cli.py:59-71, 81-82, 89-90``), and so does the port's CLI.

These replicate the reference's row-major Green's-formulation kernels
(``ksw2_gg.c``, ``ksw2_extz.c``, ``ksw2_extd.c``) — int32 arithmetic, exact
band ``[i-w, i+w]`` per row, generic scoring matrix (the wildcard is handled
by the matrix's zero row/column, unlike the SIMD family's ``sc_N``
override).  Observable differences from the ``*2_sse`` family replicated
here: N scoring, no int8 clamps, no ``-min_sc`` guard, per-row Z-drop with
*last-j-wins* argmax ties, row-major traceback layout.

Vectorization note: each row's F (and F2) chain is sequential in the C
code; here it is computed with a prefix-max scan using the standard
domination argument (re-opening a gap from inside the same gap state never
beats extending it, since ``gapo >= 0``), which is value-exact.  For the
two-piece kernel F and F2 are mutually coupled through H; they are solved
by monotone fixpoint iteration of the two scans (converges from below to
the unique forward-chain solution, usually in <= 3 rounds).

Known reference UB (not replicated): banded ``ksw_extz``/``ksw_extd`` with
``tlen > qlen + w + 1`` writes ``eh[st]`` past the row buffer; such
configurations are excluded from the parity corpus and clamped here.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from .backtrack import backtrack
from .common import apply_zdrop

_I64 = np.int64


def _prefix_gap_scan(
    source: np.ndarray, init: int, gapoe: int, gape: int, st: int
) -> np.ndarray:
    """F-chain over one row: ``F[st] = init``,
    ``F[j+1] = max(F[j] - gape, source[j] - gapoe - gape)``.

    ``source`` is indexed from ``st`` (source[0] == column st).  Returns F
    aligned the same way.
    """
    n = len(source)
    idx = np.arange(st, st + n, dtype=_I64)
    # F[j] = max(f_init - gape*(j-st), max_{k<j} source[k] - gapoe - gape*(j-1-k))
    c = source - (gapoe - gape) + gape * idx  # candidate k contributes c[k] - gape*j
    run = np.empty(n, _I64)
    run[0] = init + gape * st
    if n > 1:
        np.maximum.accumulate(c[:-1], out=c[:-1])
        run[1:] = np.maximum(run[0], c[:-1])
    return run - gape * idx


def gg(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    gapo: int,
    gape: int,
    w: int = -1,
    with_cigar: bool = True,
) -> Tuple[int, List[int]]:
    """Banded global alignment (spec of ``ksw_gg``)."""
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    gapo, gape = int(gapo), int(gape)
    gapoe = gapo + gape
    if w < 0:
        w = max(tlen, qlen)
    n_col = min(qlen, 2 * w + 1)

    eh_h = np.zeros(qlen + 1, _I64)
    eh_e = np.zeros(qlen + 1, _I64)
    eh_h[0], eh_e[0] = 0, -gapoe - gapoe
    jfill = np.arange(1, min(qlen, w) + 1, dtype=_I64)
    eh_h[jfill] = -(gapoe + gape * (jfill - 1))
    eh_e[jfill] = -(gapoe + gapoe + gape * jfill)
    eh_h[min(qlen, w) + 1 :] = NEG_INF
    eh_e[min(qlen, w) + 1 :] = NEG_INF

    if with_cigar:
        p = np.zeros((tlen, n_col), np.uint8)
        off = np.zeros(tlen, np.int32)
    qenc = np.asarray(query, dtype=np.int64)

    for i in range(tlen):
        st = max(0, i - w)
        en = min(i + w + 1, qlen)  # exclusive
        h1 = NEG_INF if st > 0 else -(gapoe + gape * i)
        f_init = NEG_INF if st > 0 else -(gapoe + gapoe + gape * i)
        if with_cigar:
            off[i] = st
        if st < en:
            qp = mat[int(target[i])][qenc[st:en]]
            hm = eh_h[st:en] + qp
            E = eh_e[st:en].copy()
            base = np.maximum(hm, E)
            F = _prefix_gap_scan(base, f_init, gapoe, gape, st)
            H = np.maximum(base, F)
            if with_cigar:
                d = np.where(hm >= E, np.uint8(0), np.uint8(1))
                d = np.where(np.maximum(hm, E) >= F, d, np.uint8(2))
                ha = H - gapoe
                d |= np.where(E - gape > ha, np.uint8(0x08), np.uint8(0))
                d |= np.where(F - gape > ha, np.uint8(0x10), np.uint8(0))
                p[i, : en - st] = d
            eh_e[st:en] = np.maximum(E - gape, H - gapoe)
            eh_h[st] = h1
            eh_h[st + 1 : en + 1] = H
            eh_h[en] = H[-1]
            eh_e[en] = NEG_INF
        else:
            eh_h[en] = h1
            eh_e[en] = NEG_INF

    score = int(eh_h[qlen])
    cig: List[int] = []
    if with_cigar:
        cig = backtrack(p, off, None, n_col, tlen - 1, qlen - 1, is_rot=False)
    return score, cig


def extz(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    gapo: int,
    gape: int,
    w: int = -1,
    zdrop: int = -1,
    flag: Flag | int = Flag.NONE,
) -> ExtzResult:
    """Extension alignment, one-piece affine (spec of ``ksw_extz``)."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    gapo, gape = int(gapo), int(gape)
    gapoe = gapo + gape
    if w < 0:
        w = max(tlen, qlen)
    n_col = min(qlen, 2 * w + 1)
    with_cigar = not (flag & Flag.SCORE_ONLY)
    right = bool(flag & Flag.RIGHT)

    eh_h = np.zeros(qlen + 1, _I64)
    eh_e = np.zeros(qlen + 1, _I64)
    eh_h[0], eh_e[0] = 0, -gapoe - gapoe
    jtop = min(qlen, w)
    jfill = np.arange(1, jtop + 1, dtype=_I64)
    eh_h[jfill] = -(gapoe + gape * (jfill - 1))
    eh_e[jfill] = -(gapoe + gapoe + gape * jfill)
    eh_h[jtop + 1 :] = NEG_INF
    eh_e[jtop + 1 :] = NEG_INF

    if with_cigar:
        p = np.zeros((tlen, n_col), np.uint8)
        off = np.zeros(tlen, np.int32)
    qenc = np.asarray(query, dtype=np.int64)
    max_j = 0

    for i in range(tlen):
        st = max(0, i - w)
        en = min(qlen - 1, i + w)  # inclusive
        h1 = NEG_INF if st > 0 else -(gapoe + gape * i)
        f_init = NEG_INF if st > 0 else -(gapoe + gapoe + gape * i)
        rmax = NEG_INF
        if with_cigar:
            off[i] = st
        if st <= en:
            qp = mat[int(target[i])][qenc[st : en + 1]]
            hm = eh_h[st : en + 1] + qp
            E = eh_e[st : en + 1].copy()
            base = np.maximum(hm, E)
            F = _prefix_gap_scan(base, f_init, gapoe, gape, st)
            H = np.maximum(base, F)
            if with_cigar:
                if not right:
                    d = np.where(hm >= E, np.uint8(0), np.uint8(1))
                    d = np.where(np.maximum(hm, E) >= F, d, np.uint8(2))
                else:
                    d = np.where(hm > E, np.uint8(0), np.uint8(1))
                    d = np.where(np.maximum(hm, E) > F, d, np.uint8(2))
                ha = H - gapoe
                ecand = E - gape
                fcand = F - gape
                if not right:
                    d |= np.where(ecand > ha, np.uint8(0x08), np.uint8(0))
                    d |= np.where(fcand > ha, np.uint8(0x10), np.uint8(0))
                else:
                    d |= np.where(ecand >= ha, np.uint8(0x08), np.uint8(0))
                    d |= np.where(fcand >= ha, np.uint8(0x10), np.uint8(0))
                p[i, : en - st + 1] = d
            # Row argmax tie rule is variant-dependent in the reference:
            # score-only/left use `max > h` (last j wins, ksw2_extz.c:53-54),
            # the right-align loop uses `max >= h` (first j wins, :103-104).
            rmax = int(H.max())
            if right and with_cigar:
                max_j = st + int(np.argmax(H))
            else:
                max_j = st + (len(H) - 1 - int(np.argmax(H[::-1])))
            eh_e[st : en + 1] = np.maximum(E - gape, H - gapoe)
            eh_h[st] = h1
            eh_h[st + 1 : en + 2] = H
            eh_e[en + 1] = NEG_INF
        else:
            # empty banded row: the reference still writes eh[st] (UB when
            # st > qlen -- excluded from parity; clamped here)
            j = min(st, qlen)
            eh_h[j] = h1
            eh_e[j] = NEG_INF
        if en == qlen - 1 and int(eh_h[qlen]) > ez.mqe:
            ez.mqe, ez.mqe_t = int(eh_h[qlen]), i
        if i == tlen - 1:
            ez.mte, ez.mte_q = rmax, max_j
        if apply_zdrop(ez, False, rmax, i, max_j, zdrop, gape):
            break
        if i == tlen - 1 and en == qlen - 1:
            ez.score = int(eh_h[qlen])

    if with_cigar:
        rev = bool(flag & Flag.REV_CIGAR)
        if not ez.zdropped and not (flag & Flag.EXTZ_ONLY):
            ez.cigar = backtrack(p, off, None, n_col, tlen - 1, qlen - 1,
                                 is_rot=False, is_rev=rev)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = backtrack(p, off, None, n_col, ez.max_t, ez.max_q,
                                 is_rot=False, is_rev=rev)
    return ez


def extd(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    gapo: int,
    gape: int,
    gapo2: int,
    gape2: int,
    w: int = -1,
    zdrop: int = -1,
    flag: Flag | int = Flag.NONE,
) -> ExtzResult:
    """Extension alignment, two-piece affine (spec of ``ksw_extd``)."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    gapo, gape, gapo2, gape2 = int(gapo), int(gape), int(gapo2), int(gape2)
    gapoe, gapoe2 = gapo + gape, gapo2 + gape2
    if w < 0:
        w = max(tlen, qlen)
    n_col = min(qlen, 2 * w + 1)
    with_cigar = not (flag & Flag.SCORE_ONLY)
    right = bool(flag & Flag.RIGHT)

    eh_h = np.zeros(qlen + 1, _I64)
    eh_e = np.zeros(qlen + 1, _I64)
    eh_e2 = np.zeros(qlen + 1, _I64)
    eh_h[0] = 0
    eh_e[0] = -gapoe - gapoe
    eh_e2[0] = -gapoe2 - gapoe2
    jtop = min(qlen, w)
    jf = np.arange(1, jtop + 1, dtype=_I64)
    eh_h[jf] = np.maximum(-(gapo + gape * jf), -(gapo2 + gape2 * jf))
    tmpf = np.maximum(-(gapoe + gape * jf), -(gapoe2 + gape2 * jf))
    eh_e[jf] = tmpf - gapoe
    eh_e2[jf] = tmpf - gapoe2
    eh_h[jtop + 1 :] = NEG_INF
    eh_e[jtop + 1 :] = NEG_INF
    eh_e2[jtop + 1 :] = NEG_INF

    if with_cigar:
        p = np.zeros((tlen, n_col), np.uint8)
        off = np.zeros(tlen, np.int32)
    qenc = np.asarray(query, dtype=np.int64)
    max_j = 0

    for i in range(tlen):
        st = max(0, i - w)
        en = min(qlen - 1, i + w)
        tmp = max(-(gapoe + gape * i), -(gapoe2 + gape2 * i))
        h1 = NEG_INF if st > 0 else tmp
        f_init = NEG_INF if st > 0 else tmp - gapoe
        f2_init = NEG_INF if st > 0 else tmp - gapoe2
        rmax = NEG_INF
        if with_cigar:
            off[i] = st
        if st <= en:
            qp = mat[int(target[i])][qenc[st : en + 1]]
            hm = eh_h[st : en + 1] + qp
            E = eh_e[st : en + 1].copy()
            E2 = eh_e2[st : en + 1].copy()
            base = np.maximum(np.maximum(hm, E), E2)
            # coupled F/F2 chains: monotone fixpoint of the two scans
            F2 = np.full_like(base, NEG_INF)
            F = _prefix_gap_scan(base, f_init, gapoe, gape, st)
            while True:
                F2n = _prefix_gap_scan(np.maximum(base, F), f2_init, gapoe2, gape2, st)
                Fn = _prefix_gap_scan(np.maximum(base, F2n), f_init, gapoe, gape, st)
                if np.array_equal(F2n, F2) and np.array_equal(Fn, F):
                    break
                F, F2 = Fn, F2n
            H = np.maximum(np.maximum(base, F), F2)
            if with_cigar:
                if not right:
                    d = np.where(hm >= E, np.uint8(0), np.uint8(1))
                    h = np.maximum(hm, E)
                    d = np.where(h >= F, d, np.uint8(2)); h = np.maximum(h, F)
                    d = np.where(h >= E2, d, np.uint8(3)); h = np.maximum(h, E2)
                    d = np.where(h >= F2, d, np.uint8(4))
                else:
                    d = np.where(hm > E, np.uint8(0), np.uint8(1))
                    h = np.maximum(hm, E)
                    d = np.where(h > F, d, np.uint8(2)); h = np.maximum(h, F)
                    d = np.where(h > E2, d, np.uint8(3)); h = np.maximum(h, E2)
                    d = np.where(h > F2, d, np.uint8(4))
                ha = H - gapoe
                ha2 = H - gapoe2
                if not right:
                    d |= np.where(E - gape > ha, np.uint8(0x08), np.uint8(0))
                    d |= np.where(F - gape > ha, np.uint8(0x10), np.uint8(0))
                    d |= np.where(E2 - gape2 > ha2, np.uint8(0x20), np.uint8(0))
                    d |= np.where(F2 - gape2 > ha2, np.uint8(0x40), np.uint8(0))
                else:
                    d |= np.where(E - gape >= ha, np.uint8(0x08), np.uint8(0))
                    d |= np.where(F - gape >= ha, np.uint8(0x10), np.uint8(0))
                    d |= np.where(E2 - gape2 >= ha2, np.uint8(0x20), np.uint8(0))
                    d |= np.where(F2 - gape2 >= ha2, np.uint8(0x40), np.uint8(0))
                p[i, : en - st + 1] = d
            rmax = int(H.max())
            max_j = st + (len(H) - 1 - int(np.argmax(H[::-1])))
            eh_e[st : en + 1] = np.maximum(E - gape, H - gapoe)
            eh_e2[st : en + 1] = np.maximum(E2 - gape2, H - gapoe2)
            eh_h[st] = h1
            eh_h[st + 1 : en + 2] = H
            eh_e[en + 1] = NEG_INF  # e2 is NOT reset here (ksw2_extd.c:156)
        else:
            j = min(st, qlen)
            eh_h[j] = h1
            eh_e[j] = NEG_INF
        if en == qlen - 1 and int(eh_h[qlen]) > ez.mqe:
            ez.mqe, ez.mqe_t = int(eh_h[qlen]), i
        if i == tlen - 1:
            ez.mte, ez.mte_q = rmax, max_j
        if apply_zdrop(ez, False, rmax, i, max_j, zdrop, gape2):
            break
        if i == tlen - 1 and en == qlen - 1:
            ez.score = int(eh_h[qlen])

    if with_cigar:
        rev = bool(flag & Flag.REV_CIGAR)
        if not ez.zdropped and not (flag & Flag.EXTZ_ONLY):
            ez.cigar = backtrack(p, off, None, n_col, tlen - 1, qlen - 1,
                                 is_rot=False, is_rev=rev)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = backtrack(p, off, None, n_col, ez.max_t, ez.max_q,
                                 is_rot=False, is_rev=rev)
    return ez


__all__ = ["gg", "extz", "extd"]
