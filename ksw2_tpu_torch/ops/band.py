"""Band route: host prep, the band forward and its plain version.

Port of ``ksw2_tpu/ops/band_batch.py``'s records, device and align
functions with the forward kernels ``wavefront_band.py:_band_kernel_body``
(one-piece, extz) and ``wavefront_band_extd.py:_band_extd_kernel_body``
(two-piece, extd).  The band forward is the reference's anti-diagonal
difference recurrence (Suzuki-Kasahara ``u, v, x, y`` deltas in wrapping
int8; ``x2, y2`` two-piece) over the rotated band of each pair, as
``spec/diagdiff.py:extz2`` and ``extd2`` give it with ``w``:

* cells over the 16-rounded [st, en] of every diagonal, the stale edge
  byte at ``st - 1`` and the stale score bytes included
  (ksw2_extz2_sse.c:107-158);
* the exact per-diagonal max with the SSE 4-lane tie order and
  ``ksw_apply_zdrop``, or the O(1) H0 walk under APPROX_MAX;
* mqe / mte capture with strict ``>`` (``mte_q`` keeps the reference's
  ``r - en`` rounding quirk);
* with ``cig``, the reference's direction bytes in its rotated store
  ``p[b, r, t - st(r)]`` with ``n_col_bytes`` columns, the store that
  ``ksw_backtrack`` reads with ``is_rot = 1``.

It emits the 9-field records of ``ops/records.py``.  The forward has two
implementations: ``csrc/band_fwd.cu`` for CUDA tensors (a block a pair,
whose warps take the pair's tiles in turn, and a replay warp in the same
block that turns the per-diagonal keys into the records;
:func:`band_layout`) and :func:`band_forward_plain` for CPU tensors,
which computes the records diagonal by diagonal.  The TPU
layout (the drifting 16-aligned origin and its jump shifts, the host-built
injection planes, P sublane rows per pair, the packed 13-bit argmax key,
the chunked early exit and the ``RMAX`` launch cap) is not ported: a
launch is B pairs, split from a bucket by the byte budget of its direction
bytes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import NEG_INF, Flag
from . import strips as _strips
from .bands import n_col_bytes
from .strips import (SMEM_MAX, _check_cuda, canonical_costs, long_params,
                     round_up)

W_MAX = 1472               # the band engine's widest band
L_MIN = 512                # buckets with Lt <= 512 take the batched route
KT = 4096                  # tie-key class stride (> the widest band + 1)


class BandParams(NamedTuple):
    """One launch's scalar parameters (post-swap costs for extd)."""
    m: int
    q: int
    e: int
    sc_mch: int
    sc_mis: int
    sc_N: int
    zdrop: int
    flag: int
    matt: tuple = ()       # flattened matrix when GENERIC_SC
    two: int = 0           # two-piece (extd) mode
    q2: int = 0
    e2: int = 0
    qe_pre: int = 0        # PRE-swap q + e: the extd H seed at r = 0
    lt: int = 0            # long_thres
    ld: int = 0            # long_diff
    cig: int = 0           # emit direction bytes


class BandLaunch(NamedTuple):
    """One prepared launch: parameters and padded host arrays."""
    prm: BandParams
    query: np.ndarray      # (B, Lq) uint8
    target: np.ndarray     # (B, Lt) uint8
    qlen: np.ndarray       # (B,) int32
    tlen: np.ndarray       # (B,) int32
    w: np.ndarray          # (B,) int32, 1 <= w <= W_MAX
    nd: int                # diagonals of the byte store (longest pair's)
    ncol: int              # bytes per stored diagonal (widest pair's)
    sites: tuple = ()      # splice (ops/batch_exts.py): (B, Lt) int8
    #                        donor and acceptor rows, after the matrix


_NEXT = {
    None: "take the batched route",
    "single": "take the single-pair engine",
    "any": "take the any-device route",
    "extd": "take the single-pair two-piece engine (kernel 13)",
    "exts": "take the single-pair splice engine (kernel 14)",
}


def beyond(nxt: Optional[str], what: str) -> str:
    """A route's refusal, naming the engine the JAX package takes next:
    the batched route (``nxt`` None), which the scheduler tries after the
    band route; the single-pair engine ("single", one-piece CIGARs), the
    any-device route ("any", one-piece scores), or the single-pair
    two-piece ("extd", scores and CIGARs) and splice ("exts") engines."""
    return f"{what} {_NEXT[nxt]}"


def band_ineligible_reason(Lt: int, qlen, tlen, w, mat, flag,
                           cigar: bool, two: bool = False) -> Optional[str]:
    """Why a bucket cannot run on the band route, or None when it can.

    The JAX route's conditions, which differ on the two paths:

    * scores (``scheduler.py:260-264, 496-499``): ``Lt > 512``, every
      band ``1 <= w <= 1472`` with ``w = -1`` already replaced by
      ``max(qlen, tlen)``, and ``mat[0] * min(qlen.max(), tlen.max()) <
      2**17``;
    * CIGARs (``scheduler.py:670-675``): the same on the RAW ``w`` of the
      jobs, and no EXTZ_ONLY.

    ``Lt`` is the bucket's target length key.  The reason names the
    engine the JAX package takes next: the batched route up to 3072
    (scores) or 1536 (CIGARs without EXTZ_ONLY), else the single-pair
    engine (one-piece CIGARs), the any-device route (one-piece scores) or
    the single-pair two-piece engine."""
    flag = int(flag)
    if Lt <= L_MIN:
        return beyond(None, "buckets with targets of 512 or less")
    if cigar:
        nxt = None if Lt <= 1536 and not flag & int(Flag.EXTZ_ONLY) else (
            "extd" if two else "single")
        if flag & int(Flag.EXTZ_ONLY):
            return beyond(nxt, "EXTZ_ONLY CIGARs on long banded pairs")
    else:
        nxt = None if Lt <= 3072 else ("extd" if two else "any")
    w = np.asarray(w)
    if w.min() < 1 or w.max() > W_MAX:
        return beyond(nxt, "bands outside 1 <= w <= 1472 (or no band) on "
                      "targets over 512")
    mat = np.asarray(mat).reshape(-1)
    if int(mat[0]) * int(min(np.max(qlen), np.max(tlen))) >= (1 << 17):
        return beyond(nxt, "scores outside the band engine's range")
    return None


def make_band_params(m, mat, q, e, zdrop, flag, cig=False, two=False,
                     q2=0, e2=0) -> BandParams:
    """A launch's params; two-piece callers pass PRE-swap costs, and the
    launch carries the post-swap ones (``band_batch.py:726-735``)."""
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    q, e = int(q), int(e)
    qe_pre = q + e
    lt = ld = 0
    if two:
        q, e, q2, e2, _ = canonical_costs(q, e, q2, e2)
        lt, ld = long_params(q, e, q2, e2)
    else:
        q2 = e2 = 0
    eN = e2 if two else e
    sc_N = -eN if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    generic = bool(int(flag) & int(Flag.GENERIC_SC))
    return BandParams(
        m=int(m), q=q, e=e, sc_mch=int(mat[0]), sc_mis=int(mat[1]),
        sc_N=sc_N, zdrop=int(zdrop), flag=int(flag),
        matt=tuple(int(v) for v in mat) if generic else (),
        two=int(bool(two)), q2=int(q2), e2=int(e2), qe_pre=qe_pre,
        lt=int(lt), ld=int(ld), cig=int(bool(cig)))


def band_prep(query, target, qlen, tlen, w, m, mat, q, e, zdrop, flag,
              cig: bool = False, two: bool = False, q2: int = 0,
              e2: int = 0) -> List[BandLaunch]:
    """Plan and pad one bucket's launches (host only, no device work).

    A launch is padded to its longest query and target.  With ``cig`` a
    launch holds as many pairs (in the given order) as keep its direction
    bytes, ``B * nd * ncol``, within ``ops.strips.LAUNCH_BYTES``.  Callers
    must have checked eligibility; two-piece callers pass PRE-swap
    costs."""
    w = np.asarray(w, np.int32)
    prm = make_band_params(m, mat, q, e, zdrop, flag, cig, two, q2, e2)
    return [BandLaunch(prm, qpad, tpad, ql, tl, w[i0:i1].copy(), nd, nc)
            for i0, i1, qpad, tpad, ql, tl, nd, nc in split_launches(
                query, target, qlen, tlen, w, m, cig)]


def split_launches(query, target, qlen, tlen, w, m: int, cig: bool):
    """Cut a bucket (in the given order) into launches and pad each one:
    with ``cig`` a launch holds as many pairs as keep its rotated store,
    ``B * nd * ncol`` bytes, within ``ops.strips.LAUNCH_BYTES``.  Yields
    ``(i0, i1, qpad, tpad, qlen, tlen, nd, ncol)`` per launch of pairs
    ``[i0, i1)``, padded to its longest query and target rounded to 16."""
    qlen = np.asarray(qlen, np.int32)
    tlen = np.asarray(tlen, np.int32)
    B = len(query)
    nds = qlen.astype(np.int64) + tlen - 1
    ncs = [n_col_bytes(int(a), int(b), int(c))
           for a, b, c in zip(qlen, tlen, w)]
    i0 = 0
    while i0 < B:
        nd, nc = int(nds[i0]), ncs[i0]
        i1 = i0 + 1
        while i1 < B:
            nd2, nc2 = max(nd, int(nds[i1])), max(nc, ncs[i1])
            if cig and (i1 - i0 + 1) * nd2 * nc2 > _strips.LAUNCH_BYTES:
                break
            nd, nc = nd2, nc2
            i1 += 1
        ql, tl = qlen[i0:i1], tlen[i0:i1]
        qpad = np.zeros((i1 - i0, round_up(int(ql.max()), 16)), np.uint8)
        tpad = np.zeros((i1 - i0, round_up(int(tl.max()), 16)), np.uint8)
        for k in range(i1 - i0):
            qpad[k, :ql[k]] = query[i0 + k]
            tpad[k, :tl[k]] = target[i0 + k]
        if max(int(qpad.max()), int(tpad.max())) >= m:
            raise ValueError(f"sequence symbols must be < m = {m}")
        yield i0, i1, qpad, tpad, ql.copy(), tl.copy(), nd, nc
        i0 = i1


# --------------------------------------------------------------------------
# Kernels C and C2: the forward, its plain version and its wrapper


def _w8(x):
    """Wrap to int8 (C's truncating conversion), kept in a wider type."""
    return ((x + 128) & 255) - 128


def band_forward_plain(qs, ts, qlen, tlen, w, table, prm: BandParams,
                       nd: int, ncol: int, with_stop: bool = False):
    """Plain PyTorch version of ``csrc/band_fwd.cu`` and of
    ``csrc/batch_fwd.cu`` (the batched route, ``ops/batch.py``): one
    Python step per anti-diagonal, batched over the pairs, each pair's
    band gathered as a window of ``max(w) + 48`` positions from
    full-length state rows; any ``w >= 0``.
    Returns ``rec`` (B, 9) int32 in ``FIELD_ORDER`` and, with ``cig``,
    ``p`` (B, nd, ncol) uint8 (rows and bytes never written are 0);
    ``with_stop`` adds ``stop`` (B,) int32, the diagonals each pair
    computed (its Z-drop diagonal + 1, else its first empty one)."""
    dev = qs.device
    i64 = torch.int64
    B, Lq = qs.shape
    Lt = ts.shape[1]
    flag = prm.flag
    two = bool(prm.two)
    approx = bool(flag & int(Flag.APPROX_MAX))
    adrop = approx and bool(flag & int(Flag.APPROX_DROP))
    right = bool(flag & int(Flag.RIGHT))
    generic = bool(flag & int(Flag.GENERIC_SC))
    m, q, e, q2, e2 = prm.m, prm.q, prm.e, prm.q2, prm.e2
    qe, qe2 = q + e, q2 + e2
    ez = e2 if two else e                 # Z-drop gap slope
    ql, tl, wl = qlen.to(i64), tlen.to(i64), w.to(i64)
    ndb = ql + tl - 1
    WB = round_up(int(wl.max()) + 48, 16)
    N = round_up(Lt, 16) + WB + 32
    k = torch.arange(WB, dtype=i64, device=dev)[None, :]
    tpad = torch.zeros((B, N), dtype=i64, device=dev)
    tpad[:, :Lt] = ts.to(i64)
    qsl = qs.to(i64)
    tab = table.to(device=dev, dtype=i64)

    def full(v):
        return torch.full((B, N), v, dtype=i64, device=dev)

    init = _w8(-qe) if two else 0
    u, v, x, y = full(init), full(init), full(init), full(init)
    if two:
        x2, y2 = full(_w8(-qe2)), full(_w8(-qe2))
    s = full(0)
    H = full(NEG_INF)

    def vec(val):
        return torch.full((B,), val, dtype=i64, device=dev)

    last_st, last_en = vec(-1), vec(-1)
    H0, lt0 = vec(0), vec(0)
    mx, mt, mq = vec(0), vec(-1), vec(-1)
    mqe, mqet, mte, mteq, score = (vec(NEG_INF), vec(-1), vec(NEG_INF),
                                   vec(-1), vec(NEG_INF))
    zd = torch.zeros((B,), dtype=torch.bool, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    nrow = vec(0)
    p = (torch.zeros((B, nd, ncol), dtype=torch.uint8, device=dev)
         if prm.cig else None)
    KB = min(WB, ncol)

    def apply_zdrop(act, Hm, t):
        nonlocal mx, mt, mq
        better = act & (Hm > mx)
        tl_, ql_ = t - mt, (r - t) - mq
        lgap = (tl_ - ql_).abs()
        drop = (act & ~better & (t >= mt) & (r - t >= mq)
                & (mx - Hm > prm.zdrop + lgap * ez))
        if prm.zdrop < 0:
            drop = torch.zeros_like(drop)
        mx = torch.where(better, Hm, mx)
        mt = torch.where(better, t, mt)
        mq = torch.where(better, r - t, mq)
        return drop

    for r in range(int(ndb.max())):
        act = alive & (r < ndb)
        if r % 256 == 0 and not bool(act.any()):
            break                          # every pair has stopped
        st0 = torch.clamp(torch.maximum(r - ql + 1, (r - wl + 1) >> 1), min=0)
        en0 = torch.minimum(torch.clamp(tl - 1, max=r), (r + wl) >> 1)
        empty = act & (st0 > en0)
        zd |= empty
        alive &= ~empty
        act &= ~empty
        nrow = torch.where(act, r + 1, nrow)
        st0 = torch.where(act, st0, 0)
        en0 = torch.where(act, en0, 0)
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        pos = st[:, None] + k

        # boundary deltas entering lane st (ksw2_extz2_sse.c:152-158)
        sm1 = torch.clamp(st - 1, min=0)[:, None]
        prevok = (st > 0) & (last_st <= st - 1) & (st - 1 <= last_en)
        if two:
            colv = _w8(-qe if r == 0 else
                       (-e if r < prm.lt else (prm.ld if r == prm.lt
                                               else -e2)))
            x1 = torch.where(prevok, x.gather(1, sm1)[:, 0], _w8(-qe))
            x21 = torch.where(prevok, x2.gather(1, sm1)[:, 0], _w8(-qe2))
            v1 = torch.where(prevok, v.gather(1, sm1)[:, 0],
                             torch.where(st == 0, colv, _w8(-qe)))
        else:
            colv = _w8(q if r else 0)
            x1 = torch.where(prevok, x.gather(1, sm1)[:, 0], 0)
            v1 = torch.where(prevok, v.gather(1, sm1)[:, 0],
                             torch.where(st == 0, colv, 0))
        # first-column boundary (the j == 0 cell at t == r)
        if r < N:
            cm = act & (en >= r)
            u[:, r] = torch.where(cm, colv, u[:, r])
            y[:, r] = torch.where(cm, _w8(-qe) if two else 0, y[:, r])
            if two:
                y2[:, r] = torch.where(cm, _w8(-qe2), y2[:, r])

        # score fill: [st0, hi) unaligned 16-byte stores, or [st0, en0]
        # with GENERIC_SC; other lanes keep stale bytes
        tv_ = tpad.gather(1, pos)
        qi = r - pos
        qv = torch.where(qi >= 0,
                         qsl.gather(1, qi.clamp(0, Lq - 1)), 0)
        if generic:
            vals = _w8(tab[tv_ * m + qv])
            fm = (pos >= st0[:, None]) & (pos <= en0[:, None])
        else:
            vals = torch.where(tv_ == qv, _w8(prm.sc_mch), _w8(prm.sc_mis))
            vals = torch.where((tv_ == m - 1) | (qv == m - 1),
                               _w8(prm.sc_N), vals)
            hi = st0 + (en0 - st0) // 16 * 16 + 16
            fm = (pos >= st0[:, None]) & (pos < hi[:, None])
        S = torch.where(fm & act[:, None], vals, s.gather(1, pos))
        s.scatter_(1, pos, S)

        U, V, X, Y = (a.gather(1, pos) for a in (u, v, x, y))
        Xt1 = torch.cat([x1[:, None], X[:, :-1]], 1)
        Vt1 = torch.cat([v1[:, None], V[:, :-1]], 1)
        a = _w8(Xt1 + Vt1)
        b = _w8(Y + U)
        d = None
        if not two:
            zz = _w8(S + 2 * qe)
            if prm.cig:
                d = (zz <= a).to(i64) if right else (a > zz).to(i64)
            z = torch.maximum(zz, a)
            if prm.cig:
                d = (torch.where(z > b, d, 2) if right
                     else torch.where(b > z, 2, d))
            z = _w8(torch.maximum(z & 255, b & 255))
            z = _w8(torch.clamp(z & 255, max=(prm.sc_mch + 2 * qe) & 255))
            un, vn = _w8(z - Vt1), _w8(z - U)
            z2 = _w8(z - q)
            a, b = _w8(a - z2), _w8(b - z2)
            if prm.cig:
                ta, tb = (a >= 0, b >= 0) if right else (a > 0, b > 0)
                d = d | ta.to(i64) * 0x08 | tb.to(i64) * 0x10
            xn, yn = torch.clamp(a, min=0), torch.clamp(b, min=0)
        else:
            X2, Y2 = x2.gather(1, pos), y2.gather(1, pos)
            X2t1 = torch.cat([x21[:, None], X2[:, :-1]], 1)
            a2, b2 = _w8(X2t1 + Vt1), _w8(Y2 + U)
            z = S
            d = torch.zeros_like(z)
            for cand, code in ((a, 1), (b, 2), (a2, 3), (b2, 4)):
                if prm.cig:
                    d = (torch.where(z > cand, d, code) if right
                         else torch.where(cand > z, code, d))
                z = torch.maximum(z, cand)
            z = torch.clamp(z, max=_w8(prm.sc_mch))
            un, vn = _w8(z - Vt1), _w8(z - U)
            t1, t2 = _w8(z - q), _w8(z - q2)
            a, b = _w8(a - t1), _w8(b - t1)
            a2, b2 = _w8(a2 - t2), _w8(b2 - t2)
            if prm.cig:
                bits = ((a, 0x08), (b, 0x10), (a2, 0x20), (b2, 0x40))
                for val, bit in bits:
                    c = val >= 0 if right else val > 0
                    d = d | c.to(i64) * bit
            xn = _w8(torch.clamp(a, min=0) - qe)
            yn = _w8(torch.clamp(b, min=0) - qe)
            x2n = _w8(torch.clamp(a2, min=0) - qe2)
            y2n = _w8(torch.clamp(b2, min=0) - qe2)
        blk = act[:, None] & (pos <= en[:, None])
        for arr, new, old in ((u, un, U), (v, vn, V), (x, xn, X), (y, yn, Y)):
            arr.scatter_(1, pos, torch.where(blk, new, old))
        if two:
            x2.scatter_(1, pos, torch.where(blk, x2n, X2))
            y2.scatter_(1, pos, torch.where(blk, y2n, Y2))
        if prm.cig:
            p[:, r, :KB] = torch.where(blk[:, :KB], d[:, :KB], 0).to(
                torch.uint8)

        ke = (en0 - st)[:, None]
        if not approx:
            vv, uu = (vn, un) if two else (vn & 255, un & 255)
            sub = 0 if two else qe
            Hw = H.gather(1, pos)
            h_prev = H.gather(1, torch.clamp(en0 - 1, min=0)[:, None])[:, 0]
            h_en0 = torch.where(
                en0 > 0, h_prev + uu.gather(1, ke)[:, 0],
                Hw.gather(1, ke)[:, 0] + vv.gather(1, ke)[:, 0]) - sub
            if r == 0:
                h_en0 = vv[:, 0] - (prm.qe_pre if two else 2 * qe)
            band = act[:, None] & (pos >= st0[:, None]) & \
                (pos <= en0[:, None])
            inner = band & (pos < en0[:, None])
            Hn = torch.where(inner, Hw + vv - sub, Hw)
            Hn = Hn.scatter(1, ke, h_en0[:, None])
            H.scatter_(1, pos, torch.where(band, Hn, Hw))
            # the SSE scan's tie order: the en0 cell, then 4 lane classes
            # over [st0, en1), then the scalar tail (spec/common.py)
            rel = pos - st0[:, None]
            en1 = (st0 + (en0 - st0) // 4 * 4)[:, None]
            key = torch.where(pos < en1, (rel & 3) * KT + rel + 1,
                              4 * KT + rel + 1)
            key = torch.where(pos == en0[:, None], 0, key)
            packed = torch.where(band, Hn * (1 << 20) + ((1 << 20) - 1 - key),
                                 torch.iinfo(i64).min)
            best = packed.max(dim=1).values
            maxH = torch.div(best, 1 << 20, rounding_mode="floor")
            kst = (1 << 20) - 1 - (best - maxH * (1 << 20))
            maxt = torch.where(kst == 0, en0,
                               torch.where(kst <= 4 * KT,
                                           st0 + (kst - 1) % KT,
                                           st0 + kst - 1 - 4 * KT))
            hst = Hn.gather(1, (st0 - st)[:, None])[:, 0]
            hen = h_en0
            cq = act & (en0 == tl - 1) & (hen > mte)
            mte = torch.where(cq, hen, mte)
            mteq = torch.where(cq, r - en, mteq)
            cq = act & (r - st0 == ql - 1) & (hst > mqe)
            mqe = torch.where(cq, hst, mqe)
            mqet = torch.where(cq, st0, mqet)
            drop = apply_zdrop(act, maxH, maxt)
            fin = hen
        else:
            if r == 0:
                H0 = torch.where(act, vn[:, 0] - prm.qe_pre if two
                                 else (vn[:, 0] & 255) - 2 * qe, H0)
                lt0 = torch.where(act, 0, lt0)
            else:
                c1 = (st0 <= lt0) & (lt0 <= en0)
                c2 = (st0 <= lt0 + 1) & (lt0 + 1 <= en0)
                kk = (lt0 - st)[:, None]
                d0 = vn.gather(1, torch.clamp(kk, 0, WB - 1))[:, 0]
                d1 = un.gather(1, torch.clamp(kk + 1, 0, WB - 1))[:, 0]
                if not two:
                    d0, d1 = (d0 & 255) - qe, (d1 & 255) - qe
                both = c1 & c2
                inc = torch.where(both, torch.maximum(d0, d1),
                                  torch.where(c1, d0, d1))
                step = torch.where(both, (d0 <= d1).to(i64),
                                   torch.where(c1, 0, 1))
                H0 = torch.where(act, H0 + inc, H0)
                lt0 = torch.where(act, lt0 + step, lt0)
            if adrop and (two or r > 0):
                drop = apply_zdrop(act, H0, lt0)
            else:
                drop = torch.zeros_like(act)
            fin = H0
        zd |= drop
        alive &= ~drop
        cs = act & ~drop & (r == ndb - 1) & (en0 == tl - 1)
        score = torch.where(cs, fin, score)
        last_st = torch.where(act, st, last_st)
        last_en = torch.where(act, en, last_en)
    rec = torch.stack([mx, mt, mq, mqe, mqet, mte, mteq, score,
                       zd.to(i64)], dim=1).to(torch.int32)
    if with_stop:
        return rec, p, nrow.to(torch.int32)
    return rec, p


TILES = (32, 64)           # the band route's tile widths (target positions)
NW_MAX = 25                # ... and compute warps a block (the kernel's
                           # bound, csrc/band_fwd.cu MAX_NW, is 26)
KD = 32                    # diagonals a hand-off group


def band_layout(ncol: int, tiles=TILES, nw_max: int = NW_MAX):
    """A launch's ``(tp, nw, ring)`` for ``csrc/band_fwd.cu``: the tile
    ``tp``, the compute warps ``nw`` a block and the per-diagonal ring,
    from the launch's ``ncol`` (so planning needs nothing from the
    device).  A warp takes every ``nw``-th tile of its pair, so ``nw``
    must keep a tile's first diagonal after the last one of the tile
    ``nw`` before it: ``nw * tp > tp + min(w + 14, qlen + 13)``, or ``nw``
    at least the pair's tiles, ``ceil((tlen + 15) / tp)``; ``nw = 2 +
    (M + 13) // tp`` with ``M = min(qlen, tlen, w + 1)`` does both, and
    ``M <= ncol - 16`` for every pair of the launch.  The first of
    ``tiles`` (the band route's: 32 positions, then 64) on which that
    takes at most ``nw_max`` warps.  The ring holds the diagonals between
    the replay and the leading tile (about a group a warp) and a margin,
    a power of two.  Raises ``ValueError`` for an ``ncol`` no tile
    takes."""
    for tp in tiles:
        nw = 2 + (ncol - 3) // tp
        if nw <= nw_max:
            break
    else:
        raise ValueError(f"ncol {ncol}: tiles of up to {tiles[-1]} positions "
                         f"and {nw_max} warps take ncol <= "
                         f"{2 + (nw_max - 1) * tiles[-1]}")
    ring = 1 << max(8, ((nw + 8) * KD - 1).bit_length())
    return tp, nw, ring


def fwd_smem_bytes(tp: int, nw: int, ring: int, m: int = 8) -> int:
    """Dynamic shared memory of one block (the layout at the head of
    ``csrc/band_fwd.cu``): the per-diagonal rings of keys and of H at
    st0 / en0, the control words and the score table, each compute
    warp's ``WarpSmem`` and, for ``m > 8``, the m x m score bytes."""
    return 16 * ring + 4 * (4 * 32 + 4 + 64) + nw * (3024 + 4 * tp) + \
        (round_up(m * m, 16) if m > 8 else 0)


def band_forward_cuda(qs, ts, qlen, tlen, w, table, prm: BandParams,
                      nd: int, ncol: int):
    """Launch ``csrc/band_fwd.cu`` on the current stream; same contract
    as :func:`band_forward_plain`.  The block's layout comes from ``ncol``
    (:func:`band_layout`), so nothing here reads the device and a batch's
    launches queue without a host synchronisation."""
    B, Lq = qs.shape
    Lt = ts.shape[1]
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, Lt), "target", dev)
    for t, name in ((qlen, "qlen"), (tlen, "tlen"), (w, "w")):
        _check_cuda(t, torch.int32, (B,), name, dev)
    _check_cuda(table, torch.int32, (prm.m * prm.m,), "table", dev)
    if prm.m > 8:
        raise ValueError("the band kernel takes m <= 8")
    if ncol % 16 or ncol > n_col_bytes(2 * W_MAX, 2 * W_MAX, W_MAX):
        raise ValueError(f"ncol {ncol}: a band is at most {W_MAX} wide")
    return band_launch_cuda(qs, ts, qlen, tlen, w, table, prm, nd, ncol,
                            band_layout(ncol), "band_extd_fwd" if prm.two
                            else "band_fwd")


def band_launch_cuda(qs, ts, qlen, tlen, w, table, prm: BandParams,
                     nd: int, ncol: int, lay, name: str):
    """Launch ``csrc/band_fwd.cu`` at the layout ``lay = (tp, nw, ring)``
    (:func:`band_layout`), counted as ``LAUNCHES[name]``: kernels 9 / 10
    (:func:`band_forward_cuda`) and the batched route's wide form
    (``batch.batch_forward_cuda``).  The tensors are checked by the
    caller; raises ``ValueError`` before the launch when the block's
    shared memory does not fit."""
    B, Lq = qs.shape
    Lt = ts.shape[1]
    dev = qs.device
    tp, nw, ring = lay
    smem = fwd_smem_bytes(tp, nw, ring, prm.m)
    if smem > SMEM_MAX:
        raise ValueError(f"launch needs {smem} B of shared memory")
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    p = (torch.zeros((B, nd, ncol), dtype=torch.uint8, device=dev)
         if prm.cig else None)
    f = prm.flag
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_band_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), table.data_ptr(), B, Lq, Lt, prm.m, prm.q, prm.e,
            prm.q2, prm.e2, prm.qe_pre, prm.lt, prm.ld, prm.sc_mch,
            prm.sc_mis, prm.sc_N, prm.zdrop,
            int(bool(f & int(Flag.RIGHT))),
            int(bool(f & int(Flag.GENERIC_SC))),
            int(bool(f & int(Flag.APPROX_MAX))),
            int(bool(f & int(Flag.APPROX_DROP))), prm.cig, prm.two, nd,
            ncol, tp, nw, ring, rec.data_ptr(),
            p.data_ptr() if p is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
    LAUNCHES[name] += 1
    return rec, p


def band_forward(*args, cuda=band_forward_cuda, plain=band_forward_plain):
    """The forward on the tensors' device: ``cuda(*args)`` for CUDA
    tensors, ``plain(*args)`` for CPU tensors.  ``args`` are
    :func:`band_upload`'s tensors, then ``prm, nd, ncol``.  The pair is
    the band kernel's by default; the batched route passes
    ``batch.batch_forward_cuda`` (same contract and plain version), the
    splice route ``batch_exts``'s pair, which also reads the site rows."""
    qs = args[0]
    if qs.is_cuda:
        return cuda(*args)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return plain(*args)


# --------------------------------------------------------------------------
# One launch end to end


def band_upload(launch: BandLaunch, device):
    """The launch's inputs (query, target, qlen, tlen, w, score matrix and
    a splice launch's donor and acceptor rows) as tensors on ``device``;
    CUDA uploads go through pinned memory (see ``ops.strips.upload``)."""
    dev = torch.device(device)
    mat = np.zeros(launch.prm.m * launch.prm.m, np.int32)
    if launch.prm.matt:
        mat[:] = launch.prm.matt
    host = [torch.from_numpy(a) for a in (
        launch.query, launch.target, launch.qlen, launch.tlen, launch.w,
        mat, *launch.sites)]
    if dev.type != "cuda":
        return tuple(host)
    return tuple(t.pin_memory().to(dev, non_blocking=True) for t in host)


def band_records(launch: BandLaunch, device, cuda=band_forward_cuda,
                 plain=band_forward_plain):
    """Forward of one score launch (the pair ``cuda`` / ``plain``, see
    :func:`band_forward`); (B, 9) int32 records on ``device`` (enqueued,
    not synchronised)."""
    rec, _ = band_forward(*band_upload(launch, device), launch.prm,
                          launch.nd, launch.ncol, cuda=cuda, plain=plain)
    return rec


__all__ = ["W_MAX", "BandParams", "BandLaunch", "beyond",
           "band_ineligible_reason",
           "make_band_params", "band_prep", "split_launches", "band_forward",
           "band_forward_plain", "band_layout", "band_forward_cuda",
           "band_launch_cuda",
           "fwd_smem_bytes",
           "band_upload", "band_records"]
