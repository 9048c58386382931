"""Batched splice route: the exts anti-diagonal engine (kernel 6).

Port of ``ksw2_tpu/ops/batch_pallas.py``'s ``exts_batch_records`` and
``exts_batch_align_dispatch`` with the forward kernel
``wavefront_batch_exts.py:_batch_exts_kernel``: the spliced extension of
``spec/diagdiff.py:exts2`` (``ksw2_exts2_sse.c``) for every splice bucket
of targets up to 1536 that the strips route refuses, such as buckets with
junction tracks or a ``junc_bonus``, EQX and APPROX_MAX.

The recurrence is exts2's: Suzuki-Kasahara deltas ``u, v, x, y`` and the
intron delta ``x2`` (deletion side only, initialised to ``-q2``) in
wrapping int8; the intron candidate ``a2 + acceptor[t]`` beside ``a`` and
``b`` with no clamp of ``z``; ``x2' = max(a2', donor[t]) - q2``; the
first-column switch ``ucol(r)`` (``-q - e`` at r = 0, ``-e`` before
``long_thres``, ``long_diff`` at it, 0 after); H without offsets, seeded
``v - (q + e)``; Z-drop with no gap slope, exact or APPROX (APPROX_DROP
from r = 0); no ``end_bonus``.  With ``cig`` the direction bytes (codes
1..3, bits 0x08 / 0x10 / 0x20) go into the band route's rotated store
``p[b, r, t - st(r)]`` with ``w = qlen + tlen`` (exts has no band), so
``band_walker.band_walk`` walks them with ``min_intron = long_thres``.
There is no EQX pass: the reference's exts2 has none (``ops/exts.py:
221``), so EQX splice CIGARs keep M ops.

The forward has two implementations: ``csrc/batch_exts_fwd.cu`` (one warp
a pair, kernel E's design) for CUDA tensors and
:func:`batch_exts_forward_plain` for CPU tensors.  Everything around them
is the band route's: a launch is a ``band.BandLaunch`` that carries its
donor and acceptor rows (``sites``), and ``band.band_records`` /
``band_walker.band_cigar_launch`` run it with this pair as the forward
(:func:`batch_exts_records`, :func:`batch_exts_cigar_launch`).  The TPU
layout (P sublane rows a pair, biased bytes in int32 lanes, the query
injection plane, the packed 13-bit argmax, ``RMAX`` launch caps) is not
ported.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from .band import BandLaunch, KT, _w8, band_records, beyond, split_launches
from .band_walker import band_cigar_launch
from .batch import LT_CIGARS, MAX_WARPS, strip_len
from .splice import pad_juncs, splice_profiles
from .strips import SMEM_MAX, _check_cuda, long_params
from .strips_walker import unpack_cigars


class ExtsParams(NamedTuple):
    """One launch's scalar parameters (``BatchExtsParams`` without its TPU
    layout fields)."""
    m: int
    q: int
    e: int
    q2: int                # intron open
    lt: int                # long_thres: min_intron_len of the walk
    ld: int                # long_diff
    sc_mch: int
    sc_mis: int
    sc_N: int
    zdrop: int
    flag: int
    matt: tuple = ()       # flattened matrix when GENERIC_SC
    cig: int = 0           # emit direction bytes


def batch_exts_ineligible_reason(Lt: int, flag) -> Optional[str]:
    """Why a splice bucket cannot run on the batched exts route, or None
    (``scheduler.py:990``: ``Lt <= 1536`` and no EXTZ_ONLY, scores and
    CIGARs alike); the JAX package takes the single-pair ``exts2_device``
    next (``scheduler.py:1020-1027``)."""
    if Lt > LT_CIGARS:
        return beyond("exts", "splice pairs with targets over 1536")
    if int(flag) & int(Flag.EXTZ_ONLY):
        return beyond("exts", "EXTZ_ONLY splice pairs")
    return None


def batch_exts_resets(m: int, mat, q: int, e: int, q2: int) -> bool:
    """The batched route's guard (``batch_pallas.py:1542-1543,
    1623-1624``): every pair of the slice gets a reset ez when ``m <= 1
    or q2 <= q + e or -min_sc > 2 (q + e)``, as exts2 returns at once."""
    min_sc = int(np.asarray(mat).reshape(-1)[1:].min())
    return m <= 1 or q2 <= q + e or -min_sc > 2 * (q + e)


def make_exts_params(m, mat, q, e, q2, zdrop, flag, cig=False) -> ExtsParams:
    """A launch's params (``batch_pallas.py:_exts_batch_prep``): long_thres
    and long_diff with ``e2 = 0``, and the wildcard score ``sc_N``."""
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    lt, ld = long_params(int(q), int(e), int(q2), 0)
    sc_N = -int(e) if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    generic = bool(int(flag) & int(Flag.GENERIC_SC))
    return ExtsParams(
        m=int(m), q=int(q), e=int(e), q2=int(q2), lt=int(lt), ld=int(ld),
        sc_mch=int(mat[0]), sc_mis=int(mat[1]), sc_N=sc_N, zdrop=int(zdrop),
        flag=int(flag), matt=tuple(int(v) for v in mat) if generic else (),
        cig=int(bool(cig)))


def batch_exts_prep(query, target, qlen, tlen, m, mat, q, e, q2, noncan,
                    zdrop, flag, juncs=None, junc_bonus: int = 0,
                    cig: bool = True) -> List[BandLaunch]:
    """Plan and pad one splice bucket's launches (host only): the band
    route's split by the byte budget (``band.split_launches``) with ``w =
    qlen + tlen`` (exts has no band: ``w`` is the walker's), and each
    launch's int8 donor and acceptor rows (its ``sites``) with the pairs'
    junction tracks (``juncs``: one array or None a pair, in the bucket's
    order) folded in as ``junc_bonus``.  Callers must have checked
    eligibility and the reset guard."""
    qlen = np.asarray(qlen, np.int32)
    tlen = np.asarray(tlen, np.int32)
    w = (qlen + tlen).astype(np.int32)
    prm = make_exts_params(m, mat, q, e, q2, zdrop, flag, cig)
    launches = []
    for i0, i1, qpad, tpad, ql, tl, nd, nc in split_launches(
            query, target, qlen, tlen, w, m, cig):
        Lt = tpad.shape[1]
        jb = pad_juncs(None if juncs is None else juncs[i0:i1], tl, Lt)
        don, acc = splice_profiles(tpad, tl, Lt, noncan, flag, jb,
                                   junc_bonus)
        launches.append(BandLaunch(prm, qpad, tpad, ql, tl, w[i0:i1].copy(),
                                   nd, nc, (don, acc)))
    return launches


# --------------------------------------------------------------------------
# Kernel 6: the forward, its plain version and its wrapper


def batch_exts_forward_plain(qs, ts, qlen, tlen, w, table, don, acc,
                             prm: ExtsParams, nd: int, ncol: int,
                             with_stop: bool = False):
    """Plain PyTorch version of ``csrc/batch_exts_fwd.cu``: the exts2
    recurrence, one Python step per anti-diagonal, batched over the pairs
    on full-length state rows.  The arguments are ``band.band_upload``'s
    (``w`` is the walker's and unused here), then ``prm, nd, ncol``.
    Returns ``rec`` (B, 9) int32 in ``FIELD_ORDER`` and, with ``cig``,
    ``p`` (B, nd, ncol) uint8 (rows and bytes never written are 0);
    ``with_stop`` adds ``stop`` (B,) int32, the diagonals each pair
    computed (its Z-drop diagonal + 1, else all of them)."""
    dev = qs.device
    i64 = torch.int64
    B, Lq = qs.shape
    Lt = ts.shape[1]
    flag = prm.flag
    approx = bool(flag & int(Flag.APPROX_MAX))
    adrop = approx and bool(flag & int(Flag.APPROX_DROP))
    right = bool(flag & int(Flag.RIGHT))
    generic = bool(flag & int(Flag.GENERIC_SC))
    m, q, e, q2 = prm.m, prm.q, prm.e, prm.q2
    qe = q + e
    ql, tl = qlen.to(i64), tlen.to(i64)
    ndb = ql + tl - 1
    N = Lt + 32                  # the score fill overshoots by up to 15
    pos = torch.arange(N, dtype=i64, device=dev)[None, :]
    kcol = torch.arange(ncol, dtype=i64, device=dev)[None, :]

    def row(a, fill=0):
        out = torch.full((B, N), fill, dtype=i64, device=dev)
        out[:, :a.shape[1]] = a.to(i64)
        return out
    tpad = row(ts)
    dn, ac = row(don), row(acc)
    qsl = qs.to(i64)
    tab = table.to(device=dev, dtype=i64)

    def full(v):
        return torch.full((B, N), v, dtype=i64, device=dev)

    u, v, x, y = (full(_w8(-qe)) for _ in range(4))
    x2 = full(_w8(-q2))
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

    def apply_zdrop(act, Hm, t):
        # ksw_apply_zdrop with no gap slope (ksw2_exts2_sse.c:395-398)
        nonlocal mx, mt, mq
        better = act & (Hm > mx)
        drop = (act & ~better & (t >= mt) & (r - t >= mq)
                & (mx - Hm > prm.zdrop))
        if prm.zdrop < 0:
            drop = torch.zeros_like(drop)
        mx = torch.where(better, Hm, mx)
        mt = torch.where(better, t, mt)
        mq = torch.where(better, r - t, mq)
        return drop

    def shift1(a):
        return torch.cat([a[:, :1], a[:, :-1]], dim=1)

    for r in range(int(ndb.max())):
        act = alive & (r < ndb)
        if r % 256 == 0 and not bool(act.any()):
            break                          # every pair has stopped
        nrow = torch.where(act, r + 1, nrow)
        st0 = torch.where(act, torch.clamp(r - ql + 1, min=0), 0)
        en0 = torch.where(act, torch.clamp(tl - 1, max=r), 0)
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        ucol = _w8(-qe if r == 0 else -e if r < prm.lt else
                   prm.ld if r == prm.lt else 0)
        # the first-column boundary (the j == 0 cell at t == r)
        if r < N:
            cm = act & (en >= r)
            u[:, r] = torch.where(cm, ucol, u[:, r])
            y[:, r] = torch.where(cm, _w8(-qe), y[:, r])
        # score fill: [st0, hi) unaligned 16-byte stores, or [st0, en0]
        # with GENERIC_SC; other positions keep stale bytes
        qi = r - pos
        qv = torch.where((qi >= 0) & (qi < Lq),
                         qsl.gather(1, qi.clamp(0, Lq - 1).expand(B, N)), 0)
        if generic:
            vals = _w8(tab[tpad * m + qv])
            fm = (pos >= st0[:, None]) & (pos <= en0[:, None])
        else:
            vals = torch.where(tpad == qv, _w8(prm.sc_mch), _w8(prm.sc_mis))
            vals = torch.where((tpad == m - 1) | (qv == m - 1),
                               _w8(prm.sc_N), vals)
            hi = st0 + (en0 - st0) // 16 * 16 + 16
            fm = (pos >= st0[:, None]) & (pos < hi[:, None])
        s = torch.where(fm & act[:, None], vals, s)

        # t - 1 of the previous diagonal; at t == st the boundary
        # (ksw2_exts2_sse.c:191-196): the stored st - 1 when the previous
        # diagonal computed it, else the init bytes (ucol at st == 0)
        prevok = (st > 0) & (last_st <= st - 1) & (st - 1 <= last_en)
        edge = (pos == st[:, None]) & ~prevok[:, None]
        Xt1 = torch.where(edge, _w8(-qe), shift1(x))
        X2t1 = torch.where(edge, _w8(-q2), shift1(x2))
        Vt1 = torch.where(edge, torch.where(st == 0, ucol, _w8(-qe))[:, None],
                          shift1(v))
        a = _w8(Xt1 + Vt1)
        b = _w8(y + u)
        a2 = _w8(X2t1 + Vt1)
        z = s
        d = torch.zeros_like(z)
        for cand, code in ((a, 1), (b, 2), (_w8(a2 + ac), 3)):
            if prm.cig:
                d = (torch.where(z > cand, d, code) if right
                     else torch.where(cand > z, code, d))
            z = torch.maximum(z, cand)
        un, vn = _w8(z - Vt1), _w8(z - u)
        t1 = _w8(z - q)
        a, b = _w8(a - t1), _w8(b - t1)
        a2 = _w8(a2 - z + q2)
        if prm.cig:
            for c, bit in (((a >= 0) if right else (a > 0), 0x08),
                           ((b >= 0) if right else (b > 0), 0x10),
                           ((a2 >= dn) if right else (a2 > dn), 0x20)):
                d = d | c.to(i64) * bit
        blk = act[:, None] & (pos >= st[:, None]) & (pos <= en[:, None])
        u = torch.where(blk, un, u)
        v = torch.where(blk, vn, v)
        x = torch.where(blk, _w8(torch.clamp(a, min=0) - qe), x)
        y = torch.where(blk, _w8(torch.clamp(b, min=0) - qe), y)
        x2 = torch.where(blk, _w8(torch.maximum(a2, dn) - q2), x2)
        if prm.cig:
            k = st[:, None] + kcol
            dk = d.gather(1, k.clamp(max=N - 1))
            keep = act[:, None] & (k <= en[:, None])
            p[:, r] = torch.where(keep, dk, 0).to(torch.uint8)

        if not approx:
            h_prev = H.gather(1, torch.clamp(en0 - 1, min=0)[:, None])[:, 0]
            h_en0 = torch.where(
                en0 > 0, h_prev + un.gather(1, en0[:, None])[:, 0],
                H.gather(1, en0[:, None])[:, 0]
                + vn.gather(1, en0[:, None])[:, 0])
            if r == 0:
                h_en0 = vn[:, 0] - qe
            band = act[:, None] & (pos >= st0[:, None]) & \
                (pos <= en0[:, None])
            Hn = torch.where(band & (pos < en0[:, None]), H + vn, H)
            Hn = Hn.scatter(1, en0[:, None], h_en0[:, None])
            H = torch.where(band, Hn, H)
            # the SSE scan's tie order: the en0 cell, then 4 lane classes
            # over [st0, en1), then the scalar tail (spec/common.py)
            rel = pos - st0[:, None]
            en1 = (st0 + (en0 - st0) // 4 * 4)[:, None]
            key = torch.where(pos < en1, (rel & 3) * KT + rel + 1,
                              4 * KT + rel + 1)
            key = torch.where(pos == en0[:, None], 0, key)
            packed = torch.where(band, H * (1 << 20) + ((1 << 20) - 1 - key),
                                 torch.iinfo(i64).min)
            best = packed.max(dim=1).values
            maxH = torch.div(best, 1 << 20, rounding_mode="floor")
            kst = (1 << 20) - 1 - (best - maxH * (1 << 20))
            maxt = torch.where(kst == 0, en0,
                               torch.where(kst <= 4 * KT,
                                           st0 + (kst - 1) % KT,
                                           st0 + kst - 1 - 4 * KT))
            hst = H.gather(1, st0[:, None])[:, 0]
            cq = act & (en0 == tl - 1) & (h_en0 > mte)
            mte = torch.where(cq, h_en0, mte)
            mteq = torch.where(cq, r - en, mteq)
            cq = act & (r - st0 == ql - 1) & (hst > mqe)
            mqe = torch.where(cq, hst, mqe)
            mqet = torch.where(cq, st0, mqet)
            drop = apply_zdrop(act, maxH, maxt)
            fin = h_en0
        else:
            # the O(1) H0 walk on signed deltas (ksw2_exts2_sse.c)
            if r == 0:
                H0 = torch.where(act, vn[:, 0] - qe, H0)
                lt0 = torch.where(act, 0, lt0)
            else:
                c1 = (st0 <= lt0) & (lt0 <= en0)
                c2 = (st0 <= lt0 + 1) & (lt0 + 1 <= en0)
                d0 = vn.gather(1, lt0.clamp(0, N - 1)[:, None])[:, 0]
                d1 = un.gather(1, (lt0 + 1).clamp(0, N - 1)[:, None])[:, 0]
                both = c1 & c2
                inc = torch.where(both, torch.maximum(d0, d1),
                                  torch.where(c1, d0, d1))
                step = torch.where(both, (d0 <= d1).to(i64),
                                   torch.where(c1, 0, 1))
                H0 = torch.where(act, H0 + inc, H0)
                lt0 = torch.where(act, lt0 + step, lt0)
            drop = apply_zdrop(act, H0, lt0) if adrop else \
                torch.zeros_like(act)
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


def warp_smem_bytes(Lt: int) -> int:
    """Shared memory of one warp (one pair) of ``csrc/batch_exts_fwd.cu``:
    the int32 H row, the int8 u, v, x, y, x2, the score bytes, the target
    and the donor and acceptor bytes, each ``strip_len(Lt)`` long."""
    return strip_len(Lt) * 13


def batch_exts_forward_cuda(qs, ts, qlen, tlen, w, table, don, acc,
                            prm: ExtsParams, nd: int, ncol: int):
    """Launch ``csrc/batch_exts_fwd.cu`` on the current stream; the
    contract of :func:`batch_exts_forward_plain`.  Nothing here reads the
    device; a pair whose rounded diagonal outgrows ``ncol`` traps in the
    kernel."""
    B, Lq = qs.shape
    Lt = ts.shape[1]
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, Lt), "target", dev)
    for t, name in ((qlen, "qlen"), (tlen, "tlen")):
        _check_cuda(t, torch.int32, (B,), name, dev)
    for t, name in ((don, "donor rows"), (acc, "acceptor rows")):
        _check_cuda(t, torch.int8, (B, Lt), name, dev)
    _check_cuda(table, torch.int32, (prm.m * prm.m,), "table", dev)
    if Lt > LT_CIGARS:
        raise ValueError(f"targets of {Lt}: the batched exts kernel takes "
                         f"{LT_CIGARS} or less")
    if ncol % 16:
        raise ValueError(f"ncol {ncol} is not a multiple of 16")
    warps = min(MAX_WARPS, SMEM_MAX // warp_smem_bytes(Lt))
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    p = (torch.zeros((B, nd, ncol), dtype=torch.uint8, device=dev)
         if prm.cig else None)
    f = prm.flag
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_exts_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            table.data_ptr(), don.data_ptr(), acc.data_ptr(), B, Lq, Lt,
            prm.m, prm.q, prm.e, prm.q2, prm.lt, prm.ld, prm.sc_mch,
            prm.sc_mis, prm.sc_N, prm.zdrop,
            int(bool(f & int(Flag.RIGHT))),
            int(bool(f & int(Flag.GENERIC_SC))),
            int(bool(f & int(Flag.APPROX_MAX))),
            int(bool(f & int(Flag.APPROX_DROP))), prm.cig, nd, ncol,
            strip_len(Lt), warps, rec.data_ptr(),
            p.data_ptr() if p is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_exts_fwd")
    LAUNCHES["batch_exts_fwd"] += 1
    return rec, p


# --------------------------------------------------------------------------
# One launch end to end: the band route's glue with kernel 6 (a launch's
# site rows also make ``band_cigar_launch`` walk state 3 as N)


batch_exts_records = functools.partial(band_records,
                                       cuda=batch_exts_forward_cuda,
                                       plain=batch_exts_forward_plain)
batch_exts_cigar_launch = functools.partial(band_cigar_launch,
                                            cuda=batch_exts_forward_cuda,
                                            plain=batch_exts_forward_plain)


def unpack_exts_cigars(launch: BandLaunch, rec: np.ndarray, res: np.ndarray,
                       runs: np.ndarray, mat) -> List[ExtzResult]:
    """One launch's host records and walker output -> ExtzResults with N
    ops for introns (``min_intron = long_thres``); no EQX pass."""
    prm = launch.prm
    return unpack_cigars(rec, res, runs, mat, prm.q, prm.e, 0, prm.flag,
                         prm.lt)


__all__ = ["ExtsParams", "batch_exts_ineligible_reason",
           "batch_exts_resets", "make_exts_params", "batch_exts_prep",
           "batch_exts_forward_plain", "batch_exts_forward_cuda",
           "warp_smem_bytes", "batch_exts_records", "batch_exts_cigar_launch",
           "unpack_exts_cigars"]
