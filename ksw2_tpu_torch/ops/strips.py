"""Strips route: host prep, forward kernel, record replay.

Port of ``ksw2_tpu/ops/wavefront_strips.py`` for one-piece (extz) and
two-piece (extd, ``two``) costs, score-only and with direction bytes
(``cig``).  The forward is the row-major extension DP that
``spec/strips.py:strips_forward`` and ``spec/strips_cigar.py`` specify
(two-piece: ``spec/strips_extd.py:strips_forward_extd`` and
``strips_forward_cigar_extd``); it emits per pair

* ``D[r]``: the packed ``H * KB + (KB - 1 - merge_key)`` maximum over the
  cells of global diagonal ``r = i + j``,
* ``Dq[r]``: H of the query-end cell on ``r`` (``SENT`` where none),
* ``hl[j]``: H of the last target row,
* with ``cig``, the reference's direction byte of every cell, row-major
  ``d8[b, i, j]`` (the bytes ``spec/strips_cigar.py``'s ``dmat`` holds;
  7-bit bytes for two-piece costs).

Two-piece launches carry the POST-swap costs (the reference swaps the
pieces when ``q2 + e2 < q + e``, ksw2_extd2_sse.c:78) and ``off0``, the
offset of the reference's pre-swap H seed, which the replay adds.

The splice form (``spl``, exts; ``spec/strips_cigar.py:
strips_exts_cigar``) adds the intron state ``NI``, a vertical carry with
no per-row decay: ``cand3 = NI + acceptor(i)`` enters H, the donor is
paid at the open, ``NI' = max(NI, H + donor(i) - q2)``; exts has no
per-cell clamp, its boundary is flat after ``long_thres`` (``e2 = 0``),
its direction bytes take code 3 with bit 0x20, and its Z-drop slope is 0.
The launch carries each pair's donor and acceptor rows (``ops/
splice.py``), one value a target row.

:func:`replay_records` then replays the reference's per-diagonal ez
automaton from those streams (``_postprocess`` in the JAX package).

The forward has two implementations: ``csrc/strips_fwd.cu`` for CUDA
tensors and :func:`strips_forward_plain` for CPU tensors.  The TPU
layout (128-column strips pipelined over plane rows, skewed bit-packed
symbols, the (8, 128) padding ladders) is not ported: a launch is just
``B`` pairs padded to the launch's longest query and its canonical
target capacity ``tv``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import NEG_INF, Flag

SENT = -(2 ** 31) + 1      # "no value" in the packed record streams
CH = 32                    # TPU steps per grid chunk (diagonal-cap math)
QMAX = 4608                # query cap
TMAX = 3072                # target cap
SMEM_MAX = 232448          # shared memory one H100 block may use
LAUNCH_BYTES = 1 << 30     # device bytes one launch may allocate

# canonical target capacities: tv sets the merge-key width KB, so the
# kernel, the plain version and the replay all use this one value
TLENP_LADDER = (32, 64, 128, 256, 384, 512, 768, 1024, 1280, 1536,
                2048, 2560, 3072)


class StripParams(NamedTuple):
    """One launch's scalar parameters (the JAX package's ``StripParams``
    without its TPU layout fields)."""
    tv: int                # t-capacity of the merge key (>= max tlen)
    m: int
    q: int                 # post-swap when two
    e: int
    mat0: int              # mat[0]: the reference per-cell clamp
    sc_mis: int
    sc_N: int
    zdrop: int
    flag: int
    matt: tuple = ()       # flattened matrix when GENERIC_SC
    two: int = 0           # two-piece (extd) mode
    q2: int = 0
    e2: int = 0
    lt: int = 0            # long_thres (boundary-condition crossover)
    ld: int = 0            # long_diff
    off0: int = 0          # reference pre-swap H-seed offset (extd quirk)
    cig: int = 0           # emit per-cell direction bytes
    spl: int = 0           # spliced (exts) mode: q2 is the intron open


class Launch(NamedTuple):
    """One prepared launch: parameters and padded host arrays."""
    prm: StripParams
    query: np.ndarray      # (B, Lq) uint8
    target: np.ndarray     # (B, tv) uint8
    qlen: np.ndarray       # (B,) int32
    tlen: np.ndarray       # (B,) int32
    don: Optional[np.ndarray] = None   # spl: (B, tv) int16 donor rows
    acc: Optional[np.ndarray] = None   # spl: (B, tv) int16 acceptor rows


def key_params(tv: int) -> Tuple[int, int]:
    """(KB, KBITS) of the packed (H, merge key) records at capacity tv."""
    kbits = int(5 * tv + 1).bit_length()
    return 1 << kbits, kbits


def round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _canon_tlenp(tmax: int) -> int:
    for v in TLENP_LADDER:
        if v >= tmax:
            return v
    return round_up(tmax, CH)


def _canon_s(s: int) -> int:
    return s if s <= 8 else (s + 1) & ~1


def _n_diag(S: int, tlenp: int) -> int:
    """The JAX route's record-stream diagonal capacity, kept so that the
    eligibility envelope is exactly the JAX package's."""
    t_real = tlenp + S - 1
    t_pad = round_up(t_real + 1, 128)
    nf = (t_pad // CH + 4) // 4
    return 127 * (S - 1) + nf * 128


def strips_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop,
                             q: int = 0, e: int = 0) -> Optional[str]:
    """Why a bucket cannot run on the strips route, or None when it can.

    The envelope is exactly ``wavefront_strips.strips_eligible``'s: plain
    exact score mode, ``m <= 8``, q <= 4608, t <= 3072, the 13-bit
    diagonal cap, the int32 packing guard, and a band that never clips.
    A reason names no ROADMAP item: the scheduler tries the band and
    batched routes next, and the last route's reason names the engine
    the JAX package would take.
    """
    flag = int(flag)
    if flag & (int(Flag.APPROX_MAX) | int(Flag.APPROX_DROP)):
        return "APPROX_MAX/APPROX_DROP (the strips route is exact)"
    if not (flag & int(Flag.SCORE_ONLY)):
        raise ValueError("strips eligibility is checked in score mode")
    if m > 8:
        return "m > 8"
    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)
    if qlen.size == 0 or qlen.min() < 1 or tlen.min() < 1:
        return "empty pairs are reset by the scheduler, not launched"
    if qlen.max() > QMAX or tlen.max() > TMAX:
        return "targets over 3072 or queries over 4608"
    mat = np.asarray(mat).reshape(-1)
    tv = _canon_tlenp(int(tlen.max()))
    if _n_diag(_canon_s((int(qlen.max()) + 127) // 128), tv) > 8191:
        return "the diagonal index exceeds 13 bits"
    KB, _ = key_params(tv)
    hmax = int(mat.max()) * int(np.minimum(qlen, tlen).max())
    hneg = 2 * (int(q) + int(e)) + int(e) * (int(qlen.max()) +
                                             int(tlen.max()))
    if hmax >= (1 << 17) or hneg >= (1 << 17) or \
            (max(hmax, hneg) + 1) * KB + KB >= (1 << 31):
        return "scores outside the int32 packed-key range"
    w = np.asarray(w).astype(np.int64)
    ql = qlen.astype(np.int64)
    tl = tlen.astype(np.int64)
    if bool(np.all(w >= np.maximum(ql, tl))):
        return None
    nd = int((ql + tl).max())
    r = np.arange(max(nd - 1, 1), dtype=np.int64)[None, :]
    live = r < (ql + tl - 1)[:, None]
    st_clip = (r - w[:, None] + 1) >> 1 > np.maximum(0, r - ql[:, None] + 1)
    en_clip = (r + w[:, None]) >> 1 < np.minimum(tl[:, None] - 1, r)
    if ((st_clip | en_clip) & live).any():
        return "bands that clip"
    return None


def strips_eligible(qlen, tlen, w, flag, m, mat, zdrop,
                    q: int = 0, e: int = 0) -> bool:
    """True when every pair can run on the strips route (score mode;
    the envelope of ``wavefront_strips.strips_eligible``)."""
    if not (int(flag) & int(Flag.SCORE_ONLY)):
        return False
    return strips_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop,
                                    q, e) is None


def long_params(q: int, e: int, q2: int, e2: int) -> Tuple[int, int]:
    """(long_thres, long_diff) of post-swap two-piece costs
    (ksw2_extd2_sse.c:88-92, ``spec/diagdiff.py:extd2``).  The division
    truncates toward zero, as C's does; ``spec/strips_extd.py``'s
    ceiling form gives the same pair whenever ``e >= e2``, the strips
    envelope, but not for the band route's ``e < e2``."""
    if e != e2:
        n, d = q2 - q, e - e2
        long_thres = (abs(n) // abs(d)) * (1 if (n >= 0) == (d > 0) else -1)
        long_thres -= 1
    else:
        long_thres = 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2
    return long_thres, long_diff


def canonical_costs(q: int, e: int, q2: int, e2: int):
    """The reference's canonicalisation swap (ksw2_extd2_sse.c:78): the
    piece with the smaller ``q + e`` comes first.  Returns the post-swap
    ``(q, e, q2, e2)`` and ``off0 = (q + e)_post - (q + e)_pre``."""
    q, e, q2, e2 = int(q), int(e), int(q2), int(e2)
    qe_pre = q + e
    if q2 + e2 < q + e:
        q, q2, e, e2 = q2, q, e2, e
    return q, e, q2, e2, (q + e) - qe_pre


def strips_extd_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop,
                                  q, e, q2, e2) -> Optional[str]:
    """Why a two-piece bucket cannot run on the strips route, or None.

    ``wavefront_strips.strips_extd_eligible``: after the swap the chains
    decouple only when ``e >= e2``, ``q, q2 >= 0`` and ``e, e2 >= 1``
    (``spec/strips_extd.py``); then the one-piece envelope with the
    post-swap ``q, e``."""
    q, e, q2, e2, _ = canonical_costs(q, e, q2, e2)
    if e < e2 or min(q, q2) < 0 or min(e, e2) < 1:
        return ("two-piece costs with e < e2 after the swap (or a negative "
                "q or a zero e)")
    return strips_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop, q, e)


def strips_extd_eligible(qlen, tlen, w, flag, m, mat, zdrop,
                         q, e, q2, e2) -> bool:
    """True when every pair can run on the two-piece strips route (score
    mode; the envelope of ``wavefront_strips.strips_extd_eligible``)."""
    if not (int(flag) & int(Flag.SCORE_ONLY)):
        return False
    return strips_extd_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop,
                                         q, e, q2, e2) is None


def strips_exts_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop, q, e,
                                  q2, junc_any: bool = False,
                                  junc_bonus: int = 0) -> Optional[str]:
    """Why a splice bucket cannot run on the strips route, or None:
    ``strips_walker.strips_exts_eligible`` without its TPU cost model.
    It refuses EQX and EXTZ_ONLY, any junction track in the bucket and
    any ``junc_bonus``, a negative ``q2`` and degenerate scoring; then
    the one-piece envelope, checked in score mode."""
    f = int(flag)
    if f & (int(Flag.EQX) | int(Flag.EXTZ_ONLY)):
        return "EQX or EXTZ_ONLY (strips_walker.py:733-734)"
    if junc_any or junc_bonus:
        return ("junction tracks or a junc_bonus (strips_walker.py:"
                "735-736)")
    if int(q2) < 0:
        return "a negative intron open q2"
    if -int(np.asarray(mat).reshape(-1)[1:].min()) > 2 * (int(q) + int(e)):
        return "degenerate scoring"
    return strips_ineligible_reason(qlen, tlen, w, f | int(Flag.SCORE_ONLY),
                                    m, mat, zdrop, q, e)


def make_params(m, mat, q, e, zdrop, flag, tv, cig=False, two=False,
                q2=0, e2=0, spl=False) -> StripParams:
    """A launch's params; two-piece callers pass PRE-swap costs, splice
    callers the intron open ``q2``.  A splice launch's site costs travel
    in its donor and acceptor rows (``Launch.don`` / ``acc``), so the JAX
    params' ``semi`` and ``non`` have no field here."""
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    q, e = int(q), int(e)
    lt = ld = off0 = 0
    if two:
        q, e, q2, e2, off0 = canonical_costs(q, e, q2, e2)
        lt, ld = long_params(q, e, q2, e2)
    elif spl:
        e2 = 0                   # exts: strips_walker.py:815-818
        lt, ld = long_params(q, e, q2, e2)
    else:
        q2 = e2 = 0
    eN = e2 if two else e
    sc_N = -eN if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    generic = bool(int(flag) & int(Flag.GENERIC_SC))
    return StripParams(
        tv=int(tv), m=int(m), q=q, e=e, mat0=int(mat[0]),
        sc_mis=int(mat[1]), sc_N=sc_N, zdrop=int(zdrop), flag=int(flag),
        matt=tuple(int(v) for v in mat) if generic else (),
        two=int(bool(two)), q2=int(q2), e2=int(e2), lt=lt, ld=ld,
        off0=off0, cig=int(bool(cig)), spl=int(bool(spl)))


def score_table(prm: StripParams) -> np.ndarray:
    """(m*m,) int32 score of (target symbol, query symbol): the full
    matrix under GENERIC_SC, else match / mismatch with the wildcard
    scoring sc_N (ksw2_extz2_sse.c:125-144)."""
    m = prm.m
    if prm.matt:
        return np.asarray(prm.matt, np.int32).copy()
    t = np.full((m, m), prm.sc_mis, np.int32)
    np.fill_diagonal(t, prm.mat0)
    t[m - 1, :] = prm.sc_N
    t[:, m - 1] = prm.sc_N
    return t.reshape(-1)


def strips_prep(query, target, qlen, tlen, m, mat, q, e, zdrop, flag,
                cig: bool = False, two: bool = False, q2: int = 0,
                e2: int = 0, spl: bool = False,
                noncan: int = 0) -> List[Launch]:
    """Plan and pad one bucket's launches (host only, no device work).

    ``query``/``target`` are lists of per-job 1-D symbol arrays.  A
    launch holds as many pairs as fit in ``LAUNCH_BYTES`` of outputs;
    its query width is the launch's longest query (rounded to 32) and
    its target capacity the canonical ``tv``.  Two-piece callers pass
    PRE-swap costs; splice (``spl``) launches carry their donor and
    acceptor rows.  Callers must have checked eligibility.
    """
    from .splice import splice_profiles

    qlen = np.asarray(qlen, np.int32)
    tlen = np.asarray(tlen, np.int32)
    B = len(query)
    Lq = round_up(int(qlen.max()), 32)
    tv = _canon_tlenp(int(tlen.max()))
    per_pair = 12 * (Lq + tv) + (tv * Lq if cig else 0) + (4 * tv if spl
                                                            else 0)
    bmax = max(1, LAUNCH_BYTES // per_pair)
    prm = make_params(m, mat, q, e, zdrop, flag, tv, cig, two, q2, e2, spl)
    launches = []
    for i0 in range(0, B, bmax):
        ql = qlen[i0:i0 + bmax]
        tl = tlen[i0:i0 + bmax]
        qpad = np.zeros((len(ql), Lq), np.uint8)
        tpad = np.zeros((len(ql), tv), np.uint8)
        for k in range(len(ql)):
            qpad[k, :ql[k]] = query[i0 + k]
            tpad[k, :tl[k]] = target[i0 + k]
        if max(int(qpad.max()), int(tpad.max())) >= m:
            raise ValueError(f"sequence symbols must be < m = {m}")
        don = acc = None
        if spl:
            # the JAX strips kernel's site classes: unwrapped values
            don, acc = splice_profiles(tpad, tl, tv, noncan, flag,
                                       wrap=False)
        launches.append(Launch(prm, qpad, tpad, ql.copy(), tl.copy(), don,
                               acc))
    return launches


def strips_exts_prep(query, target, qlen, tlen, m, mat, q, e, q2, noncan,
                     zdrop, flag, cig: bool = True) -> List[Launch]:
    """The splice bucket's launches (``strips_walker.py:
    strips_exts_cigar_prep``): the one-piece plan with ``spl`` params and
    each pair's donor and acceptor rows, uploaded with the launch."""
    return strips_prep(query, target, qlen, tlen, m, mat, q, e, zdrop, flag,
                       cig=cig, q2=q2, spl=True, noncan=noncan)


# --------------------------------------------------------------------------
# Kernel A: the forward, its plain version and its wrapper


def boundary_h(prm: StripParams, i):
    """H(i, -1) (and H(-1, i)): the reference's virtual boundary.  One-
    piece: -(q + e + e*i).  Two-piece: -e steps until long_thres,
    long_diff at it, -e2 after (ksw2_extd2_sse.c:156-163); splice: the
    same with e2 = 0, flat after long_thres (ksw2_exts2_sse.c:179-181).
    ``i`` is an int or an int32 tensor."""
    early = -(prm.q + prm.e + prm.e * i)
    if not (prm.two or prm.spl):
        return early
    late = (-(prm.q + prm.e + prm.e * (prm.lt - 1)) + prm.ld
            - prm.e2 * (i - prm.lt))
    if isinstance(i, torch.Tensor):
        return torch.where(i < prm.lt, early, late)
    return early if i < prm.lt else late


def _chain(seed: int, A, j, e: int):
    """One F prefix chain along the row: ``max(seed, max_{k<j} A(k)) -
    j*e`` (spec/strips.py:17-21), with ``torch.cummax`` for the scan."""
    B = A.shape[0]
    s = torch.full((B, 1), seed, dtype=A.dtype, device=A.device)
    return torch.cummax(torch.cat([s, A[:, :-1]], dim=1), dim=1).values \
        - j * e


def strips_forward_plain(qs, ts, qlen, tlen, table, prm: StripParams,
                         sites=None):
    """Plain PyTorch version of ``csrc/strips_fwd.cu`` (same inputs and
    outputs): batched over the pairs, one Python step per target row,
    ``torch.cummax`` for the F prefix scans and ``scatter_reduce`` for D.

    Two-piece rows (``spec/strips_extd.py``): ``hnof = max(M, E, E2)``;
    F opens from ``min(hnof, cv)``; ``Hc1 = min(max(hnof, F), cv)``; F2
    opens from Hc1 with (q2, e2); ``H = min(max(Hc1, F2), cv)``.  With
    ``cig`` a third chain ``Fb``, opened from the full clamped H, gives
    the bytes the DP's own F (``spec/strips_cigar.py:181-187``).

    Splice rows (``spl``; ``sites`` = the (B, tv) donor and acceptor
    rows): ``hnof = max(M, E, NI + va(i))``, no clamp, ``H = max(hnof,
    F)``, ``NI' = max(NI, H + vd(i) - q2)`` (``spec/strips_cigar.py:
    strips_exts_cigar``).
    """
    dev = qs.device
    i32 = torch.int32
    B, Lq = qs.shape
    tv = ts.shape[1]
    nd = Lq + tv
    KB, _ = key_params(prm.tv)
    m, q, e, mat0 = prm.m, prm.q, prm.e, prm.mat0
    q2, e2 = prm.q2, prm.e2
    two, spl = bool(prm.two), bool(prm.spl)
    gapoe, gapoe2 = q + e, q2 + e2
    right = bool(prm.flag & int(Flag.RIGHT))
    j = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    qlc = qlen.to(i32)[:, None]
    tlc = tlen.to(i32)[:, None]
    jmask = j < qlc
    qsl = qs.long()
    tab = table.to(device=dev, dtype=i32)
    rows = torch.arange(B, device=dev)
    qlast = (qlen.long() - 1).clamp(min=0)

    H = boundary_h(prm, j).expand(B, Lq).clone()     # H(-1, j)
    E = H - gapoe
    E2 = H - gapoe2 if two else None
    if spl:
        NI = H - q2
        vdon, vacc = (x.to(device=dev, dtype=i32) for x in sites)
    D = torch.full((B, nd + 1), SENT, dtype=i32, device=dev)  # +1: sink
    Dq = torch.full((B, nd), SENT, dtype=i32, device=dev)
    hl = torch.full((B, Lq), SENT, dtype=i32, device=dev)
    d8 = (torch.zeros((B, tv, Lq), dtype=torch.uint8, device=dev)
          if prm.cig else None)
    for i in range(int(tlen.max())):
        sc = tab[ts[:, i].long()[:, None] * m + qsl]
        hb = 0 if i == 0 else boundary_h(prm, i - 1)
        ci = boundary_h(prm, i)                      # H(i, -1)
        Hd = torch.cat([torch.full((B, 1), hb, dtype=i32, device=dev),
                        H[:, :-1]], dim=1)
        Mv = Hd + sc
        hnof = torch.maximum(Mv, E)
        if two:
            hnof = torch.maximum(hnof, E2)
        if spl:
            vd, va = vdon[:, i:i + 1], vacc[:, i:i + 1]
            cand3 = NI + va
            hnof = torch.maximum(hnof, cand3)
        cv = Hd + mat0
        hnofc = hnof if spl else torch.minimum(hnof, cv)
        F = _chain(ci - gapoe, hnofc + j * e - q, j, e)
        if two:
            Hc1 = torch.minimum(torch.maximum(hnof, F), cv)
            F2 = _chain(ci - gapoe2, Hc1 + j * e2 - q2, j, e2)
            Hn = torch.minimum(torch.maximum(Hc1, F2), cv)
        elif spl:
            Hn = torch.maximum(hnof, F)              # exts: no clamp
        else:
            Hn = torch.minimum(torch.maximum(hnof, F), cv)
        En = torch.maximum(E - e, Hn - gapoe)
        if prm.cig:
            # argmax in candidate order M, E, F, E2, F2 on the unclamped
            # values; continuation bits against the clamped H
            # (wavefront_strips.py:289-340)
            Fb = _chain(ci - gapoe, Hn + j * e - q, j, e) if two else F
            z = torch.maximum(Mv, E)
            if right:
                d = torch.where(Mv > E, 0, 1)
                d = torch.where(z > Fb, d, 2)
                if two:
                    z = torch.maximum(z, Fb)
                    d = torch.where(z > E2, d, 3)
                    z = torch.maximum(z, E2)
                    d = torch.where(z > F2, d, 4)
                if spl:
                    d = torch.where(torch.maximum(z, Fb) > cand3, d, 3)
                ca, cb = E >= Hn - q, Fb >= Hn - q
            else:
                d = torch.where(E > Mv, 1, 0)
                d = torch.where(Fb > z, 2, d)
                if two:
                    z = torch.maximum(z, Fb)
                    d = torch.where(E2 > z, 3, d)
                    z = torch.maximum(z, E2)
                    d = torch.where(F2 > z, 4, d)
                if spl:
                    d = torch.where(cand3 > torch.maximum(z, Fb), 3, d)
                ca, cb = E > Hn - q, Fb > Hn - q
            d = d | torch.where(ca, 0x08, 0) | torch.where(cb, 0x10, 0)
            if two:
                if right:
                    ca2, cb2 = E2 >= Hn - q2, F2 >= Hn - q2
                else:
                    ca2, cb2 = E2 > Hn - q2, F2 > Hn - q2
                d = d | torch.where(ca2, 0x20, 0) | torch.where(cb2, 0x40, 0)
            if spl:
                # 0x20: the intron continues (wavefront_strips.py:341-347)
                cd = NI + q2 - Hn
                cd = cd >= vd if right else cd > vd
                d = d | torch.where(cd, 0x20, 0)
            d8[:, i] = d.to(torch.uint8)
        if two:
            E2 = torch.maximum(E2 - e2, Hn - gapoe2)
        if spl:
            NI = torch.maximum(NI, Hn + vd - q2)
        live = jmask & (i < tlc)
        r = i + j
        st0 = torch.clamp(r - qlc + 1, min=0)
        en0 = torch.minimum(tlc - 1, r)
        en1 = st0 + ((en0 - st0) & -4)
        kf = torch.where(i < en1, ((i - st0) & 3) * prm.tv + i + 1,
                         4 * prm.tv + i + 1)
        kf = torch.where(en0 == i, 0, kf)
        packed = Hn * KB + (KB - 1 - kf)
        idx = torch.where(live, r, nd).long()
        D.scatter_reduce_(1, idx, torch.where(live, packed, SENT), "amax")
        rl = rows[tlen > i]
        Dq[rl, i + qlast[rl]] = Hn[rl, qlast[rl]]
        last = rows[tlen == i + 1]
        hl[last] = torch.where(jmask[last], Hn[last], SENT)
        H, E = Hn, En
    return D[:, :nd].contiguous(), Dq, hl, d8


def _check_cuda(t: torch.Tensor, dtype, shape, name: str,
                dev: Optional[torch.device] = None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if dev is not None and t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the launch on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fwd_smem_bytes(Lq: int, tv: int, prm: StripParams) -> int:
    """Dynamic shared memory of one kernel-A block (the layout at the
    head of ``csrc/strips_fwd.cu``): D, two H rows, E, the score table,
    the scans' warp totals and the query; two-piece adds E2 and one row
    of scratch and a warp-total array per extra scan, splice the NI
    row."""
    if not prm.two:
        return 4 * (Lq + tv + (4 if prm.spl else 3) * Lq + 64 + 32) + Lq
    nscan = 3 if prm.cig else 2
    return 4 * (Lq + tv + 5 * Lq + 64 + 32 * nscan) + Lq


def strips_forward_cuda(qs, ts, qlen, tlen, table, prm: StripParams,
                        sites=None):
    """Launch ``csrc/strips_fwd.cu`` on the current stream; same
    contract as :func:`strips_forward_plain` (outputs from torch.empty:
    d8 cells outside a pair's (tlen, qlen) are left unwritten)."""
    B, Lq = qs.shape
    tv = prm.tv
    nd = Lq + tv
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, tv), "target", dev)
    _check_cuda(qlen, torch.int32, (B,), "qlen", dev)
    _check_cuda(tlen, torch.int32, (B,), "tlen", dev)
    _check_cuda(table, torch.int32, (prm.m * prm.m,), "table", dev)
    if prm.m > 8:
        raise ValueError("the forward kernel takes m <= 8")
    don = acc = None
    if prm.spl:
        if sites is None:
            raise ValueError("a splice launch needs its donor/acceptor rows")
        don, acc = sites
        _check_cuda(don, torch.int16, (B, tv), "donor rows", dev)
        _check_cuda(acc, torch.int16, (B, tv), "acceptor rows", dev)
    smem = fwd_smem_bytes(Lq, tv, prm)
    if smem > SMEM_MAX:
        raise ValueError(f"launch needs {smem} B of shared memory")
    D = torch.empty((B, nd), dtype=torch.int32, device=dev)
    Dq = torch.empty((B, nd), dtype=torch.int32, device=dev)
    hl = torch.empty((B, Lq), dtype=torch.int32, device=dev)
    d8 = (torch.empty((B, tv, Lq), dtype=torch.uint8, device=dev)
          if prm.cig else None)
    KB, _ = key_params(tv)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_strips_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            table.data_ptr(), don.data_ptr() if prm.spl else None,
            acc.data_ptr() if prm.spl else None, B, Lq, tv, prm.m, prm.q,
            prm.e, prm.q2, prm.e2, prm.lt, prm.ld, prm.mat0, KB,
            int(bool(prm.flag & int(Flag.RIGHT))), prm.cig, prm.two,
            prm.spl, min(512, round_up(Lq, 32)),
            D.data_ptr(), Dq.data_ptr(), hl.data_ptr(),
            d8.data_ptr() if d8 is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "strips_fwd")
    LAUNCHES["strips_fwd"] += 1
    return D, Dq, hl, d8


def strips_forward(qs, ts, qlen, tlen, table, prm: StripParams,
                   sites=None):
    """The forward on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``sites`` are a splice
    launch's donor and acceptor rows (:func:`site_rows`)."""
    if qs.is_cuda:
        return strips_forward_cuda(qs, ts, qlen, tlen, table, prm, sites)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return strips_forward_plain(qs, ts, qlen, tlen, table, prm, sites)


# --------------------------------------------------------------------------
# Record replay (plain tensor code on either device)


def replay_records(prm: StripParams, D, Dq, hl, qlen, tlen):
    """Replay the per-diagonal ez automaton from the record streams.

    D, Dq: (B, ND) over global diagonals; hl: (B, Lq); qlen/tlen: (B,)
    int32.  Returns (B, 9) int32 records in ``FIELD_ORDER``.  Mirrors
    ``spec/strips.py:replay_records`` (mte -> mqe -> zdrop order,
    strict-``>`` automaton, ``mte_q = r - en`` 16-rounding quirk).  Two-
    piece launches add ``off0`` to every live H and drop with the e2
    slope (``wavefront_strips.py:497, 533-540, 563-576``).
    """
    dev = D.device
    i32 = torch.int32
    B, ND = D.shape
    KB, KBITS = key_params(prm.tv)
    qlc = qlen.to(i32)[:, None]
    tlc = tlen.to(i32)[:, None]
    r = torch.arange(ND, dtype=i32, device=dev)[None, :]
    ndc = qlc + tlc - 1
    valid = (r < ndc) & (qlc > 0) & (tlc > 0)

    M = (D >> KBITS) + prm.off0        # extd pre-swap H-seed offset
    kstar = (KB - 1) - (D & (KB - 1))
    en0 = torch.minimum(tlc - 1, r)
    j1 = torch.remainder(kstar - 1, prm.tv)
    maxt = torch.where(kstar == 0, en0,
                       torch.where(kstar <= 4 * prm.tv, j1,
                                   kstar - 1 - 4 * prm.tv))

    # running max (strict >, earliest diagonal wins): the key packs
    # (M, 8191 - r), unique per diagonal, so cummax's index picks maxt
    Mc = torch.clamp(M, min=-(1 << 17))
    key = torch.where(valid, Mc * 8192 + (8191 - r), SENT)
    ks, arg = torch.cummax(key, dim=1)
    vs = torch.gather(maxt, 1, arg)
    bestM = ks >> 13
    rstar = 8191 - (ks & 8191)
    pos = bestM > 0
    mx = torch.where(pos, bestM, 0)
    mt = torch.where(pos, vs, -1)
    mq = torch.where(pos, rstar - vs, -1)
    # automaton state *before* each diagonal
    zero = torch.zeros((B, 1), dtype=i32, device=dev)
    mxp = torch.cat([zero, mx[:, :-1]], dim=1)
    mtp = torch.cat([zero - 1, mt[:, :-1]], dim=1)
    mqp = torch.cat([zero - 1, mq[:, :-1]], dim=1)

    BIG = 2 ** 30
    # Z-drop gap slope: e2 for extd (ksw2_extd2_sse.c:364), 0 for exts
    # (ksw2_exts2_sse.c:395-398), e one-piece
    ze = 0 if prm.spl else (prm.e2 if prm.two else prm.e)
    if prm.zdrop >= 0:
        ln = torch.abs((maxt - mtp) - ((r - maxt) - mqp))
        trig = (valid & ~(M > mxp) & (maxt >= mtp) & ((r - maxt) >= mqp)
                & ((mxp - M) > prm.zdrop + ln * ze))
        rdrop = torch.where(trig, r, BIG).min(dim=1).values
        dropped = rdrop < BIG
    else:
        rdrop = torch.full((B,), BIG, dtype=i32, device=dev)
        dropped = torch.zeros((B,), dtype=torch.bool, device=dev)
    rc = torch.where(dropped, rdrop, ndc[:, 0] - 1)
    rcc = rc[:, None]

    # automaton state after diagonal rc
    rci = torch.clamp(rcc, 0, ND - 1).long()
    kc = torch.gather(ks, 1, rci)[:, 0]
    vc = torch.gather(vs, 1, rci)[:, 0]
    bestMc = kc >> 13
    rstarc = 8191 - (kc & 8191)
    posc = bestMc > 0
    vmax = torch.where(posc, bestMc, 0)
    vmaxt = torch.where(posc, vc, -1)
    vmaxq = torch.where(posc, rstarc - vc, -1)
    kmask = (r <= rcc) & valid

    # mqe: query-end H per diagonal; earliest diagonal wins ties
    # (off0 only on live records: SENT + off0 would wrap int32)
    hasdq = Dq > SENT // 2
    Dq = torch.where(hasdq, Dq + prm.off0, Dq)
    qpk = torch.where(kmask & hasdq,
                      torch.clamp(Dq, min=-(1 << 17)) * 8192 + (8191 - r),
                      SENT)
    qb = qpk.max(dim=1).values
    hasq = qb > SENT // 2
    mqe = torch.where(hasq, qb >> 13, NEG_INF)
    mqet = torch.where(hasq, (8191 - (qb & 8191)) - (qlc[:, 0] - 1), -1)

    # mte from the last-row capture; mte_q keeps the 16-rounded `r - en`
    # quirk (ksw2_extz2_sse.c:264)
    jl = torch.arange(hl.shape[1], dtype=i32, device=dev)[None, :]
    hl = torch.where(hl > SENT // 2, hl + prm.off0, hl)
    tmask = ((jl <= rcc - (tlc - 1)) & (jl < qlc) & (tlc > 0)
             & (hl > SENT // 2))
    pt = torch.where(tmask,
                     torch.clamp(hl, min=-(1 << 17)) * 8192 + (8191 - jl),
                     SENT)
    tb = pt.max(dim=1).values
    hast = tb > SENT // 2
    jstar = 8191 - (tb & 8191)
    en_c = ((tlc[:, 0] + 15) & -16) - 1
    mte = torch.where(hast, tb >> 13, NEG_INF)
    mteq = torch.where(hast, (tlc[:, 0] - 1 + jstar) - en_c, -1)

    hq = torch.where(jl == qlc - 1, hl, 0).sum(dim=1, dtype=i32)
    done = ~dropped & (qlc[:, 0] > 0) & (tlc[:, 0] > 0)
    score = torch.where(done, hq, NEG_INF)
    return torch.stack([vmax, vmaxt, vmaxq, mqe, mqet, mte, mteq, score,
                        dropped.to(i32)], dim=1).to(i32)


# --------------------------------------------------------------------------
# One launch end to end


def upload(launch: Launch, device):
    """The launch's inputs (query, target, qlen, tlen, score table) as
    tensors on ``device``.  CUDA uploads are staged through pinned
    memory: a copy from pageable memory first waits for all work already
    queued on the stream, which would serialise the batches that
    ``extend_batch_async`` keeps in flight."""
    dev = torch.device(device)
    host = [torch.from_numpy(a) for a in (
        launch.query, launch.target, launch.qlen, launch.tlen,
        score_table(launch.prm))]
    if dev.type != "cuda":
        return tuple(host)
    return tuple(t.pin_memory().to(dev, non_blocking=True) for t in host)


def site_rows(launch: Launch, device):
    """A splice launch's (donor, acceptor) rows on ``device``, staged as
    :func:`upload` stages; None for other launches."""
    if not launch.prm.spl:
        return None
    rows = [torch.from_numpy(a) for a in (launch.don, launch.acc)]
    if torch.device(device).type != "cuda":
        return tuple(rows)
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in rows)


def strips_records(launch: Launch, device):
    """Forward + replay of one score launch; (B, 9) int32 records on
    ``device`` (enqueued, not synchronised)."""
    qs, ts, ql, tl, table = upload(launch, device)
    D, Dq, hl, _ = strips_forward(qs, ts, ql, tl, table, launch.prm,
                                  site_rows(launch, device))
    return replay_records(launch.prm, D, Dq, hl, ql, tl)


__all__ = ["StripParams", "Launch", "SENT", "QMAX", "TMAX",
           "TLENP_LADDER", "key_params", "strips_eligible",
           "strips_ineligible_reason", "long_params", "canonical_costs",
           "strips_extd_eligible", "strips_extd_ineligible_reason",
           "strips_exts_ineligible_reason", "make_params", "score_table",
           "strips_prep", "strips_exts_prep", "boundary_h",
           "fwd_smem_bytes", "strips_forward", "strips_forward_plain",
           "strips_forward_cuda", "replay_records", "upload", "site_rows",
           "strips_records"]
