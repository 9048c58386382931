"""Kernel 6's register form, modelled, and its wide form's layout.

Kernel 6 (the batched exts forward of the splice route) has two forms
that ``ops.batch_exts.exts_form`` picks from a launch's ``ncol``: the
register form, kernel E's register kernel in ``csrc/batch_fwd.cu`` in
its ``SPL`` mode, and the wide form, the band forward's block a pair
(``csrc/band_fwd.cu`` in its ``SPL`` mode) at ``exts_wide_layout``, for
launches the window cannot hold and alphabets of more than 8 symbols.  The register form keeps a pair's state
in a window of ``32 * cpl`` target positions (cpl 16: 512 positions),
lane l holding positions base + cpl l .. base + cpl l + cpl - 1 in
registers, base = ``window_base(st)``: the planes u, v, x, y and
the intron plane x2 (initialised to -q2), H, the score bytes, and the
positions' target, donor and acceptor bytes.  The window slides up 32
positions when st - 1 passes the next multiple of 32; the positions that
enter are fresh (init bytes, their target, donor and acceptor bytes,
score 0, H NEG), and a query symbol enters at the bottom each diagonal
from 64 symbols staged a group of 32 diagonals.  A diagonal reads t -
1's old state from its own registers (one shuffle a plane for a lane's
first cell), switches the first column (``ucol(r)``) and the edge
entering st (``prevok``), takes the intron candidate a2 + acceptor with
no clamp of z and x2' = max(a2', donor) - q2.  Lane j keeps diagonal r_lo
+ j's maximum and position (or the H0 walk's), H(st0) and H(en0), and at
the group's end the warp replays Z-drop (no gap slope), mqe / mte and the
score in order; the first diagonal that drops is the stop, and the
store's rows the warp wrote past it are zeroed.  The warp ranks a
diagonal's cells for its best position only where the replay reads it:
where the diagonal's maximum beats the running one or falls more than
zdrop below it.  With CIG a cell's direction code rides in the low bits
of the top-byte candidates, a priority each.

The NumPy model below has the window, slides, staging, substitutions,
the donor / acceptor / x2 planes and the group capture and replay.  It
asserts that every read and write of a diagonal falls inside the window,
that a fresh position's query symbol is never used, that a group slides
at most once and that its staged query covers each diagonal, and it
holds the records and every store byte exactly to the plain twin
``ops.batch_exts.batch_exts_forward_plain``: on the splice workload's
launch, on the edge cases of ``chip_smoke.splice_cases`` (RIGHT,
SPLICE_REV with SPLICE_FLANK, GENERIC_SC, junction tracks with
junc_bonus 9, APPROX, Z-drop -1 / 30 / 200), on Z-drops at a group's
edges and on launches at the form's window edges.  The host's form rule
is tested for every ``ncol`` the splice route can send, and so is the
wide form's layout: tiles of 64 positions and at most 26 compute warps
(the band kernel's bound), shared memory within a block's, a warp's next
tile starting after its last ends on the widest unbanded pairs of each
``ncol``; an ``ncol`` it cannot take raises before any launch.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
import refcmp
from ksw2_tpu.core.matrix import encode_dna

from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import batch as BT
from ksw2_tpu_torch.ops import batch_exts as BE
from ksw2_tpu_torch.ops.strips import SMEM_MAX
from ksw2_tpu_torch.ops.bands import n_col_bytes

torch.set_num_threads(1)

NEG = -0x40000000
KT = 4096
KD = 32
INT_MIN = -(1 << 31)
SPL = Flag.SPLICE_FOR
SO = Flag.SCORE_ONLY
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP


def w8(x):
    return ((np.asarray(x) + 128) & 255) - 128


def band_row(r, qlen, tlen):
    st0 = max(0, r - qlen + 1)
    en0 = min(tlen - 1, r)
    return st0, en0, st0 & ~15, en0 | 15


def sse_rank(t, st0, en0):
    rel = t - st0
    en1 = st0 + ((en0 - st0) & ~3)
    if t == en0:
        return 0
    return (rel & 3) * KT + rel + 1 if t < en1 else 4 * KT + rel + 1


def _first_max(a, b):
    """ksw_apply_zdrop's running maximum: the later element ``b`` wins
    only when strictly greater (elements are (value, t, r))."""
    return b if b[0] > a[0] else a


def model_pair(q, t, don, acc, prm, nd, ncol, cpl, stats):
    """One pair through the register form as csrc/batch_fwd.cu runs it in
    its SPL mode: (the 9 record fields, the pair's (nd, ncol) store or
    None).  ``don`` and ``acc`` are the launch's rows (Lt int8)."""
    qlen, tlen = len(q), len(t)
    Lt = len(don)
    W = 32 * cpl
    flag = prm.flag
    approx = bool(flag & Flag.APPROX_MAX)
    adrop = approx and bool(flag & Flag.APPROX_DROP)
    right = bool(flag & Flag.RIGHT)
    generic = bool(flag & Flag.GENERIC_SC)
    m, qq, e, q2 = prm.m, prm.q, prm.e, prm.q2
    qe = qq + e
    init, init2 = int(w8(-qe)), int(w8(-q2))
    ndb = qlen + tlen - 1
    assert n_col_bytes(qlen, tlen, qlen + tlen) <= ncol
    assert BE.exts_form(ncol, m) == cpl
    table = np.asarray(prm.matt or [0] * (m * m), np.int64)

    def row_at(a, pos, lim):
        pos = np.asarray(pos)
        return np.where(pos < lim, np.asarray(a, np.int64)[
            np.minimum(pos, lim - 1)], 0)

    def qsym(i):
        return int(q[i]) if 0 <= i < qlen else 0

    def score(T, Q):
        if generic:
            return w8(table[T * m + Q])
        s = np.where(T == Q, prm.sc_mch, prm.sc_mis)
        return w8(np.where((T == m - 1) | (Q == m - 1), prm.sc_N, s))

    slots = np.arange(W)
    base = 0
    U = np.full(W, init, np.int64)
    V, X, Y = U.copy(), U.copy(), U.copy()
    X2 = np.full(W, init2, np.int64)
    H = np.full(W, NEG, np.int64)
    H[0] = -qe                               # the seed r = 0 reads
    S = np.zeros(W, np.int64)
    T = row_at(t, slots, tlen)
    DN = row_at(don, slots, Lt)
    AC = row_at(acc, slots, Lt)
    SEL = np.zeros(W, np.int64)              # diagonal -1's: query -1 - t
    poison = np.zeros(W, bool)               # a fresh position's selector
    p = np.zeros((nd, ncol), np.uint8) if prm.cig else None
    mx, mt, mq = 0, -1, -1
    mqe, mqet, mte, mteq, sc, zd = NEG, -1, NEG, -1, NEG, 0
    last_st = last_en = -1
    H0 = lt0 = 0
    for r_lo in range(0, ndb, KD):
        r_hi = min(r_lo + KD - 1, ndb - 1)
        n = r_hi - r_lo + 1
        base_lo = BT.window_base(band_row(r_lo, qlen, tlen)[2])
        q0 = r_lo - base_lo
        stage = [qsym(q0 - 32 + i) for i in range(64)]
        gH, gT, gS, gE = ([0] * KD for _ in range(4))
        run = mx                             # the running maximum
        slid = 0
        for rr in range(n):
            r = r_lo + rr
            st0, en0, st, en = band_row(r, qlen, tlen)
            nb = BT.window_base(st)
            if nb != base:
                # the slide: 32 positions (32 / cpl lanes) down, fresh on
                # top with their target, donor and acceptor bytes
                assert nb == base + 32
                slid += 1
                stats["slides"] += 1
                for arr in (U, V, X, Y, X2, H, S, T, DN, AC, SEL, poison):
                    arr[:-32] = arr[32:].copy()
                for arr in (U, V, X, Y):
                    arr[-32:] = init
                X2[-32:] = init2
                H[-32:] = NEG
                S[-32:] = 0
                fresh = nb + W - 32 + np.arange(32)
                T[-32:] = row_at(t, fresh, tlen)
                DN[-32:] = row_at(don, fresh, Lt)
                AC[-32:] = row_at(acc, fresh, Lt)
                SEL[-32:] = 0
                poison[-32:] = True
                base = nb
            top = base + W - 1
            # the window holds st - 1 and en0 + 15 (>= en, hi)
            assert base <= max(st - 1, 0) and en0 + 15 <= top
            assert (st - base) % cpl == 0 and (en + 1 - base) % cpl == 0
            assert en - st + 1 <= ncol
            idx = r - base - (q0 - 32)
            assert 0 <= idx < 64 and stage[idx] == qsym(r - base)
            SEL[1:] = SEL[:-1].copy()
            poison[1:] = poison[:-1].copy()
            SEL[0] = stage[idx]
            poison[0] = False
            prevok = st > 0 and last_st <= st - 1 <= last_en
            colv = int(w8(-qe if r == 0 else (-e if r < prm.lt else (
                prm.ld if r == prm.lt else 0))))
            hi = en0 if generic else st0 + ((en0 - st0) & ~15) + 15
            f = slice(st0 - base, hi - base + 1)
            assert hi <= top and not poison[f].any()
            S[f] = score(T[f], SEL[f])
            if r <= en:                      # the first column, t == r
                c = r - base
                U[c], Y[c] = colv, init
            s0 = st - base
            Xm, Vm, X2m, Hm = (np.roll(a, 1) for a in (X, V, X2, H))
            assert prevok or st == 0 or s0 >= 1
            if not prevok:
                Xm[s0] = init
                Vm[s0] = colv if st == 0 else init
                X2m[s0] = init2
            b = slice(s0, en - base + 1)
            X1, V1, X21 = Xm[b], Vm[b], X2m[b]
            Uc, Yc, Dn, Ac = U[b], Y[b], DN[b], AC[b]
            a, bb, a2 = w8(X1 + V1), w8(Yc + Uc), w8(X21 + V1)
            z = S[b].copy()
            d = np.zeros_like(z)
            cands = (z, a, bb, w8(a2 + Ac))
            for cand, code in zip(cands[1:], (1, 2, 3)):
                d = np.where(z > cand, d, code) if right else \
                    np.where(cand > z, code, d)
                z = np.maximum(z, cand)
            # the kernel's form: each candidate in the top byte, its
            # priority in the low bits
            pri = (0, 1, 2, 3) if right else (3, 2, 1, 0)
            zp = np.maximum.reduce([v * (1 << 24) + p_ for v, p_ in
                                    zip(cands, pri)])
            assert np.array_equal(zp >> 24, z)
            assert np.array_equal(zp & 3 if right else (zp & 3) ^ 3, d)
            un, vn = w8(z - V1), w8(z - Uc)
            t1 = w8(z - qq)
            a, bb = w8(a - t1), w8(bb - t1)
            a2 = w8(a2 - w8(z - q2))
            for val, ref, bit in ((a, 0, 0x08), (bb, 0, 0x10), (a2, Dn, 0x20)):
                d = d | ((val >= ref) if right else (val > ref)) * bit
            X[b] = w8(np.maximum(a, 0) - qe)
            Y[b] = w8(np.maximum(bb, 0) - qe)
            X2[b] = w8(np.maximum(a2, Dn) - q2)
            U[b], V[b] = un, vn
            if prm.cig:
                p[r, :en - st + 1] = d
            if not approx:
                # the H row over [st0, en0]; en0 reads the older H(en0 - 1)
                hb = slice(st0 - base, en0 - base + 1)
                rel = slice(st0 - st, en0 - st + 1)
                hn = H[hb] + vn[rel]
                if en0 > 0:
                    hn[-1] = Hm[en0 - base] + un[en0 - st]
                H[hb] = hn
                hm = int(hn.max())
                cands = [st0 + i for i in np.flatnonzero(hn == hm)]
                ranks = [sse_rank(c, st0, en0) for c in cands]
                tw = cands[int(np.argmin(ranks))]
                stats["ties" if len(cands) > 1 else "unique"] += 1
                # the kernel ranks only where the replay reads the position
                need = hm > run or (prm.zdrop >= 0 and run - hm > prm.zdrop)
                stats["ranked" if need else "skipped"] += 1
                run = max(run, hm)
                gH[rr], gT[rr] = hm, (tw if need else 0)
                gS[rr], gE[rr] = int(hn[0]), int(hn[-1])
            else:
                if r == 0:
                    H0, lt0 = int(V[0 - base]) - qe, 0
                else:
                    c1 = st0 <= lt0 <= en0
                    c2 = st0 <= lt0 + 1 <= en0
                    d0 = int(V[lt0 - base]) if c1 else 0
                    d1 = int(U[lt0 + 1 - base]) if c2 else 0
                    if c1 and c2:
                        if d0 > d1:
                            H0 += d0
                        else:
                            H0 += d1
                            lt0 += 1
                    elif c1:
                        H0 += d0
                    else:
                        H0 += d1
                        lt0 += 1
                gH[rr], gT[rr] = H0, lt0
            last_st, last_en = st, en
        assert slid <= 1
        stats["groups"] += 1
        # the replay: lane j holds diagonal r_lo + j; no gap slope
        rs = [r_lo + j for j in range(KD)]
        contrib = [j < n and (not approx or adrop) for j in range(KD)]
        el = [(gH[j], gT[j], rs[j]) if contrib[j] else (INT_MIN, 0, 0)
              for j in range(KD)]
        inc = list(el)
        o = 1
        while o < KD:                        # 5 rounds of shuffles
            inc = [_first_max(inc[j - o], inc[j]) if j >= o else inc[j]
                   for j in range(KD)]
            o *= 2
        carry = (mx, mt, mt + mq)            # (value, t, r): mq = r - t
        drops = []
        for j in range(KD):
            excl = inc[j - 1] if j else (INT_MIN, 0, 0)
            pv, pt, pr = _first_max(carry, excl)
            v, tt, r = el[j]
            drops.append(contrib[j] and prm.zdrop >= 0 and not v > pv and
                         tt >= pt and r - tt >= pr - pt and
                         pv - v > prm.zdrop)
        jd = drops.index(True) if True in drops else KD
        last = _first_max(carry, inc[min(jd, n - 1)])
        mx, mt, mq = last[0], last[1], last[2] - last[1]
        for j in range(min(jd + 1, n)):
            st0, en0, _, en = band_row(rs[j], qlen, tlen)
            if not approx and en0 == tlen - 1 and gE[j] > mte:
                mte, mteq = gE[j], rs[j] - en
            if not approx and rs[j] - st0 == qlen - 1 and gS[j] > mqe:
                mqe, mqet = gS[j], st0
            if j < jd and rs[j] == ndb - 1 and en0 == tlen - 1:
                sc = gH[j] if approx else gE[j]
        if jd < n:
            zd = 1
            stats["drops"] += 1
            stats.setdefault("drop_at", []).append((r_lo + jd) % KD)
            if prm.cig:
                p[r_lo + jd + 1:r_hi + 1] = 0    # rows past the stop
            break
    return [mx, mt, mq, mqe, mqet, mte, mteq, sc, zd], p


def model_launch(ln, stats):
    """Every pair of a register-form launch through :func:`model_pair`:
    (rec (B, 9) int32, p (B, nd, ncol) uint8 or None)."""
    cpl = BE.exts_form(ln.ncol, ln.prm.m)
    assert cpl
    don, acc = ln.sites
    recs, ps = [], []
    for k in range(len(ln.qlen)):
        ql, tl = int(ln.qlen[k]), int(ln.tlen[k])
        rec, p = model_pair(ln.query[k, :ql], ln.target[k, :tl], don[k],
                            acc[k], ln.prm, ln.nd, ln.ncol, cpl, stats)
        recs.append(rec)
        ps.append(p)
    rec = torch.tensor(recs, dtype=torch.int32)
    return rec, (torch.from_numpy(np.stack(ps)) if ln.prm.cig else None)


def _stats():
    return dict(slides=0, ties=0, unique=0, groups=0, drops=0, ranked=0,
                skipped=0)


def _check(ln, stats=None):
    """The model against the plain twin on one launch, exactly."""
    stats = stats if stats is not None else _stats()
    args = BD.band_upload(ln, "cpu")
    prec, pp = BE.batch_exts_forward_plain(*args, ln.prm, ln.nd, ln.ncol)
    mrec, mp = model_launch(ln, stats)
    assert torch.equal(mrec, prec)
    if ln.prm.cig:
        assert torch.equal(mp, pp)
    return stats


def _launches(pairs, flag, juncs=None, junc_bonus=0, zdrop=None, mat=None):
    """The scheduler's kernel-6 launches of ``pairs`` (-x splice costs)."""
    return [ln for route, ln in CS.splice_launches(pairs, flag, juncs,
                                                   junc_bonus, zdrop, mat)
            if route == "batch"]


def _pairs(seed, lens, div=0.12, indel=0.04, with_n=False):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=indel,
                                  with_n=with_n)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _empty_tracks(pairs):
    """Empty junction tracks: kernel 6 takes the bucket (the strips
    route declines a track) with no bonus."""
    return [np.zeros(len(t), np.uint8) for _, t in pairs]


@pytest.mark.parametrize("flag", [SPL, SPL | SO], ids=["cig", "score"])
def test_model_splice_workload(flag):
    """The splice workload's launch as the annotated run makes it (its
    256 distinct pairs: the smoke run tiles them 4 times): ncol 320, the
    16-position form; records and bytes equal the plain twin's."""
    spl = CS.splice_jobs()
    (ln,) = _launches(spl, flag, [CS.splice_junc()] * len(spl),
                      CS.SPLICE_JUNC_BONUS)
    assert (ln.ncol, BE.exts_form(ln.ncol, 5)) == (320, 16)
    if flag & SO:
        # the score form's records are the CIG form's: check them on a
        # prefix, the whole launch runs as CIG
        ln = ln._replace(query=ln.query[:32], target=ln.target[:32],
                         qlen=ln.qlen[:32], tlen=ln.tlen[:32], w=ln.w[:32],
                         sites=tuple(s[:32] for s in ln.sites))
    stats = _check(ln)
    assert stats["slides"] > 0 and stats["ties"] > 0
    assert stats["ranked"] > 0 and stats["skipped"] > 0


SMALL_FORMS = [f for f in (
    ("score_z200", SPL | SO, 200, False, None),
    ("cig_z200", SPL, 200, False, None),
    ("cig_right_zm1", SPL | Flag.RIGHT, -1, False, None),
    ("rev_flank_cig_z30", Flag.SPLICE_REV | Flag.SPLICE_FLANK, 30, False,
     None),
    ("generic_cig_z200", SPL | Flag.GENERIC_SC, 200, False, "generic"),
    ("junc_cig_z200", SPL, 200, True, None),
    ("junc_score_right_zm1", SPL | SO | Flag.RIGHT, -1, True, None),
    ("approx_score_zm1", SPL | SO | Flag.APPROX_MAX, -1, False, None),
    ("approxdrop_cig_z100", SPL | APPROX, 100, False, None),
)]


def _small():
    """chip_smoke.splice_cases' seeded pairs (30-900 bp spliced pairs
    with N bases, one-base and 129 bp edge shapes) and their tracks."""
    rng = np.random.default_rng(11)
    small = [CS.spliced_pair(rng, L, with_n=True)
             for L in (30, 120, 512, 700, 900)]
    small += [(rng.integers(0, 5, ql).astype(np.uint8),
               rng.integers(0, 5, tl).astype(np.uint8))
              for ql, tl in ((1, 1), (1, 129), (129, 1), (128, 129))]
    tracks = []
    for _, t in small:
        j = np.zeros(len(t), np.uint8)
        j[len(t) // 3], j[2 * len(t) // 3] = 1, 2
        tracks.append(j)
    return small, tracks


@pytest.mark.parametrize("form", SMALL_FORMS, ids=[f[0] for f in SMALL_FORMS])
def test_model_splice_cases(form):
    """The smoke run's small splice cases (phase 5d): every kernel-6
    launch of the register form equals the plain twin; the launches the
    window cannot hold take the wide form."""
    _, flag, zdrop, junc, mat = form
    small, tracks = _small()
    mat = CS._generic_mat() if mat else None
    lns = _launches(small, flag, tracks if junc else _empty_tracks(small),
                    CS.SPLICE_JUNC_BONUS if junc else 0, zdrop, mat)
    forms = [BE.exts_form(ln.ncol, 5) for ln in lns]
    assert 0 in forms and any(forms)
    for ln, cpl in zip(lns, forms):
        if cpl:
            _check(ln)


@pytest.mark.parametrize("flag", [SPL, SPL | SO, SPL | SO | APPROX],
                         ids=["cig", "score", "approx_score"])
def test_model_drops_at_group_edges(flag):
    """Z-drops on a group's first and last diagonal and in between, and
    in the first group: the stop, every field and the zeroed rows.  The
    plain twin's stops over a sweep of pairs pick the pairs whose drop
    falls on each edge; the model runs on those."""
    rng = np.random.default_rng(200)
    sweep = []
    for A in range(10, 90):
        t, q = refcmp.random_pair(rng, A, divergence=0.04, indel=0.01)
        tail = [("".join(rng.choice(list("ACGT"), size=140))) for _ in "tq"]
        sweep.append((encode_dna(q + tail[1]), encode_dna(t + tail[0])))
    pick = {}
    for ln in _launches(sweep, flag, _empty_tracks(sweep), 0, 20):
        args = BD.band_upload(ln, "cpu")
        rec, _, stop = BE.batch_exts_forward_plain(*args, ln.prm, ln.nd,
                                                   ln.ncol, with_stop=True)
        ndb = ln.qlen.astype(np.int64) + ln.tlen - 1
        dropped = (rec[:, 8].numpy() == 1) & (stop.numpy() < ndb)
        for k in np.flatnonzero(dropped):
            s = int(stop[k])
            edge = {0: "first", KD - 1: "last"}.get((s - 1) % KD, "mid")
            if s <= KD:
                edge = "first_group"
            pick.setdefault(edge, []).append(
                (ln.query[k, :ln.qlen[k]], ln.target[k, :ln.tlen[k]]))
    assert {"first", "last", "mid"} <= set(pick)
    chosen = [pair for ks in pick.values() for pair in ks[:2]]
    stats = _stats()
    for sub in _launches(chosen, flag, _empty_tracks(chosen), 0, 20):
        _check(sub, stats)
    assert stats["drops"] == len(chosen)
    assert {0, KD - 1} <= set(stats["drop_at"])


# shorter sides at the register form's edges and below: ncol 208 and 224
# (a window three parts idle), 464 (W - 48, the last the form takes), 480
# (W - 32: the wide form)
EDGES = [(192, 208, 16), (193, 224, 16), (448, 464, 16), (449, 480, 0)]


@pytest.mark.parametrize("M,ncol,cpl", EDGES)
def test_model_at_window_edges(M, ncol, cpl):
    """Launches whose shorter side puts ncol at a window's edges: the
    query shorter than the target (the window slides over the target)
    and the reverse (it never slides); CIG, RIGHT and APPROX."""
    long_ = M + 150
    pairs = _pairs(300 + M, (long_, long_))
    pairs = [(pairs[0][0][:M], pairs[0][1]), (pairs[1][0],
                                                pairs[1][1][:M])]
    for flag in ((SPL, SPL | Flag.RIGHT, SPL | APPROX) if cpl else (SPL,)):
        stats = _stats()
        for ln in _launches(pairs, flag, _empty_tracks(pairs), 0, 200):
            assert (ln.ncol, BE.exts_form(ln.ncol, 5)) == (ncol, cpl)
            if cpl:
                _check(ln, stats)
        assert stats["slides"] > 0 or not cpl


def test_form_rule_for_every_ncol():
    """``exts_form`` for every ncol the splice route can send (shorter
    sides of 1-1536 bp): cpl 16 up to 464, then the wide form; every
    pair of such a launch keeps en0 + 15 and st - 1 inside the window on
    every diagonal (pairs at the widest M of their ncol, either side
    shorter, and a square one); m > 8 takes the wide form."""
    seen = {}
    for M in range(1, 1537):
        ncol = n_col_bytes(M, M, 2 * M)
        assert ncol == n_col_bytes(M, 1536, M + 1536) == \
            n_col_bytes(1536, M, M + 1536)
        seen[ncol] = M
    assert min(seen) == 32 and max(seen) == 1552
    for ncol, M in seen.items():
        cpl = BE.exts_form(ncol, 5)
        assert cpl == (16 if ncol <= 464 else 0)
        assert BE.exts_form(ncol, 9) == 0 and BE.exts_form(ncol, 8) == cpl
        if not cpl:
            continue
        for qlen, tlen in ((M, 1536), (1536, M), (M, M)):
            for r in range(qlen + tlen - 1):
                st0, en0, st, en = band_row(r, qlen, tlen)
                base = BT.window_base(st)
                assert base <= max(st - 1, 0)
                assert en0 + 15 <= base + 32 * cpl - 1
                assert en - st + 1 <= ncol


def test_wrapper_takes_plain_version_only_on_cpu():
    """On CPU tensors the route runs the plain twin; the CUDA launchers
    refuse CPU tensors (no fallback), in either form."""
    spl = CS.splice_jobs(n=4)
    (ln,) = _launches(spl, SPL, _empty_tracks(spl))
    args = BD.band_upload(ln, "cpu")
    for fn in (BE.batch_exts_forward_cuda, BE.batch_exts_wide_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, ln.prm, ln.nd, ln.ncol)
    rec = BE.batch_exts_records(ln, "cpu")
    assert torch.equal(rec, BE.batch_exts_forward_plain(
        *args, ln.prm, ln.nd, ln.ncol)[0])


# ------------------------------------------------------------ wide form


def _tile_first(t0, w):
    """band_fwd.cu's ``tile_first``."""
    if t0 == 0:
        return 0
    x = t0 - 15
    return max(x, 2 * x - w)


def _tile_last(t0, tp, qlen, w, rlim):
    """band_fwd.cu's ``tile_last``."""
    X = t0 + tp - 1
    return min(rlim - 1, X + qlen - 1, 2 * X + w)


def _tile_rule_holds(qlen, tlen, tp, nw):
    """A warp's next tile (nw on) starts after its tile's last diagonal,
    for every tile of an unbanded exts pair (w = qlen + tlen)."""
    w = qlen + tlen
    rlim = qlen + tlen - 1
    ntiles = -(-(tlen + 15) // tp)
    for k in range(ntiles - nw):
        nxt = (k + nw) * tp
        first = _tile_first(nxt, w)
        if first <= _tile_last(nxt, tp, qlen, w, rlim) and \
                first <= _tile_last(k * tp, tp, qlen, w, rlim):
            return False
    return True


def test_wide_layout_every_ncol():
    """For every ``ncol`` kernel 6's wide form can be given (m > 8 sends
    any ncol there; the splice route's 480 ... 1552 by its form rule),
    score and CIG launches alike: tiles of 64 positions, 2-26 compute
    warps and the replay warp (at most 864 threads, the band kernel's
    bound), a ring of at least (nw + 2) groups, shared memory within a
    block's with either score table (m 5: registers; 12 and 255: the
    shared byte matrix), and the tile rule for the widest pairs of that
    ``ncol`` (square and lopsided, either side shorter, up to 1536)."""
    seen = {}
    for M in range(1, 1537):
        seen[n_col_bytes(M, M, 2 * M)] = M
    assert [n for n in seen if n >= 480][:2] == [480, 496]
    for ncol, M in seen.items():
        tp, nw, ring = BE.exts_wide_layout(ncol)
        assert tp == 64 and tp == BT.wide_layout(ncol, True)[0]
        assert 2 <= nw <= BT.WIDE_NW_MAX == 26 and 32 * (nw + 1) <= 864
        assert ring >= (nw + 2) * BD.KD and ring & (ring - 1) == 0
        for m in (5, 12, 255):
            assert BD.fwd_smem_bytes(tp, nw, ring, m) <= SMEM_MAX
        for qlen, tlen in ((M, M), (M, 1536), (1536, M), (M, M + 7)):
            assert n_col_bytes(qlen, tlen, qlen + tlen) <= ncol
            assert _tile_rule_holds(qlen, tlen, tp, nw), (ncol, qlen, tlen)
    assert BE.exts_wide_layout(1552)[1] == 26
    assert BE.exts_wide_layout(896)[:2] == (64, 15)
    with pytest.raises(ValueError, match="ncol"):
        BE.exts_wide_layout(1616)


def test_route_widest_launch_takes_the_wide_form():
    """The splice route's widest launches (1536 bp each side, score and
    CIG) reach ncol 1552, which the wide form lays out; a target of 1537
    leaves the batched exts route."""
    rng = np.random.default_rng(72)
    t = rng.integers(0, 4, 1537).astype(np.uint8)
    pairs = [(t[:1536], t[:1536]), (t[:700], t[:1536])]
    for flag in (SPL, SPL | SO):
        lns = _launches(pairs, flag, _empty_tracks(pairs), 0, 200)
        assert max(ln.ncol for ln in lns) == 1552
        for ln in lns:
            assert BE.exts_form(ln.ncol, 5) == 0
            BE.exts_wide_layout(ln.ncol)
    assert BE.batch_exts_ineligible_reason(1537, SPL) is not None


def test_wide_wrapper_raises_before_the_launch(monkeypatch):
    """A launch whose ncol the wide form cannot lay out raises ValueError
    in the wrapper, before the library is loaded or anything launches."""
    spl = CS.splice_jobs(n=2)
    (ln,) = _launches(spl, SPL, _empty_tracks(spl))
    args = BD.band_upload(ln, "cpu")

    def no_library():
        raise AssertionError("the wrapper reached the launch")
    monkeypatch.setattr(BE, "_exts_check", lambda *a: None)
    monkeypatch.setattr(BE, "library", no_library)
    with pytest.raises(ValueError, match="ncol 1616"):
        BE.batch_exts_wide_cuda(*args, ln.prm, ln.nd, 1616)
