"""Kernels E / E2's register form and one batched launch a batch, modelled.

Kernel E / E2 has two forms.  The wide form runs the band forward's
block a pair (``csrc/band_fwd.cu``) in the layout of
``ops.batch.wide_layout``; the register form is ``csrc/batch_fwd.cu``.  The register form keeps a pair's state in a
window of ``32 * cpl`` target positions (``ops.batch.batch_form``: cpl
``ops.batch.CPL`` = 8 when the launch's ``ncol`` fits), lane l holding
positions base + cpl l .. base + cpl l + cpl - 1 in registers, base =
``window_base(st)``; the window slides up 32 positions (32 / cpl lanes)
when st - 1 passes the
next multiple of 32, the positions that enter are fresh (init bytes, the
target's symbol, score 0, H NEG), and a query symbol enters at the bottom
each diagonal (a lane's score selectors shift up one position), taken
from 64 symbols staged a group.  Diagonals go in groups of 32: lane j
keeps diagonal r_lo + j's maximum and position (or the H0 walk's), H(st0)
and H(en0), and at the group's end the warp replays Z-drop, mqe / mte and
the score in order by an exclusive running-maximum scan; the first
diagonal that drops is the stop, and the store's rows the warp wrote past
it are zeroed.

The NumPy model below has the kernel's window, slides, query staging,
edge and first-column substitutions, group capture and replay.  It
asserts that every read and write of a diagonal falls inside the window,
that a fresh position's score selector is never used, that a group slides
at most once and that its staged query covers each diagonal, and it
holds the records and every byte to the plain twin
(``ops.band.band_forward_plain``) exactly.  The host's rules are tested
here too: the form; the wide layout's limits for every ``ncol`` the
route can send; and the scheduler's merge of the batched route's
buckets into one launch a form a batch (score and CIGAR paths; the
splice path's kernel-6 buckets stay apart), with results unchanged
against per-bucket launches and, for the merged wide launch, equal to
the JAX package's batched route.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
import refcmp
from ksw2_tpu.batch.scheduler import AlignJob as JAlignJob
from ksw2_tpu.batch.scheduler import align_batch as j_align_batch
from ksw2_tpu.core.matrix import encode_dna, simple_mat

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import batch as BT
from ksw2_tpu_torch.ops import strips
from ksw2_tpu_torch.ops.bands import first_empty_diag, n_col_bytes

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

NEG = -0x40000000
KT = 4096
KD = 32
INT_MIN = -(1 << 31)
MAT = simple_mat(5, 2, 4)
GMAT = np.array([[3, -2, -4, -3, 0],
                 [-3, 2, -2, -4, 0],
                 [-4, -2, 4, -1, 0],
                 [-2, -3, -1, 2, 0],
                 [0, 0, 0, 0, 0]], np.int8).reshape(-1)
EXTD = (4, 2, 13, 1)
SWAPPED = (24, 1, 4, 2)
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP


def w8(x):
    return ((x + 128) & 255) - 128


def band_row(r, qlen, tlen, w):
    st0 = max(0, r - qlen + 1, (r - w + 1) >> 1)
    en0 = min(tlen - 1, r, (r + w) >> 1)
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


def model_pair(q, t, w, prm, nd, ncol, cpl, table, stats):
    """One pair through the register form as csrc/batch_fwd.cu runs it:
    (the 9 record fields, the pair's (nd, ncol) store or None)."""
    qlen, tlen = len(q), len(t)
    W = 32 * cpl
    two = bool(prm.two)
    flag = prm.flag
    approx = bool(flag & Flag.APPROX_MAX)
    adrop = approx and bool(flag & Flag.APPROX_DROP)
    right = bool(flag & Flag.RIGHT)
    generic = bool(flag & Flag.GENERIC_SC)
    m, qq, e, q2, e2 = prm.m, prm.q, prm.e, prm.q2, prm.e2
    qe, qe2 = qq + e, q2 + e2
    ez = e2 if two else e
    init = w8(-qe) if two else 0
    init2 = w8(-qe2)
    rlim = int(first_empty_diag(qlen, tlen, w))
    ndb = qlen + tlen - 1
    assert n_col_bytes(qlen, tlen, w) <= ncol
    assert BT.batch_form(ncol, m) == cpl

    def tsym(pos):
        pos = np.asarray(pos)
        return np.where(pos < tlen, np.asarray(t)[np.minimum(pos, tlen - 1)],
                        0)

    def qsym(i):
        return int(q[i]) if 0 <= i < qlen else 0

    def score(T, Q):
        if generic:
            return w8(np.asarray(table)[T * m + Q].astype(np.int64))
        s = np.where(T == Q, prm.sc_mch, prm.sc_mis)
        return w8(np.where((T == m - 1) | (Q == m - 1), prm.sc_N, s))

    slots = np.arange(W)
    base = 0
    U = np.full(W, init, np.int64)
    V, X, Y = U.copy(), U.copy(), U.copy()
    X2 = np.full(W, init2, np.int64)
    Y2 = X2.copy()
    H = np.full(W, NEG, np.int64)
    H[0] = -prm.qe_pre if two else -qe       # the seed r = 0 reads
    S = np.zeros(W, np.int64)
    T = tsym(slots).astype(np.int64)
    SEL = np.zeros(W, np.int64)              # diagonal -1's: query -1 - t
    poison = np.zeros(W, bool)               # a fresh position's selector
    p = np.zeros((nd, ncol), np.uint8) if prm.cig else None
    mx, mt, mq = 0, -1, -1
    mqe, mqet, mte, mteq, sc, zd = NEG, -1, NEG, -1, NEG, 0
    last_st = last_en = -1
    H0 = lt0 = 0
    for r_lo in range(0, rlim, KD):
        r_hi = min(r_lo + KD - 1, rlim - 1)
        n = r_hi - r_lo + 1
        base_lo = BT.window_base(band_row(r_lo, qlen, tlen, w)[2])
        q0 = r_lo - base_lo
        stage = [qsym(q0 - 32 + i) for i in range(64)]
        gH, gT, gS, gE = ([0] * KD for _ in range(4))
        slid = 0
        for rr in range(n):
            r = r_lo + rr
            st0, en0, st, en = band_row(r, qlen, tlen, w)
            nb = BT.window_base(st)
            if nb != base:
                # the slide: 32 positions (32 / cpl lanes) down, fresh on top
                assert nb == base + 32
                slid += 1
                stats["slides"] += 1
                for arr in (U, V, X, Y, X2, Y2, H, S, T, SEL, poison):
                    arr[:-32] = arr[32:].copy()
                for arr in (U, V, X, Y):
                    arr[-32:] = init
                X2[-32:] = init2
                Y2[-32:] = init2
                H[-32:] = NEG
                S[-32:] = 0
                T[-32:] = tsym(nb + W - 32 + np.arange(32))
                SEL[-32:] = 0
                poison[-32:] = True
                base = nb
            top = base + W - 1
            # the window holds st - 1 and en0 + 15 (>= en, hi)
            assert base <= max(st - 1, 0) and en0 + 15 <= top
            # [st, en] is whole lanes: lane masks, no cell masks
            assert (st - base) % cpl == 0 and (en + 1 - base) % cpl == 0
            assert en - st + 1 <= ncol
            # the query symbol entering at the bottom, from the group's 64
            idx = r - base - (q0 - 32)
            assert 0 <= idx < 64 and stage[idx] == qsym(r - base)
            SEL[1:] = SEL[:-1].copy()
            poison[1:] = poison[:-1].copy()
            SEL[0] = stage[idx]
            poison[0] = False
            prevok = st > 0 and last_st <= st - 1 <= last_en
            if two:
                colv = w8(-qe if r == 0 else (-e if r < prm.lt else (
                    prm.ld if r == prm.lt else -e2)))
            else:
                colv = w8(qq if r else 0)
            hi = en0 if generic else st0 + ((en0 - st0) & ~15) + 15
            f = slice(st0 - base, hi - base + 1)
            assert hi <= top and not poison[f].any()
            S[f] = score(T[f], SEL[f])
            if r <= en:                      # the first column, t == r
                c = r - base
                U[c], Y[c], Y2[c] = colv, init, init2
            # t - 1's old state; slot 0 (position base < st) is never in
            # the band, so its rolled-in value is never used
            s0 = st - base
            Xm, Vm, X2m, Hm = (np.roll(a, 1) for a in (X, V, X2, H))
            assert prevok or st == 0 or s0 >= 1
            if not prevok:
                Xm[s0] = init
                Vm[s0] = colv if st == 0 else init
                X2m[s0] = init2
            b = slice(s0, en - base + 1)
            X1, V1, X21 = Xm[b], Vm[b], X2m[b]
            Uc, Yc = U[b], Y[b]
            a = w8(X1 + V1)
            bb = w8(Yc + Uc)
            if not two:
                zz = w8(S[b] + 2 * qe)
                d = (zz <= a).astype(np.int64) if right else \
                    (a > zz).astype(np.int64)
                z = np.maximum(zz, a)
                d = np.where(z > bb, d, 2) if right else \
                    np.where(bb > z, 2, d)
                z = w8(np.maximum(z & 255, bb & 255))
                z = w8(np.minimum(z & 255, (prm.sc_mch + 2 * qe) & 255))
                un, vn = w8(z - V1), w8(z - Uc)
                z2 = w8(z - qq)
                a, bb = w8(a - z2), w8(bb - z2)
                ta, tb = (a >= 0, bb >= 0) if right else (a > 0, bb > 0)
                d = d | ta * 0x08 | tb * 0x10
                X[b], Y[b] = np.maximum(a, 0), np.maximum(bb, 0)
            else:
                Y2c = Y2[b]
                a2, b2 = w8(X21 + V1), w8(Y2c + Uc)
                z = S[b].copy()
                d = np.zeros_like(z)
                for cand, code in ((a, 1), (bb, 2), (a2, 3), (b2, 4)):
                    d = np.where(z > cand, d, code) if right else \
                        np.where(cand > z, code, d)
                    z = np.maximum(z, cand)
                z = np.minimum(z, w8(prm.sc_mch))
                un, vn = w8(z - V1), w8(z - Uc)
                t1, t2 = w8(z - qq), w8(z - q2)
                a, bb, a2, b2 = w8(a - t1), w8(bb - t1), w8(a2 - t2), \
                    w8(b2 - t2)
                for val, bit in ((a, 0x08), (bb, 0x10), (a2, 0x20),
                                 (b2, 0x40)):
                    d = d | ((val >= 0) if right else (val > 0)) * bit
                X[b] = w8(np.maximum(a, 0) - qe)
                Y[b] = w8(np.maximum(bb, 0) - qe)
                X2[b] = w8(np.maximum(a2, 0) - qe2)
                Y2[b] = w8(np.maximum(b2, 0) - qe2)
            U[b], V[b] = un, vn
            if prm.cig:
                p[r, :en - st + 1] = d
            if not approx:
                # the H row over [st0, en0]; en0 reads the older H(en0 - 1)
                sub = 0 if two else qe
                hv = vn if two else vn & 255
                hu = un if two else un & 255
                hb = slice(st0 - base, en0 - base + 1)
                rel = slice(st0 - st, en0 - st + 1)
                hn = H[hb] + hv[rel] - sub
                if en0 > 0:
                    hn[-1] = Hm[en0 - base] + hu[en0 - st] - sub
                H[hb] = hn
                hm = int(hn.max())
                cands = [st0 + i for i in np.flatnonzero(hn == hm)]
                ranks = [sse_rank(c, st0, en0) for c in cands]
                tw = cands[int(np.argmin(ranks))]
                stats["ties" if len(cands) > 1 else "unique"] += 1
                gH[rr], gT[rr] = hm, tw
                gS[rr], gE[rr] = int(hn[0]), int(hn[-1])
            else:
                if r == 0:
                    v0 = int(V[0 - base])
                    H0 = v0 - prm.qe_pre if two else (v0 & 255) - 2 * qe
                    lt0 = 0
                else:
                    c1 = st0 <= lt0 <= en0
                    c2 = st0 <= lt0 + 1 <= en0
                    d0 = int(V[lt0 - base]) if c1 else 0
                    d1 = int(U[lt0 + 1 - base]) if c2 else 0
                    if not two:
                        d0, d1 = (d0 & 255) - qe, (d1 & 255) - qe
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
        # the replay: lane j holds diagonal r_lo + j
        rs = [r_lo + j for j in range(KD)]
        contrib = [j < n and (not approx or (adrop and (two or rs[j] > 0)))
                   for j in range(KD)]
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
            pq = pr - pt
            v, tt, r = el[j]
            drop = False
            if contrib[j] and prm.zdrop >= 0 and not v > pv and \
                    tt >= pt and r - tt >= pq:
                lgap = abs((tt - pt) - ((r - tt) - pq))
                drop = pv - v > prm.zdrop + lgap * ez
            drops.append(drop)
        jd = drops.index(True) if True in drops else KD
        last = _first_max(carry, inc[min(jd, n - 1)])
        mx, mt, mq = last[0], last[1], last[2] - last[1]
        for j in range(min(jd + 1, n)):
            st0, en0, _, en = band_row(rs[j], qlen, tlen, w)
            if not approx and en0 == tlen - 1 and gE[j] > mte:
                mte, mteq = gE[j], rs[j] - en
            if not approx and rs[j] - st0 == qlen - 1 and gS[j] > mqe:
                mqe, mqet = gS[j], st0
            if j < jd and rs[j] == ndb - 1 and en0 == tlen - 1:
                sc = gH[j] if approx else gE[j]
        if jd < n:
            zd = 1
            stats["drops"] += 1
            if prm.cig:
                # the rows the warp wrote past the stop
                p[r_lo + jd + 1:r_hi + 1] = 0
            break
    if rlim < ndb:
        zd = 1
    return [mx, mt, mq, mqe, mqet, mte, mteq, sc, zd], p


def model_launch(ln, stats):
    """Every pair of a register-form launch through :func:`model_pair`:
    (rec (B, 9) int32, p (B, nd, ncol) uint8 or None)."""
    cpl = BT.batch_form(ln.ncol, ln.prm.m)
    assert cpl
    table = np.asarray(ln.prm.matt or [0] * (ln.prm.m ** 2), np.int64)
    recs, ps = [], []
    for k in range(len(ln.qlen)):
        ql, tl = int(ln.qlen[k]), int(ln.tlen[k])
        rec, p = model_pair(ln.query[k, :ql], ln.target[k, :tl],
                            int(ln.w[k]), ln.prm, ln.nd, ln.ncol, cpl, table,
                            stats)
        recs.append(rec)
        ps.append(p)
    rec = torch.tensor(recs, dtype=torch.int32)
    return rec, (torch.from_numpy(np.stack(ps)) if ln.prm.cig else None)


def _pairs(seed, lens, div=0.15, indel=0.06, with_n=False):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=indel,
                                  with_n=with_n)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _drop_pairs(seed, lens, aligned):
    """Pairs that align for ``aligned`` bp and then run into unrelated
    sequence, so they Z-drop near diagonal 2 * aligned."""
    rng = np.random.default_rng(seed)
    out = []
    for L, A in zip(lens, aligned):
        t, q = refcmp.random_pair(rng, A, divergence=0.04, indel=0.01)
        tail_t = "".join(rng.choice(list("ACGT"), size=L - A))
        tail_q = "".join(rng.choice(list("ACGT"), size=L - A))
        out.append((encode_dna(q + tail_q), encode_dna(t + tail_t)))
    return out


def _launch(pairs, w, flag, zdrop, costs=None, mat=MAT):
    q, e, q2, e2 = costs or (4, 2, 0, 0)
    wv = np.broadcast_to(np.asarray(w, np.int32), (len(pairs),))
    (ln,) = BD.band_prep([a for a, _ in pairs], [b for _, b in pairs],
                         [len(a) for a, _ in pairs],
                         [len(b) for _, b in pairs], wv.copy(), 5, mat, q, e,
                         zdrop, flag, cig=not flag & Flag.SCORE_ONLY,
                         two=costs is not None, q2=q2, e2=e2)
    return ln


def _check(ln, stats=None):
    """The model against the plain twin on one launch, exactly."""
    stats = stats if stats is not None else _stats()
    args = BD.band_upload(ln, "cpu")
    prec, pp = BD.band_forward_plain(*args, ln.prm, ln.nd, ln.ncol)
    mrec, mp = model_launch(ln, stats)
    assert torch.equal(mrec, prec)
    if ln.prm.cig:
        assert torch.equal(mp, pp)
    return stats


def _stats():
    return dict(slides=0, ties=0, unique=0, groups=0, drops=0)


# one- and two-piece, default and swapped costs; score, CIG, APPROX;
# RIGHT; GENERIC_SC
FORMS = [
    ("extz_score_z100", Flag.SCORE_ONLY, 100, None, MAT),
    ("extz_cig_zm1", Flag.NONE, -1, None, MAT),
    ("extz_cig_right_z40", Flag.RIGHT, 40, None, MAT),
    ("extz_approx_score", Flag.SCORE_ONLY | Flag.APPROX_MAX, -1, None, MAT),
    ("extz_approxdrop_cig_z30", APPROX, 30, None, MAT),
    ("extz_generic_cig_z100", Flag.GENERIC_SC, 100, None, GMAT),
    ("extd_cig_z100", Flag.NONE, 100, EXTD, MAT),
    ("extd_score_right_zm1", Flag.SCORE_ONLY | Flag.RIGHT, -1, EXTD, MAT),
    ("extd_approxdrop_score_z30", Flag.SCORE_ONLY | APPROX, 30, EXTD, MAT),
    ("extd_generic_cig_right_z100", Flag.GENERIC_SC | Flag.RIGHT, 100, EXTD,
     GMAT),
    ("swapped_cig_z60", Flag.NONE, 60, SWAPPED, MAT),
    ("swapped_approx_cig", Flag.APPROX_MAX, -1, SWAPPED, MAT),
]


@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("w", [0, 1, 16, 100])
def test_model_matches_plain(form, w):
    """Seeded pairs (N bases, a clipped query, a short target) at each
    band, every form: records and bytes equal the plain twin's."""
    _, flag, zdrop, costs, mat = form
    pairs = _pairs(100 + w, (90, 210, 40), div=0.18, indel=0.07,
                   with_n=True)
    pairs[1] = (pairs[1][0][:120], pairs[1][1])
    pairs.append((pairs[0][0][:1], pairs[0][1][:1]))        # one base
    _check(_launch(pairs, w, flag, zdrop, costs, mat))


@pytest.mark.parametrize("costs", [None, EXTD, SWAPPED])
@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY, Flag.NONE,
                                  Flag.SCORE_ONLY | APPROX])
def test_model_unbanded_slides(costs, flag):
    """Unbanded short pairs (the whole pair in the window, no slide) and
    narrow bands on long pairs, whose window slides many times, clipping
    on both sequences (qlen >> tlen and the reverse)."""
    short = _pairs(7, (60, 130))
    _check(_launch(short, [max(len(a), len(b)) for a, b in short], flag,
                   100, costs))
    longp = _pairs(8, (700, 400))
    longp[1] = (longp[1][0][:90], longp[1][1])              # qlen << tlen
    longp.append((longp[0][0], longp[0][1][:150]))          # qlen >> tlen
    stats = _check(_launch(longp, 30, flag, -1, costs))
    assert stats["slides"] > 20


@pytest.mark.parametrize("costs", [None, EXTD])
@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY, Flag.NONE,
                                  Flag.SCORE_ONLY | APPROX])
def test_model_drops_at_group_edges(costs, flag):
    """Z-drops on a group's first and last diagonal and in between, and
    in the first group: the stop, every field and the zeroed rows.  The
    plain twin's stops over a sweep of pairs pick the pairs whose drop
    falls on each edge; the model runs on those."""
    sweep = _drop_pairs(200, [A + 140 for A in range(10, 90)],
                        list(range(10, 90)))
    ln = _launch(sweep, 40, flag, 20, costs)
    args = BD.band_upload(ln, "cpu")
    rec, _, stop = BD.band_forward_plain(*args, ln.prm, ln.nd, ln.ncol,
                                         with_stop=True)
    rlim = first_empty_diag(ln.qlen, ln.tlen, ln.w)
    dropped = (rec[:, 8].numpy() == 1) & (stop.numpy() < rlim)
    pick = {}
    for k in np.flatnonzero(dropped):
        edge = {0: "first", KD - 1: "last"}.get(int(stop[k] - 1) % KD, "mid")
        if int(stop[k]) <= KD:
            edge = "first_group"
        pick.setdefault(edge, []).append(int(k))
    assert {"first", "last", "mid"} <= set(pick)
    chosen = [k for ks in pick.values() for k in ks[:2]]
    stats = _check(_launch([sweep[k] for k in chosen], 40, flag, 20, costs))
    assert stats["drops"] == len(chosen)


def test_model_ties():
    """Repeats give many diagonals whose maximum ties across cells and
    across lanes (the SSE rank decides), at w 100 and 16."""
    rng = np.random.default_rng(5)
    unit = "".join(rng.choice(list("ACGT"), size=4))
    rep = encode_dna(unit * 40)
    stats = _stats()
    for w in (100, 16):
        _check(_launch([(rep, rep), (rep[:100], rep[3:150])], w,
                       Flag.NONE, 100), stats)
    assert stats["ties"] > 50


def test_model_rlim_and_one_base():
    """w = 0 (rlim = 1), one-base pairs and bands that end before the
    last diagonal (|qlen - tlen| > w)."""
    one = [(encode_dna("A"), encode_dna("A")), (encode_dna("C"),
                                                encode_dna("G"))]
    for flag in (Flag.NONE, Flag.SCORE_ONLY | APPROX):
        _check(_launch(one, 0, flag, 100))
        _check(_launch(one, 5, flag, 100, EXTD))
    pairs = _pairs(9, (200, 80))
    pairs[0] = (pairs[0][0][:50], pairs[0][1])
    _check(_launch(pairs, [0, 0], Flag.NONE, 100))
    _check(_launch(pairs, [20, 3], Flag.NONE, 100, SWAPPED))


@pytest.mark.parametrize("w", [31, 32, 63, 64, 100, 191, 192, 400])
def test_form_rule_holds_every_diagonal(w):
    """``batch_form``'s closed form: every pair of a launch whose ncol
    takes the register form keeps en0 + 15 and st - 1 inside the window
    on every diagonal, for bands at and around the form's edge and pairs
    clipped either way; and the edge is where the rule puts it."""
    for qlen, tlen in ((w + 1, w + 1), (3 * w + 40, 3 * w + 40),
                       (w // 2 + 1, 4 * w + 60), (4 * w + 60, w // 2 + 1),
                       (500, 512), (7, 3000)):
        ncol = n_col_bytes(qlen, tlen, w)
        cpl = BT.batch_form(ncol, 5)
        assert cpl == (8 if ncol <= 208 else 0)
        if not cpl:
            continue
        for r in range(int(first_empty_diag(qlen, tlen, w))):
            st0, en0, st, en = band_row(r, qlen, tlen, w)
            base = BT.window_base(st)
            assert base <= max(st - 1, 0)
            assert en0 + 15 <= base + 32 * cpl - 1
    assert BT.batch_form(128, 5) == 8          # w = 100
    assert BT.batch_form(16, 5) == 8 and BT.batch_form(80, 5) == 8
    assert BT.batch_form(208, 5) == 8 and BT.batch_form(224, 5) == 0
    assert BT.batch_form(208, 8) == 8 and BT.batch_form(208, 9) == 0
    assert BT.batch_form(48, 21) == 0          # no 8-byte score table


@pytest.mark.parametrize("w", [16, 63, 64, 100, 191])
def test_model_at_window_edges(w):
    """Launches from the narrowest bands to the widest the register
    form takes (w 191, ncol 208), one- and two-piece CIGARs: the launch's
    ncol picks the form, and the model equals the plain twin."""
    pairs = _pairs(300 + w, (260, 180, 330))
    for costs in (None, EXTD):
        ln = _launch(pairs, w, Flag.NONE, 100, costs)
        assert BT.batch_form(ln.ncol, 5) == BT.CPL
        _check(ln)


# --------------------------------------------------------------------------
# The host's merge: one batched launch a batch

LAUNCHERS = ("batch_records", "batch_cigar_launch", "band_records",
             "band_cigar_launch", "strips_records", "strips_cigar_launch",
             "rows_records")


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _recorded(monkeypatch, fn, merge=True):
    """``fn()``'s results and the (name, launch) of each launch the
    scheduler made; ``merge=False`` keeps the batched route's buckets
    apart, as before the merge."""
    seen = []
    for name in LAUNCHERS:
        f = getattr(sched, name)
        monkeypatch.setattr(
            sched, name,
            lambda ln, *a, f=f, name=name, **kw:
            seen.append((name, ln)) or f(ln, *a, **kw))
    if not merge:
        monkeypatch.setattr(sched, "_merged_batch", lambda bks, m: bks)
    out = fn()
    monkeypatch.undo()
    return out, seen


# short clipped pairs over several JAX buckets (targets of 90-500 bp)
SB_LENS = (500, 90, 300, 210, 420, 140)
MERGE_CASES = {
    "extz_score": (dict(w=40, zdrop=100, flag=Flag.SCORE_ONLY), False),
    "extd_score": (dict(q2=13, e2=1, w=40, zdrop=100, flag=Flag.SCORE_ONLY),
                   False),
    "approx_score": (dict(w=40, zdrop=100, flag=Flag.SCORE_ONLY | APPROX),
                     False),
    "extz_cigar": (dict(w=40, zdrop=100), True),
    "extd_cigar_right": (dict(q2=13, e2=1, w=40, zdrop=100,
                              flag=Flag.RIGHT), True),
    "extz_eqx_cigar": (dict(w=40, zdrop=100, flag=Flag.EQX), True),
}


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_one_batched_launch_a_batch(monkeypatch, name):
    """A batch whose batched-route jobs fall into several JAX buckets, all
    of the register form, makes one launch holding all of them, longest
    first; every result equals the per-bucket launches'."""
    kw, cig = MERGE_CASES[name]
    pairs = _pairs(61, SB_LENS)
    assert len({sched._bucket_key(len(q), len(t)) for q, t in pairs}) > 2
    aln = Aligner(device="cpu", **kw)
    got, seen = _recorded(monkeypatch, lambda: aln.extend_batch(pairs))
    kind = "batch_cigar_launch" if cig else "batch_records"
    assert [nm for nm, _ in seen] == [kind]
    ln = seen[0][1]
    assert len(ln.qlen) == len(pairs)
    assert BT.batch_form(ln.ncol, 5) == BT.CPL
    n = ln.qlen.astype(np.int64) + ln.tlen
    assert list(n) == sorted(n, reverse=True)
    apart, seen2 = _recorded(monkeypatch, lambda: aln.extend_batch(pairs),
                             merge=False)
    assert len(seen2) > 2 and {nm for nm, _ in seen2} == {kind}
    assert [_row(g) for g in got] == [_row(g) for g in apart]


def test_merged_cigars_split_by_budget(monkeypatch):
    """Under a small LAUNCH_BYTES the merged CIGAR jobs split into the
    fewest launches that fit, with the same results."""
    pairs = _pairs(62, SB_LENS)
    aln = Aligner(device="cpu", w=40, zdrop=100)
    whole, seen = _recorded(monkeypatch, lambda: aln.extend_batch(pairs))
    (_, ln), = seen
    store = len(ln.qlen) * ln.nd * ln.ncol
    budget = store // 2 + ln.nd * ln.ncol
    monkeypatch.setattr(strips, "LAUNCH_BYTES", budget)
    split, seen = _recorded(monkeypatch, lambda: aln.extend_batch(pairs))
    assert [nm for nm, _ in seen] == ["batch_cigar_launch"] * 2
    assert all(len(x.qlen) * x.nd * x.ncol <= budget for _, x in seen)
    assert [_row(g) for g in split] == [_row(g) for g in whole]


def test_wide_buckets_stay_apart(monkeypatch):
    """Buckets with a band wider than the register window (the wide
    form) stay apart from the register-form buckets: each form's buckets
    merge into a launch of their own."""
    pairs = _pairs(63, (480, 250, 100, 120))
    # a query of 700 bp: bucket (1024, 128) beside (512, 128)
    pairs[3] = (np.concatenate([pairs[3][0], _pairs(65, (580,))[0][0]]),
                pairs[3][1])
    w = [230, 220, 30, 30]          # ncol 256 and 240: the wide form
    aln = Aligner(device="cpu", zdrop=100, flag=Flag.EQX)
    got, seen = _recorded(monkeypatch, lambda: aln.extend_batch(pairs, w=w))
    forms = sorted((BT.batch_form(ln.ncol, 5), len(ln.qlen))
                   for _, ln in seen)
    assert forms == [(0, 2), (BT.CPL, 2)]
    apart, _ = _recorded(monkeypatch, lambda: aln.extend_batch(pairs, w=w),
                         merge=False)
    assert [_row(g) for g in got] == [_row(g) for g in apart]


def test_splice_batched_buckets_stay_apart():
    """The splice path's batched buckets run kernel 6, not E: the merge
    leaves them one launch a bucket."""
    rng = np.random.default_rng(64)
    jobs, juncs = [], []
    for tl in (200, 330, 470):
        t = rng.integers(0, 4, tl).astype(np.uint8)
        a, bpos = tl // 4, tl // 2
        t[a:a + 2] = (2, 3)
        t[bpos - 1:bpos + 1] = (0, 2)
        q = np.concatenate([t[5:a], t[bpos + 1:]])
        jobs.append(sched.AlignJob(q, t))
        j = np.zeros(tl, np.uint8)
        j[a], j[bpos] = 1, 2
        juncs.append(j)
    mat = simple_mat(5, 1, 2)
    results = [None] * len(jobs)
    plan = sched.plan_splice(jobs, 5, mat, 2, 1, 32, 9, 200, 9,
                             Flag.SPLICE_FOR, juncs, results)
    assert [route for _, route, _ in plan] == ["batch"] * 3


def lane_rank(em, p0, st0, en0, cpl=BT.CPL):
    """csrc/batch_fwd.cu's rank of a lane's best cell among the cells
    ``em`` (bit k: position p0 + k) that hold the diagonal's maximum,
    from bit masks: the en0 cell, then the lowest lane class (rel & 3 =
    (k - st0) & 3, cells k and k + 4) over [st0, en1), then the lowest
    position of the tail."""
    pat = 0x11
    d0 = p0 - st0
    en1 = st0 + ((en0 - st0) & ~3)
    lo, hi = max(-d0, 0), min(en1 - 1 - p0, cpl - 1)
    R = (2 << hi) - (1 << lo) if hi >= lo else 0
    cm = em & R
    cb = cls = 0
    for c in (3, 2, 1, 0):
        mc = cm & (pat << ((c + st0) & 3))
        if mc:
            cb, cls = mc, c
    ke0 = en0 - p0
    eb = 1 << ke0 if 0 <= ke0 < cpl else 0
    tm = em & ~R & ~eb
    rk = (1 << 31) - 1
    if cb:
        rk = cls * KT + d0 + (cb & -cb).bit_length()
    elif tm:
        rk = 4 * KT + d0 + (tm & -tm).bit_length()
    if em & eb:
        rk = 0
    return rk


@pytest.mark.parametrize("span", [64, 192])
def test_lane_rank_is_the_sse_rank(span):
    """The kernel's branch-free lane rank, reduced over the lanes, picks
    the cell of least SSE rank among every tied set of cells, on random
    bands of up to ``span`` cells (192: as wide as the form takes), both
    lane-class phases, and random ties."""
    cpl = BT.CPL
    rng = np.random.default_rng(70 + span // 24)
    for _ in range(3000):
        st0 = int(rng.integers(0, 300))
        en0 = st0 + int(rng.integers(0, span))
        base = max((st0 & ~15) - 1, 0) & ~31
        cells = [t for t in range(st0, en0 + 1)]
        k = int(rng.integers(1, min(6, len(cells)) + 1))
        tied = set(rng.choice(cells, size=k, replace=False).tolist())
        if rng.random() < 0.2:
            tied.add(en0)
        want = min(sse_rank(t, st0, en0) for t in tied)
        got = (1 << 31) - 1
        for lane in range(32):
            p0 = base + cpl * lane
            em = sum(1 << j for j in range(cpl) if p0 + j in tied)
            if em:
                got = min(got, lane_rank(em, p0, st0, en0, cpl))
        assert got == want, (st0, en0, sorted(tied))


@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_score_codes_are_the_simple_scores(m):
    """The register form's simple scores: a symbol as a nibble (bit 3 for
    N, m - 1), a cell's code from the target and query nibbles (bit 0 the
    symbols differ, bit 1 either is N) and a byte of [mch, mis, scN,
    scN] by the code give the reference's score of every pair of
    symbols, 8 cells a word."""
    mch, mis, scn = 2, -4, -1

    def nib(c):
        return c | (8 if c == m - 1 else 0)

    tab = [mch & 255, mis & 255, scn & 255, scn & 255]
    for T in range(m):
        for Q in range(m):
            tn = sum(nib(T) << (4 * k) for k in range(8))
            qn = sum(nib(Q) << (4 * k) for k in range(8))
            d = (tn ^ qn) & 0x77777777
            code = ((d | d >> 1 | d >> 2) & 0x11111111) | \
                ((tn | qn) & 0x88888888) >> 2
            want = mch if T == Q else mis
            want = scn if T == m - 1 or Q == m - 1 else want
            for k in range(8):
                assert w8(tab[(code >> (4 * k)) & 15]) == want


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


def _tile_rule_holds(qlen, tlen, w, tp, nw):
    """A warp's next tile (nw on) starts after its tile's last diagonal,
    for every tile of the pair."""
    rlim = int(first_empty_diag(qlen, tlen, w))
    ntiles = -(-(tlen + 15) // tp)
    for k in range(ntiles - nw):
        nxt = (k + nw) * tp
        first = _tile_first(nxt, w)
        if first <= _tile_last(nxt, tp, qlen, w, rlim) and \
                first <= _tile_last(k * tp, tp, qlen, w, rlim):
            return False
    return True


@pytest.mark.parametrize("cig", [False, True], ids=["scores", "cigars"])
def test_wide_layout_limits_every_ncol(cig):
    """For every ``ncol`` the route can send the wide form (16 ... 3088
    for scores, ... 1552 for CIGARs): at most 1024 threads a block, at
    most 227 KB of shared memory with either score table (the registers'
    at m 5, the shared byte matrix at m 16 and 255), a ring of at least (nw + 2) groups, and the tile
    rule for the widest pairs of that ``ncol`` (unbanded, square and
    lopsided, and banded): a warp's next tile starts after its last
    ends, so no warp holds two tiles."""
    top = 1552 if cig else 3088
    for ncol in range(16, top + 1, 16):
        tp, nw, ring = BT.wide_layout(ncol, cig)
        assert tp in BT.WIDE_TILES and (tp == 64 or not cig)
        assert 2 <= nw <= BT.WIDE_NW_MAX and 32 * (nw + 1) <= 1024
        assert ring >= (nw + 2) * BD.KD and ring & (ring - 1) == 0
        for m in (5, 16, 255):
            assert BD.fwd_smem_bytes(tp, nw, ring, m) <= strips.SMEM_MAX
        M = ncol - 16                   # the widest min(qlen, tlen, w + 1)
        if M < 1:
            continue
        assert n_col_bytes(M, M, M) == ncol
        L = 1536 if cig else 3072
        for qlen, tlen, w in ((M, M, M), (M, L, L), (L, M, L),
                              (L, L, M - 1), (M, M + 7, M - 1)):
            assert n_col_bytes(qlen, tlen, w) <= ncol
            assert _tile_rule_holds(qlen, tlen, w, tp, nw), (ncol, qlen,
                                                             tlen, w)
    with pytest.raises(ValueError, match="ncol"):
        BT.wide_layout(1618 if cig else 3218, cig)


@pytest.mark.parametrize("kind", ["approx_scores", "eqx_cigars",
                                  "extd_end_bonus"])
def test_route_never_sends_an_ncol_the_wide_form_refuses(kind):
    """The batched route's widest pairs (targets of 3072 for scores, 1536
    for CIGARs and two-piece end_bonus scores; queries as long or longer;
    unbanded) reach the wide form's largest ``ncol`` (3088, 1552), which
    ``wide_layout`` takes; a target one longer leaves the route."""
    rng = np.random.default_rng(70)
    cig = kind == "eqx_cigars"
    L = 3072 if kind == "approx_scores" else 1536
    aln = Aligner(device="cpu", **{
        "approx_scores": dict(flag=Flag.SCORE_ONLY | APPROX, zdrop=100),
        "eqx_cigars": dict(flag=Flag.EQX, zdrop=100),
        "extd_end_bonus": dict(q=4, e=2, q2=13, e2=1, zdrop=100,
                               end_bonus=10, flag=Flag.SCORE_ONLY)}[kind])
    t = rng.integers(0, 4, L + 1).astype(np.uint8)
    pairs = [(t[:L], t[:L]), (t[:L // 2], t[:L]), (np.tile(t, 2)[:2 * L],
                                                   t[:L])]
    lns = CS.batch_route_launches(aln, pairs)
    assert sum(len(ln.qlen) for ln in lns) == len(pairs)
    assert max(ln.ncol for ln in lns) == (1552 if L == 1536 else 3088)
    for ln in lns:
        assert BT.batch_form(ln.ncol, 5) == 0
        BT.wide_layout(ln.ncol, cig)
    assert CS.batch_route_launches(aln, [(t, t)]) == []


def _wide_pairs(seed):
    """Mixed unbanded pairs of 200-300 bp over two JAX buckets (targets
    up to 256 and past it): every one in the wide form (ncol > 208)."""
    rng = np.random.default_rng(seed)
    out = []
    for L in (300, 210, 280, 230, 260, 205):
        t, q = refcmp.random_pair(rng, L, divergence=0.15, indel=0.06,
                                  with_n=True)
        out.append((encode_dna(q), encode_dna(t)))
    return out


WIDE_CASES = {
    "extz_eqx_cigar": dict(zdrop=100, flag=Flag.EQX),
    "extd_end_bonus_score": dict(q2=13, e2=1, zdrop=100, end_bonus=10,
                                 flag=Flag.SCORE_ONLY),
    "extd_eqx_right_cigar": dict(q2=13, e2=1, zdrop=40,
                                 flag=Flag.EQX | Flag.RIGHT),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_merged_wide_plan_matches_jax_batched_route(monkeypatch, name):
    """A batch whose unbanded pairs fall into two JAX buckets, all of the
    wide form, makes one batched launch holding all of them, longest
    first, on the CPU twins; every field and CIGAR equals the JAX
    package's ``align_batch`` (its batched route), exactly."""
    kw = WIDE_CASES[name]
    pairs = _wide_pairs(90 + len(name))
    assert len({sched._bucket_key(len(q), len(t)) for q, t in pairs}) == 2
    jobs = [sched.AlignJob(q, t, -1) for q, t in pairs]
    got, seen = _recorded(monkeypatch, lambda: sched.align_batch(
        jobs, 5, MAT, 4, 2, device="cpu", **kw))
    kind = "batch_records" if kw["flag"] & Flag.SCORE_ONLY else \
        "batch_cigar_launch"
    assert [nm for nm, _ in seen] == [kind]
    ln = seen[0][1]
    assert len(ln.qlen) == len(pairs) and BT.batch_form(ln.ncol, 5) == 0
    n = ln.qlen.astype(np.int64) + ln.tlen
    assert list(n) == sorted(n, reverse=True)
    want = j_align_batch([JAlignJob(q, t, -1) for q, t in pairs], 5, MAT,
                         4, 2, **kw)
    assert [_row(g) for g in got] == [_row(w) for w in want]
