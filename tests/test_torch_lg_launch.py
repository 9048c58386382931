"""Kernels 8 (gg2) and 7 (extf)'s register forms, modelled.

Both batched kernels have two forms that the host picks from a launch's
widest row: the register form keeps a pair's state in a window of ``W``
target positions (``ops.batch_gg2.REG_W``, 256, for kernel 8;
``ops.batch_extf.REG_W``, 1024, for kernel 7) based at
``window_base(st)``, in units of 8 positions, unit u held by lane u % 32
in its slot u / 32 (``csrc/reg_window.cuh``; with one slot, kernels E /
E2's register layout), and a diagonal computes only the slots its band
meets; the strip form keeps the state in shared memory.  The window
slides up 32 positions when st - 1 passes the next multiple of 32, the
positions that enter are fresh (zero bytes, the target's symbol), and a
query symbol enters at the bottom each diagonal from 64 staged a group.

The NumPy models below have the kernels' windows, slides, query staging,
the stale score bytes (cells of the band outside the score fill keep an
earlier diagonal's byte), the first-column presets and the walks: kernel
8's H0 walk as a sum of the bytes at its closed-form positions, each
taken by the lane that holds it, and kernel 7's H0 walk captured a
diagonal a lane and its maximum and X-drop replayed once a group of 32
by a scan, the warp running on past a drop.  They assert that every read
and write of a diagonal falls inside the window, that a fresh position's
query symbol is never filled, and that the band is whole units of 8
positions, and they hold every store
byte and score (kernel 8) and every record field (kernel 7) to the plain
twins ``gg2_forward_plain`` and ``extf_forward_plain`` exactly.  The
host's form rules are tested for every n_col the two routes can send.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
import refcmp
from ksw2_tpu.core.matrix import encode_dna

from ksw2_tpu_torch.core.matrix import simple_mat
from ksw2_tpu_torch.ops import batch_extf as BF
from ksw2_tpu_torch.ops import batch_gg2 as BG
from ksw2_tpu_torch.ops.batch import WINDOW_SLACK, strip_len, window_base
from ksw2_tpu_torch.ops.bands import first_empty_diag
from ksw2_tpu_torch.ops.strips import SMEM_MAX

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

KD = 32
INT_MIN = -(1 << 31)
NEG = -0x40000000
MAT = simple_mat(5, 2, -4).astype(np.int64)      # the CLI's -A2 -B4
GG2 = (4, 2)                                     # q, e
EXTF = (2, -4, 2)                                # mch, mis, e


def w8(x):
    return ((np.asarray(x, np.int64) + 128) & 255) - 128


def band_row(r, qlen, tlen, w):
    st0 = max(0, r - qlen + 1, (r - w + 1) >> 1)
    en0 = min(tlen - 1, r, (r + w) >> 1)
    return st0, en0, st0 & ~15, en0 | 15


def _first_max(a, b):
    """The running maximum's order: the later element ``b`` (value, t, r)
    wins only when strictly greater."""
    return b if b[0] > a[0] else a


class Window:
    """A register window of ``W`` positions: planes by slot (position -
    base), the target's symbols, the query symbols on the last diagonal
    and which of those came in fresh at a slide."""

    def __init__(self, W, t, planes):
        self.W, self.t, self.base = W, np.asarray(t, np.int64), 0
        self.pl = {k: np.zeros(W, np.int64) for k in planes}
        self.T = self.tsym(np.arange(W))
        self.SEL = np.zeros(W, np.int64)
        self.poison = np.zeros(W, bool)

    def tsym(self, pos):
        n = len(self.t)
        return np.where(pos < n, self.t[np.minimum(pos, max(n - 1, 0))]
                        if n else 0, 0)

    def slide(self, nb, stats):
        assert nb == self.base + 32
        stats["slides"] += 1
        for a in list(self.pl.values()) + [self.T, self.SEL, self.poison]:
            a[:-32] = a[32:].copy()
        for a in self.pl.values():
            a[-32:] = 0
        self.T[-32:] = self.tsym(nb + self.W - 32 + np.arange(32))
        self.SEL[-32:] = 0
        self.poison[-32:] = True
        self.base = nb

    def query_in(self, sym):
        self.SEL[1:] = self.SEL[:-1].copy()
        self.poison[1:] = self.poison[:-1].copy()
        self.SEL[0] = sym
        self.poison[0] = False

    def span(self, lo, hi):
        """The slots of positions [lo, hi], asserted inside the window."""
        assert self.base <= lo and hi <= self.base + self.W - 1, \
            (lo, hi, self.base)
        return slice(lo - self.base, hi - self.base + 1)


def model_gg2(q, t, w, m, table, qq, e, ncol_l, stats):
    """One pair through kernel 8's register form as csrc/gg2_fwd.cu runs
    it: (score, the pair's flat rows (qlen + tlen) x n_col)."""
    qlen, tlen = len(q), len(t)
    W = BG.REG_W
    qe = qq + e
    ncol = int(BG.gg2_ncol(tlen, w))
    assert qlen <= tlen + w and ncol <= ncol_l
    assert BG.gg2_form(ncol_l, m)
    nd = qlen + tlen - 1
    store = np.zeros((qlen + tlen) * ncol, np.uint8)
    win = Window(W, t, "UVXYS")
    U, V, X, Y, S = (win.pl[k] for k in "UVXYS")

    def qsym(i):
        return int(q[i]) if 0 <= i < qlen else 0

    last_st = last_en = -1
    st0p = 0
    hsum = 0
    for r_lo in range(0, nd, KD):
        n = min(KD, nd - r_lo)
        q0 = r_lo - window_base(band_row(r_lo, qlen, tlen, w)[2])
        stage = [qsym(q0 - 32 + i) for i in range(64)]
        slid = 0
        for rr in range(n):
            r = r_lo + rr
            st0, en0, st, en = band_row(r, qlen, tlen, w)
            nb = window_base(st)
            if nb != win.base:
                win.slide(nb, stats)
                slid += 1
            base = win.base
            idx = r - base - (q0 - 32)
            assert 0 <= idx < 64 and stage[idx] == qsym(r - base)
            win.query_in(stage[idx])
            if st <= en:
                stats["live"] += 1
                assert en - st + 1 <= ncol
                # [st, en] is whole lanes (a unit of 8 each); the window
                # holds st - 1 .. en
                assert (st - base) % 8 == 0 and (en + 1 - base) % 8 == 0
                win.span(max(st - 1, 0), en)
                if st0 <= en0:
                    f = win.span(st0, en0)
                    assert not win.poison[f].any()
                    S[f] = w8(table[win.T[f] * m + win.SEL[f]])
                colv = int(w8(qq if r else 0))
                if st <= r <= en:
                    U[r - base], Y[r - base] = colv, 0
                prevok = st > 0 and last_st <= st - 1 <= last_en
                s0 = st - base
                Xm, Vm = np.roll(X, 1), np.roll(V, 1)
                assert prevok or st == 0 or s0 >= 1
                if not prevok:
                    Xm[s0] = 0
                    Vm[s0] = colv if st == 0 else 0
                b = slice(s0, en - base + 1)
                X1, V1, Uc = Xm[b], Vm[b], U[b].copy()
                a, bb = w8(X1 + V1), w8(Y[b] + Uc)
                zz = w8(S[b] + 2 * qe)
                d = (a > zz).astype(np.int64)
                z = np.maximum(zz, a)
                d = np.where(bb > z, 2, d)
                z = np.where((bb & 255) > (z & 255), bb, z)
                U[b], V[b] = w8(z - V1), w8(z - Uc)
                z2 = w8(z - qq)
                a, bb = w8(a - z2), w8(bb - z2)
                d = d | (a > 0) * 0x08 | (bb > 0) * 0x10
                X[b], Y[b] = np.maximum(a, 0), np.maximum(bb, 0)
                store[r * ncol:r * ncol + en - st + 1] = d
            else:
                stats["empty"] += 1
            # the walk's byte at its closed-form position, after the update
            pos = 0 if r == 0 else (r if qlen <= 0 else st0)
            fromv = r == 0 or (qlen > 0 and st0 == st0p)
            win.span(pos, pos)
            hsum += int((V if fromv else U)[pos - base]) & 255
            last_st, last_en, st0p = st, en, st0
        assert slid <= 1
    return (hsum - (nd + 1) * qe if nd > 0 else 0), store


def model_extf(q, t, w, mch, mis, e, xdrop, ncol_l, stats):
    """One pair through kernel 7's register form as csrc/batch_extf_fwd.cu
    runs it: the 9 record fields."""
    qlen, tlen = len(q), len(t)
    if qlen <= 0 or tlen <= 0:
        return [0, -1, -1, NEG, -1, NEG, -1, NEG, 0]
    W = BF.REG_W
    assert int(BF.extf_ncol(qlen, tlen, w)) <= ncol_l
    assert BF.extf_form(ncol_l)
    rlim = int(first_empty_diag(qlen, tlen, w))
    ndb = qlen + tlen - 1
    win = Window(W, t, "UVS")
    U, V, S = (win.pl[k] for k in "UVS")

    def qsym(i):
        return int(q[i]) if 0 <= i < qlen else 0

    last_st = last_en = -1
    H0 = lt = 0
    mx, mt, mq, zd = 0, -1, -1, int(rlim < ndb)
    for r_lo in range(0, rlim, KD):
        n = min(KD, rlim - r_lo)
        q0 = r_lo - window_base(band_row(r_lo, qlen, tlen, w)[2])
        stage = [qsym(q0 - 32 + i) for i in range(64)]
        gH, gT = [0] * KD, [0] * KD
        slid = 0
        for rr in range(n):
            r = r_lo + rr
            st0, en0, st, en = band_row(r, qlen, tlen, w)
            nb = window_base(st)
            if nb != win.base:
                win.slide(nb, stats)
                slid += 1
            base = win.base
            idx = r - base - (q0 - 32)
            assert 0 <= idx < 64 and stage[idx] == qsym(r - base)
            win.query_in(stage[idx])
            # [st, en] is whole units; the slots of 256 positions that the
            # band meets are the diagonal's work
            assert (st - base) % 8 == 0 and (en + 1 - base) % 8 == 0
            stats["slots"] += (en - base) // 256 - (st - base) // 256 + 1
            stats["diags"] += 1
            hi = st0 + ((en0 - st0) & ~15) + 15
            win.span(max(st - 1, 0), max(en, hi))
            f = win.span(st0, hi)
            assert not win.poison[f].any()
            S[f] = w8(np.where(win.T[f] == win.SEL[f], mch, mis))
            if st <= r <= en:
                U[r - base] = 0
            prevok = st > 0 and last_st <= st - 1 <= last_en
            s0 = st - base
            Vm = np.roll(V, 1)
            assert prevok or st == 0 or s0 >= 1
            if not prevok:
                Vm[s0] = 0
            b = slice(s0, en - base + 1)
            V1, Uc = Vm[b], U[b].copy()
            z = np.maximum(w8(S[b] + 2 * e), V1)
            z = np.where((Uc & 255) > (z & 255), Uc, z)
            U[b], V[b] = w8(z - V1), w8(z - Uc)
            if r == 0:
                H0, lt = (int(V[0]) & 255) - 2 * e, 0
            else:
                c1 = st0 <= lt <= en0
                c2 = st0 <= lt + 1 <= en0
                win.span(lt, lt + 1)
                d0 = (int(V[lt - base]) & 255) - e
                d1 = (int(U[lt + 1 - base]) & 255) - e
                if c1 and c2:
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0, lt = H0 + d1, lt + 1
                elif c1:
                    H0 += d0
                else:
                    H0, lt = H0 + d1, lt + 1
            gH[rr], gT[rr] = H0, lt
            last_st, last_en = st, en
        assert slid <= 1
        stats["groups"] += 1
        # the replay: lane j holds diagonal r_lo + j
        rs = [r_lo + j for j in range(KD)]
        el = [(gH[j], gT[j], rs[j]) if j < n and rs[j] > 0
              else (INT_MIN, 0, 0) for j in range(KD)]
        inc = list(el)
        o = 1
        while o < KD:                        # 5 rounds of shuffles
            inc = [_first_max(inc[j - o], inc[j]) if j >= o else inc[j]
                   for j in range(KD)]
            o *= 2
        carry = (mx, mt, mt + mq)
        drops = []
        for j in range(KD):
            pv = _first_max(carry, inc[j - 1] if j else (INT_MIN, 0, 0))[0]
            v = el[j][0]
            drops.append(j < n and rs[j] > 0 and xdrop >= 0
                         and not v > pv and pv - v > xdrop)
        jd = drops.index(True) if True in drops else KD
        last = _first_max(carry, inc[min(jd, n - 1)])
        mx, mt, mq = last[0], last[1], last[2] - last[1]
        if jd < n:
            zd = 1
            stats["drops"] += 1
            stats["past_drop"] += n - 1 - jd
            break
    return [mx, mt, mq, NEG, -1, NEG, -1, NEG if zd else H0, zd]


def _stats():
    return dict(slides=0, groups=0, drops=0, past_drop=0, live=0, empty=0,
                slots=0, diags=0)


def check_gg2(pairs, w, costs=GG2, mat=MAT, m=5, stats=None):
    """The gg2 model against the plain twin on one launch, exactly."""
    stats = stats if stats is not None else _stats()
    qq, e = costs
    ql = [len(a) for a, _ in pairs]
    tl = [len(b) for _, b in pairs]
    ncol_l = int(BG.gg2_ncol(tl, w).max())
    assert BG.gg2_form(ncol_l, m)
    args = BF.pack_pairs(pairs, w, "cpu")
    pb, total = BG.flat_layout(ql, tl, w)
    table = torch.from_numpy(np.asarray(mat, np.int32).reshape(-1))
    ps, pp = BG.gg2_forward_plain(*args, table, m, qq, e,
                                  torch.from_numpy(pb), total, False)
    pp = pp.numpy()
    tab = np.asarray(mat, np.int64).reshape(-1)
    for k, (a, b) in enumerate(pairs):
        score, store = model_gg2(a, b, int(w[k]), m, tab, qq, e, ncol_l,
                                 stats)
        assert score == int(ps[k]), k
        assert np.array_equal(store, pp[pb[k]:pb[k] + len(store)]), k
    return stats


def check_extf(pairs, w, xdrop, costs=EXTF, stats=None):
    """The extf model against the plain twin on one launch, exactly."""
    stats = stats if stats is not None else _stats()
    mch, mis, e = costs
    ql = [len(a) for a, _ in pairs]
    tl = [len(b) for _, b in pairs]
    ncol_l = int(BF.extf_ncol(ql, tl, w).max())
    assert BF.extf_form(ncol_l)
    prec = BF.extf_forward_plain(*BF.pack_pairs(pairs, w, "cpu"), mch, mis,
                                 e, xdrop).numpy()
    for k, (a, b) in enumerate(pairs):
        rec = model_extf(a, b, int(w[k]), mch, mis, e, xdrop, ncol_l,
                         stats)
        assert rec == [int(x) for x in prec[k]], (k, rec, prec[k])
    return stats


def _pairs(seed, lens, div=0.15, indel=0.06, with_n=False, qlens=None):
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(lens):
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=indel,
                                  with_n=with_n)
        q, t = encode_dna(q), encode_dna(t)
        if qlens is not None:
            ql = qlens[i]
            q = (np.concatenate([q, rng.integers(0, 4, max(ql - len(q), 0))
                                 .astype(np.uint8)])[:ql])
        out.append((q, t))
    return out


def _resolve(pairs, w):
    return [int(x) for x in CS._resolve(pairs, w)]


_CLI = {}


def cli_pairs(algo, n):
    """The first ``n`` pairs the CLI run of chip_smoke's mixed-512
    workload gives the batched kernel of ``algo``, spread over its
    lengths."""
    if algo not in _CLI:
        jobs = CS.mixed_jobs()
        b, _ = CS.cli_split(jobs, algo)
        _CLI[algo] = sorted(b, key=lambda p: len(p[0]) + len(p[1]))
    b = _CLI[algo]
    return [b[i] for i in np.linspace(0, len(b) - 1, n).astype(int)]


# ---------------------------------------------------------------------------
# kernel 8


def test_gg2_model_cli_launch():
    """The CLI's batched gg2 pairs at -w 100 (n_col 128): the shortest,
    the longest and some between."""
    pairs = cli_pairs("gg2_sse", 5)
    st = check_gg2(pairs, [100] * len(pairs))
    assert st["slides"] > 0


@pytest.mark.parametrize("case", ["qlen_eq_tlen_w", "empty_bands",
                                  "n_bases", "wrap", "empty_query"])
def test_gg2_model_edges(case):
    """qlen = tlen + w; bands that round to empty (a target much longer
    than query + band); N bases; costs whose deltas wrap int8; an empty
    query (the walk reads u[r])."""
    rng = np.random.default_rng(18)
    if case == "qlen_eq_tlen_w":
        pairs = _pairs(1, [60, 200], qlens=[60 + 8, 200 + 30])
        w = [8, 30]
    elif case == "empty_bands":
        pairs = _pairs(2, [150, 300], qlens=[20, 40])
        w = [5, 12]
    elif case == "n_bases":
        pairs = _pairs(3, [120, 250], with_n=True)
        w = [16, 100]
    elif case == "wrap":
        pairs = _pairs(4, [140, 90], div=0.3, indel=0.1)
        w = [100, 40]
    else:
        pairs = [(np.zeros(0, np.uint8), rng.integers(0, 4, 45)
                  .astype(np.uint8)), (np.zeros(0, np.uint8),
                                       np.zeros(1, np.uint8))]
        w = [3, 100]
    costs, mat = GG2, MAT
    if case == "wrap":
        costs = (30, 20)
        mat = simple_mat(5, 90, -100).astype(np.int64)
    st = check_gg2(pairs, w, costs, mat)
    if case == "empty_bands":
        assert st["empty"] > 0


@pytest.mark.parametrize("ncol", [208, 192])
def test_gg2_model_at_window_edge(ncol):
    """n_col at W - 48 (the register form's widest) and below it; W - 32
    takes the strip form (test_gg2_form_every_ncol)."""
    wc = ncol - 16 - 15                   # min(w + 1, tlen) for this ncol
    pairs = _pairs(5, [wc + 40, wc + 3], qlens=[wc + 60, wc + 10])
    w = [wc - 1, wc + 8]
    assert int(BG.gg2_ncol([len(b) for _, b in pairs], w).max()) == ncol
    check_gg2(pairs, w)


def test_gg2_form_every_ncol():
    """Every n_col the batched gg2 route can send (targets up to 1536,
    any band): the register form up to W - 48 = 208, the strip form
    beyond, whose shared memory holds one warp at the route's widest
    target; m > 8 always takes the strip form."""
    cols = sorted({int(c) for c in BG.gg2_ncol(
        np.arange(1, BG.LT_GG2 + 1)[:, None], np.arange(0, 1600)[None, :])
        .ravel()})
    assert cols[0] == 32 and cols[-1] == BG.LT_GG2 + 16
    for c in cols:
        assert BG.gg2_form(c, 5) == (c + WINDOW_SLACK <= 256)
        assert not BG.gg2_form(c, 9)
    assert BG.gg2_form(208, 5) and not BG.gg2_form(224, 5)
    assert 5 * strip_len(BG.LT_GG2) <= SMEM_MAX


def test_gg2_route_rule():
    """The batched entry refuses qlen > tlen + w before any launch (the
    register form traps on such a pair)."""
    q = np.zeros((1, 50), np.uint8)
    t = np.zeros((1, 10), np.uint8)
    with pytest.raises(ValueError, match="single-pair"):
        BG.gg2_batch_align(q, t, [50], [10], 5, MAT.reshape(-1), 4, 2,
                           w=[5], device="cpu")


# ---------------------------------------------------------------------------
# kernel 7


@pytest.mark.parametrize("xdrop", [-1, 40])
def test_extf_model_cli_launch(xdrop):
    """The CLI's batched extf pairs, unbanded (n_col up to 720, in the
    register form's window of 1024), at its -z 40 (every pair X-drops
    early) and with no X-drop."""
    pairs = cli_pairs("extf2_sse", 4 if xdrop < 0 else 8)
    st = check_extf(pairs, _resolve(pairs, -1), xdrop)
    if xdrop >= 0:
        # every pair drops in its first diagonals, where its band lies in
        # one slot of the launch's four
        assert st["drops"] == len(pairs) and st["past_drop"] > 0
        assert st["slots"] < 1.2 * st["diags"]
    else:
        assert st["slides"] > 0 and st["slots"] < 3 * st["diags"]


@pytest.mark.parametrize("name", ["extf_xdrop_r1", "extf_xdrop_edges",
                                  "extf_first_empty"])
def test_extf_model_edge_cases(name):
    """chip_smoke's edge cases: X-drops at diagonal 1, X-drops as the
    walk crosses a 32-position edge, first empty bands before the
    corner."""
    (_, _, pairs, w, xdrop), = [c for c in CS.lg_edge_cases()
                                if c[0] == name]
    if name == "extf_xdrop_edges":
        pairs, w = pairs[::4], w[::4]
    check_extf(pairs, [int(x) for x in w], xdrop)


@pytest.mark.parametrize("xdrop", [-1, 5, 40])
def test_extf_model_banded_n_wrap(xdrop):
    """Banded pairs (their bands in one or two slots) with N bases (N
    matches N), and costs whose deltas wrap int8."""
    pairs = _pairs(6, [90, 160, 300], with_n=True, div=0.25)
    check_extf(pairs, [0, 16, 100], xdrop)
    check_extf(pairs[:2], [40, 100], xdrop, costs=(50, -60, 60))


@pytest.mark.parametrize("ncol", [208, 224, 464, 480, 976])
def test_extf_model_at_window_edges(ncol):
    """n_col at W - 48 (976, the widest the register form takes; 992
    takes the strip form, test_extf_form_every_ncol) and bands that end
    at or just past a slot's edge (208, 224, 464, 480)."""
    m = ncol - 16 - 15                    # min(qlen, tlen, w + 1)
    pairs = _pairs(7, [m + 20], qlens=[m + 40])
    w = [m - 1]
    assert int(BF.extf_ncol([m + 40], [m + 20], w)[0]) == ncol
    check_extf(pairs, w, -1)


def test_extf_form_every_ncol():
    """Every n_col the batched extf route can send (targets up to 1536):
    the register form while its window of 1024 holds n_col + 48, the
    strip form past it (n_col > 976), whose shared memory holds one warp
    at the route's widest target."""
    cols = sorted({int(c) for c in BF.extf_ncol(
        np.arange(1, 1700)[:, None], np.arange(1, BF.LT_EXTF + 1)[None, :],
        10 ** 6).ravel()})
    assert cols[0] == 32 and cols[-1] == BF.LT_EXTF + 16
    for c in cols:
        assert BF.extf_form(c) == (c + WINDOW_SLACK <= 1024)
    assert BF.extf_form(976) and not BF.extf_form(992)
    assert 3 * strip_len(BF.LT_EXTF) <= SMEM_MAX


def test_extf_batch_device_picks_its_launch_ncol(monkeypatch):
    """``extf_batch_device`` gives the kernel's wrapper the launch's
    widest n_col from the host lengths (no read-back)."""
    seen = {}

    def fake(qs, ts, qlen, tlen, w, mch, mis, e, xdrop, cuda):
        seen["ncol"] = cuda.keywords["ncol"]
        assert cuda.func is BF.batch_extf_forward_cuda
        return BF.extf_forward_plain(qs, ts, qlen, tlen, w, mch, mis, e,
                                     xdrop)

    monkeypatch.setattr(BF, "extf_forward", fake)
    pairs = _pairs(8, [100, 400])
    Q = np.zeros((2, 500), np.uint8)
    T = np.zeros((2, 500), np.uint8)
    for k, (a, b) in enumerate(pairs):
        Q[k, :len(a)] = a
        T[k, :len(b)] = b
    BF.extf_batch_device(Q, T, [len(a) for a, _ in pairs],
                         [len(b) for _, b in pairs], 2, -4, 2, xdrop=40,
                         device="cpu")
    assert seen["ncol"] == int(BF.extf_ncol(
        [len(a) for a, _ in pairs], [len(b) for _, b in pairs],
        [max(len(a), len(b)) for a, b in pairs]).max())
