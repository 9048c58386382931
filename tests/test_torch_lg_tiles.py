"""The tiles of kernels 15 and 16 (``csrc/lg_fwd.cu``) on the CPU.

The tiled kernels spread a pair over blocks, each owning ``tp`` target
positions for the diagonals of ``lg_tiles.tile_range``; these tests hold
the host side of that design to the plain versions it must reproduce:

* the layout's tiles cover every position each diagonal touches: the
  rounded band [st, en] and, for extf, the score fill up to
  ``st0 + 16 floor((en0 - st0) / 16) + 15``; its bytes are the buffers
  the wrappers allocate;
* gg2's H0 walk read in closed form (``gg2.gg2_walk_reads``) is the
  reference walk's, and summed by owner (each read from its tile's
  registers at its diagonal, from the tile's last ones past its range,
  0 before it) gives ``gg2_forward_plain(overrun=True)``'s score, on
  seeded pairs and on pairs whose walk runs off u;
* chip_smoke's edge cases X-drop where they say (diagonal 1, the walk at
  a tile edge), on a scalar model of extf2 that matches the plain version;
* the launch splits count the tiles' history;
* ``chip_smoke.py --breakdown``'s anchors occur once in their sources.

Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import lg_edge_cases, random_pair
from ksw2_tpu_torch import _build
from ksw2_tpu_torch.core.matrix import encode_dna, simple_mat
from ksw2_tpu_torch.ops import batch_extf as BF
from ksw2_tpu_torch.ops import batch_gg2 as BG
from ksw2_tpu_torch.ops import extf as XF
from ksw2_tpu_torch.ops import gg2 as G1
from ksw2_tpu_torch.ops import lg_tiles as L
from ksw2_tpu_torch.ops.bands import band_bounds, first_empty_diag

torch.set_num_threads(1)

TLENS = (1, 15, 16, 17, 33, 1000)
WS = (0, 1, 8, 100, -1)
QLENS = (1, 7, 16, 40, 300, 1300)


def _w(qlen, tlen, w):
    return w if w >= 0 else max(qlen, tlen)


def _sweep():
    return [(q, t, _w(q, t, w)) for q in QLENS for t in TLENS for w in WS]


@pytest.mark.parametrize("tp", L.TILES)
@pytest.mark.parametrize("kind", L.KINDS)
def test_tiles_cover_every_diagonal(kind, tp):
    """Every position a diagonal updates ([st, en]) or, extf, fills
    ([st0, fill end]) lies in a tile of the layout whose range holds the
    diagonal."""
    for qlen, tlen, w in _sweep():
        lay = L.lg_layout(kind, [qlen], [tlen], [w], tp)
        n = int(lay.n[0])
        tiles = int(lay.tbase[1])
        k = np.arange(tiles)
        first, last = L.tile_range(k * tp, tp, qlen, w, n)
        st0, en0 = band_bounds(n, qlen, tlen, w)
        st, en = st0 // 16 * 16, en0 | 15
        top = np.maximum(en, st0 + ((en0 - st0) & ~15) + 15) \
            if kind == "extf_fwd" else en
        for r in range(n):
            if st[r] > top[r]:
                continue
            k0, k1 = st[r] // tp, top[r] // tp
            assert k1 < tiles, (kind, qlen, tlen, w, r)
            assert (first[k0:k1 + 1] <= r).all() and \
                (last[k0:k1 + 1] >= r).all(), (kind, qlen, tlen, w, tp, r)


@pytest.mark.parametrize("tp", L.TILES)
@pytest.mark.parametrize("kind", L.KINDS)
def test_layout_bytes_are_the_buffers(kind, tp):
    """A launch's layout counts the bytes of the buffers its wrapper
    allocates, its history is tiles - 1 edges of its diagonals a pair,
    and ``launch_bytes`` bounds it at either tile."""
    sweep = _sweep()
    ql, tl, w = (np.array(a) for a in zip(*sweep))
    lay = L.lg_layout(kind, ql, tl, w, tp)
    bufs = L.lg_buffers(lay, "cpu")
    assert sum(t.numel() * t.element_size() for t in bufs.values()) == \
        lay.device_bytes()
    edges = np.diff(lay.tbase.astype(np.int64)) - 1
    assert lay.n_bnd == int((edges * lay.n).sum())
    hist = L.ENTRY_BYTES[kind] * lay.n_bnd
    walk = L.WALK_BYTES * lay.n_diag if kind == "extf_fwd" else 0
    assert hist + walk <= int(L.launch_bytes(kind, ql, tl, w).sum())
    if kind == "extf_fwd":
        want = np.where((ql > 0) & (tl > 0), first_empty_diag(ql, tl, w), 0)
    else:
        want = ql + tl - 1
    assert (lay.n == want).all()


def _walk_reads(qlen, tlen, w):
    """gg2's H0 walk (ksw2_gg2_sse.c:102-106) step by step: the block
    index it reads on each diagonal."""
    nd = qlen + tlen - 1
    NS = (tlen + 15) // 16 * 16
    st0, en0 = band_bounds(nd, qlen, tlen, w)
    out, lt = [NS], 0
    for r in range(1, nd):
        if st0[r] <= lt <= en0[r]:
            out.append(NS + lt)
        else:
            lt += 1
            out.append(lt)
    return np.array(out[:max(nd, 0)], np.int64)


def test_gg2_walk_reads_follow_the_walk():
    """The closed form of gg2's walk reads is the walk's, over bands 0 to
    unbanded, empty queries and queries longer than tlen + w."""
    for qlen in (0, 1, 2, 7, 16, 40, 77, 300):
        for tlen in TLENS:
            for w in WS:
                w = _w(qlen, tlen, w)
                np.testing.assert_array_equal(
                    G1.gg2_walk_reads(qlen, tlen, w),
                    _walk_reads(qlen, tlen, w), err_msg=str((qlen, tlen, w)))


def _gg2_cases():
    rng = np.random.default_rng(612)
    pairs, ws = [], []
    for L0, w in ((90, -1), (150, 16), (40, 0), (200, 1), (120, 8)):
        t, q = random_pair(rng, L0, divergence=0.2, indel=0.08, with_n=True)
        q, t = encode_dna(q), encode_dna(t)
        if w in (0, 1, 8):                 # the walk runs off u
            q = np.concatenate([q, q[:len(q) // 2 + 30]])
        pairs.append((q, t))
        ws.append(_w(len(q), len(t), w))
    (_, _, ov, w_ov, _), = [c for c in lg_edge_cases() if c[1] == "gg2"]
    return pairs + ov, ws + w_ov


@pytest.mark.parametrize("tp", L.TILES)
def test_gg2_walk_by_owner_gives_the_score(tp):
    """Each walk read taken by the tile that owns its position (its
    registers at the read's diagonal, its last registers past its range,
    0 before it) sums to the plain version's corner score with the block
    overrun; the plain planes bear out that a position is 0 before its
    tile's range and fixed after it."""
    pairs, ws = _gg2_cases()
    qe = 4 + 2
    args = BF.pack_pairs(pairs, ws, "cpu")
    ql = [len(q) for q, _ in pairs]
    tl = [len(t) for _, t in pairs]
    pb, total = BG.flat_layout(ql, tl, ws)
    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32))
    planes = []
    score, _ = BG.gg2_forward_plain(*args, table, 5, 4, 2,
                                    torch.from_numpy(pb), total, True,
                                    planes=planes)
    lay = L.lg_layout("gg2_fwd", ql, tl, ws, tp)
    for b in range(len(pairs)):
        qlen, tlen, w = ql[b], tl[b], ws[b]
        n = int(lay.n[b])
        NS = (tlen + 15) // 16 * 16
        tiles = int(lay.tbase[b + 1] - lay.tbase[b])
        acc = 0
        for r, f in enumerate(G1.gg2_walk_reads(qlen, tlen, w)):
            pl, pos = 0, int(f)
            while pl < 4 and pos >= NS:
                pos -= NS
                pl += 1
            if pl == 4 and pos >= NS + 16:
                continue                   # past the block: 0
            k = pos // tp
            if k >= tiles:                 # no tile: never written
                assert int(planes[r][pl][b, pos]) == 0
                continue
            first, last = (int(x) for x in
                           L.tile_range(k * tp, tp, qlen, w, n))
            if r < first:
                assert int(planes[r][pl][b, pos]) == 0, (b, r, pl, pos)
                continue
            at = min(r, last)
            assert int(planes[r][pl][b, pos]) == \
                int(planes[at][pl][b, pos]), (b, r, pl, pos)
            acc += int(planes[at][pl][b, pos]) & 255
        want = acc - (n + 1) * qe if n >= 1 else 0
        assert int(score[b]) == want, (b, qlen, tlen, w)


def _extf_model(q, t, mch, mis, e, w, xdrop):
    """extf2 (ksw2_extf2_sse.c) one diagonal at a time in NumPy, as the
    reference's rows: the 9-field record and, on an X-drop, the diagonal
    and the walk's lt there."""
    qlen, tlen = len(q), len(t)
    L0 = tlen + 48
    u, v, s = (np.zeros(L0, np.int64) for _ in range(3))

    def w8(x):
        return ((x + 128) & 255) - 128
    nd = qlen + tlen - 1
    rlim = int(first_empty_diag(qlen, tlen, w))
    last_st = last_en = -1
    H0 = lt = mx = 0
    mt = mq = -1
    zd, drop = rlim < nd, None
    for r in range(rlim):
        st0 = max(0, r - qlen + 1, (r - w + 1) >> 1)
        en0 = min(tlen - 1, r, (r + w) >> 1)
        st, en = st0 // 16 * 16, en0 | 15
        hi = st0 + ((en0 - st0) & ~15) + 15
        V1 = v[st - 1] if st > 0 and last_st <= st - 1 <= last_en else 0
        for x in range(st0, hi + 1):
            T = t[x] if x < tlen else 0
            Q = q[r - x] if 0 <= r - x < qlen else 0
            s[x] = mch if T == Q else mis
        idx = np.arange(st, en + 1)
        vm = np.concatenate([[V1], v[st:en]])
        ut = np.where(idx == r, 0, u[st:en + 1])
        z = np.maximum(w8(s[st:en + 1] + 2 * e), vm)
        z = np.where((ut & 255) > (z & 255), ut, z)
        u[st:en + 1], v[st:en + 1] = w8(z - vm), w8(z - ut)
        if r == 0:
            H0, lt = (v[0] & 255) - 2 * e, 0
        else:
            c1, c2 = st0 <= lt <= en0, st0 <= lt + 1 <= en0
            d0, d1 = (v[lt] & 255) - e, (u[lt + 1] & 255) - e
            if c1 and (not c2 or d0 > d1):
                H0 += d0
            else:
                H0 += d1
                lt += 1
            if H0 > mx:
                mx, mt, mq = H0, lt, r - lt
            elif xdrop >= 0 and mx - H0 > xdrop:
                zd, drop = True, (r, lt)
                break
        last_st, last_en = st, en
    neg = -0x40000000
    rec = (mx, mt, mq, neg, -1, neg, -1, neg if zd else H0, int(zd))
    return rec, drop


def test_extf_edge_cases_drop_where_named():
    """chip_smoke's extf edge cases: the scalar model matches the plain
    version's records; the first set X-drops at diagonal 1, the second
    with the walk at a tile's last or the next tile's first position for
    tiles of 32 and of 64, the third stops at its first empty band."""
    cases = {c[0]: c for c in lg_edge_cases() if c[1] == "extf"}
    drops = {}
    for name, (_, _, pairs, w, xdrop) in cases.items():
        rec = BF.extf_forward_plain(*BF.pack_pairs(pairs, w, "cpu"), 2, -4,
                                    2, xdrop).numpy()
        drops[name] = []
        for b, (q, t) in enumerate(pairs):
            want, drop = _extf_model(q, t, 2, -4, 2, w[b], xdrop)
            assert tuple(int(x) for x in rec[b]) == want, (name, b)
            drops[name].append(drop)
    assert all(d is not None and d[0] == 1 for d in drops["extf_xdrop_r1"])
    lts = {d[1] for d in drops["extf_xdrop_edges"] if d is not None}
    for X in (31, 63):
        assert lts & {X, X + 1}, (X, sorted(lts))
    _, _, pairs, w, _ = cases["extf_first_empty"]
    assert all(first_empty_diag(len(q), len(t), wk) < len(q) + len(t) - 1
               for (q, t), wk in zip(pairs, w))


def test_launches_split_by_their_buffers(monkeypatch):
    """Kernel 16's launches count its tiles' history beside the flat
    store, kernel 15's its history and walk records; results do not
    depend on the split."""
    ql = np.array([100, 100, 5000, 100])
    tl = np.array([100, 100, 5000, 100])
    w = np.array([100, 100, 5000, 100])
    store = (ql + tl) * BG.gg2_ncol(tl, w)
    hist = L.launch_bytes("gg2_fwd", ql, tl, w)
    assert (hist > 0).all()
    budget = int(store[:3].sum() + hist[:2].sum())
    monkeypatch.setattr(BG.strips, "LAUNCH_BYTES", budget)
    assert BG.launch_groups(ql, tl, w) == [(0, 3), (3, 4)]
    assert BG.launch_groups(ql, tl, w, single=True) == [(0, 2), (2, 3),
                                                        (3, 4)]
    rng = np.random.default_rng(5)
    pairs = []
    for n in (60, 200, 90):
        t, q = random_pair(rng, n, divergence=0.2, indel=0.05)
        pairs.append((encode_dna(q), encode_dna(t)))
    one = XF.extf_pairs(pairs, 2, 4, 2, -1, 30, device="cpu")
    monkeypatch.setattr(XF.strips, "LAUNCH_BYTES", 1)
    assert [ez.tsv_fields() for ez in XF.extf_pairs(
        pairs, 2, 4, 2, -1, 30, device="cpu")] == \
        [ez.tsv_fields() for ez in one]


@pytest.mark.parametrize("src,stamps", [
    ("extz_fwd", "BREAKDOWN_STAMPS"), ("band_fwd", "BAND_BREAKDOWN_STAMPS"),
    ("lg_fwd", "LG_BREAKDOWN_STAMPS")])
def test_breakdown_anchors_occur_once(src, stamps):
    """``chip_smoke.py --breakdown`` stamps a copy of each kernel at
    anchors that must each occur once in its source."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    for anchor, _ in getattr(chip_smoke, stamps):
        assert text.count(anchor) == 1, anchor
