"""Kernel A's layout and the strips route's one score launch a batch.

* ``strips_layout`` in closed form: a warp a strip of 128 query columns,
  a pair's strips on consecutive warps of one cluster, short pairs
  packed several to a block, few long pairs spread over clusters.
* A model of the kernel's strip pipeline in NumPy (each strip row by row
  from the edge the strip before published: H and each chain's run,
  lane maxima and a lane scan, the sliding window of diagonal maxima and
  its fast merge key) equals ``strips_forward_plain`` exactly, one- and
  two-piece and splice: the CUDA kernel computes this model.
* The merged score launch: a batch whose strips jobs fall into several
  buckets goes out as one launch under the default budget and as the
  fewest that fit under a small ``LAUNCH_BYTES``; its 9 fields equal
  the JAX spec (``ksw2_tpu.spec.diagdiff``) and the per-bucket launches.

Run on the CPU, where the wrappers take the kernels' plain versions; the
kernel's own tests are the ``cuda`` ones in tests/test_torch_kernels.py.
"""
import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import strips as S

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
SENT = S.SENT


# --------------------------------------------------------------------------
# The layout


def _check_layout(lay, qlen):
    """Every pair's strips, once each, on consecutive warps of one
    cluster, in strip order; idle warps hold pair -1."""
    tab = np.asarray(lay.table)
    V = lay.nw * lay.cl
    assert 1 <= lay.nw <= S.MAX_WARPS and 1 <= lay.cl <= S.MAX_CLUSTER
    assert len(tab) % V == 0
    live = tab[:, 0] >= 0
    assert np.all(tab[~live, 1] == 0)
    ns = S.n_strips(qlen)
    for p, n in enumerate(ns):
        w = np.flatnonzero(tab[:, 0] == p)
        assert len(w) == n
        assert np.array_equal(tab[w, 1], np.arange(n))
        assert np.array_equal(w, w[0] + np.arange(n))
        assert w[0] // V == w[-1] // V
    return tab


@pytest.mark.parametrize("qlen,nw,cl", [
    (1, 4, 1), (127, 4, 1), (128, 4, 1), (129, 1, 2), (255, 1, 2),
    (256, 1, 2), (257, 1, 3), (4608, 5, 8)])
def test_layout_of_one_pair(qlen, nw, cl):
    """One pair (tlen 1 or more: the layout reads only qlen) on a card of
    132 SMs: ceil(qlen / 128) strips; up to 128 columns a block of
    MIN_WARPS warps, longer queries a cluster of up to 8 blocks of the
    fewest warps that hold them."""
    lay = S.strips_layout([qlen], sms=132)
    assert (lay.nw, lay.cl) == (nw, cl)
    tab = _check_layout(lay, [qlen])
    ns = -(-qlen // 128)
    assert lay.blocks == cl
    assert tab[:ns, 0].tolist() == [0] * ns
    assert tab[:ns, 1].tolist() == list(range(ns))


def test_short_pairs_share_blocks():
    """A launch of more pairs than SMs takes no clusters; pairs of one
    strip pack MIN_WARPS to a block, in order."""
    ql = [100] * 10 + [1, 128]
    lay = S.strips_layout(ql, sms=4)
    assert (lay.nw, lay.cl) == (S.MIN_WARPS, 1)
    tab = _check_layout(lay, ql)
    assert lay.blocks == 3
    assert tab[:, 0].tolist() == list(range(12))


def test_packing_moves_a_pair_that_does_not_fit():
    """A pair goes to the next cluster when the rest of this one cannot
    hold all its strips; the warps it leaves are idle."""
    ql = [300, 200, 300, 129, 500]            # 3, 2, 3, 2, 4 strips
    lay = S.strips_layout(ql, sms=1)
    assert (lay.nw, lay.cl) == (S.MIN_WARPS, 1)
    tab = _check_layout(lay, ql)
    blocks = [tab[k:k + 4, 0].tolist() for k in range(0, len(tab), 4)]
    assert blocks == [[0, 0, 0, -1], [1, 1, -1, -1], [2, 2, 2, -1],
                      [3, 3, -1, -1], [4, 4, 4, 4]]


def test_few_long_pairs_spread_over_clusters():
    """17 whale pairs (3,100 bp queries, 25 strips) on 132 SMs: clusters
    of 132 // 17 = 7 blocks of 4 warps, one pair a cluster; forced
    shapes are kept, and shapes that cannot hold a pair raise."""
    ql = [3100] * 17
    lay = S.strips_layout(ql, sms=132)
    assert (lay.nw, lay.cl, lay.blocks) == (4, 7, 17 * 7)
    _check_layout(lay, ql)
    lay = S.strips_layout(ql, cl=2, nw=13)
    assert (lay.nw, lay.cl, lay.blocks) == (13, 2, 34)
    _check_layout(lay, ql)
    assert S.strips_layout(ql, cl=4).nw == 7
    assert S.strips_layout(ql, nw=16).cl == 2
    for kw in (dict(cl=1, nw=16), dict(nw=17), dict(cl=9, nw=4)):
        with pytest.raises(ValueError, match="no kernel-A layout"):
            S.strips_layout(ql, **kw)


def test_mixed_launch_layout_invariants():
    rng = np.random.default_rng(4)
    ql = rng.integers(1, 4609, 300)
    for sms in (1, 132, 1000):
        _check_layout(S.strips_layout(ql, sms=sms), ql)


# --------------------------------------------------------------------------
# The kernel's strip pipeline, modelled in NumPy


def _merge_key(i, r, qlen, tlen, tv):
    """common.cuh:merge_key."""
    st0 = max(0, r - qlen + 1)
    en0 = min(tlen - 1, r)
    if i == en0:
        return 0
    en1 = st0 + ((en0 - st0) & -4)
    return ((i - st0) & 3) * tv + i + 1 if i < en1 else 4 * tv + i + 1


def _bnd(prm, i):
    """``boundary_h`` on an int or a NumPy array."""
    t = S.boundary_h(prm, torch.as_tensor(np.asarray(i, np.int64)))
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _strip_model(ln):
    """csrc/strips_fwd.cu's arithmetic, strip by strip: (D, Dq, hl) of
    the launch ``ln`` (score forms)."""
    prm = ln.prm
    B, Lq = ln.query.shape
    tv = prm.tv
    nd = Lq + tv
    KB, _ = S.key_params(tv)
    tab = S.score_table(prm).astype(np.int64)
    q, e, q2, e2, m = prm.q, prm.e, prm.q2, prm.e2, prm.m
    gapoe, gapoe2 = q + e, q2 + e2
    D = np.full((B, nd), SENT, np.int64)
    Dq = np.full((B, nd), SENT, np.int64)
    hl = np.full((B, Lq), SENT, np.int64)
    for p in range(B):
        qlen, tlen = int(ln.qlen[p]), int(ln.tlen[p])
        edges = None
        for s in range(int(S.n_strips([qlen])[0])):
            cols = s * 128 + np.arange(128)
            je, je2 = cols * e, cols * e2
            qc = np.where(cols < Lq, ln.query[p][np.minimum(cols, Lq - 1)],
                          0).astype(np.int64)
            H = _bnd(prm, cols)
            E, E2, NI = H - gapoe, H - gapoe2, H - q2
            acc = np.full(128, SENT, np.int64)
            short_key = s > 0 and 128 * (s + 1) <= qlen
            prev_h = 0 if s == 0 else int(_bnd(prm, s * 128 - 1))
            out = []
            for i in range(tlen):
                if edges is None:
                    eh = int(_bnd(prm, i))
                    er = (eh - gapoe, eh - gapoe2, eh - gapoe)
                else:
                    eh, er = edges[i][0], edges[i][1:]
                Hd = np.concatenate([[prev_h], H[:-1]])
                prev_h = eh
                sc = tab[int(ln.target[p, i]) * m + qc]
                Mv = Hd + sc
                hn = np.maximum(Mv, E)
                if prm.two:
                    hn = np.maximum(hn, E2)
                if prm.spl:
                    va, vd = int(ln.acc[p, i]), int(ln.don[p, i])
                    hn = np.maximum(hn, NI + va)
                cv = Hd + prm.mat0
                A = (hn if prm.spl else np.minimum(hn, cv)) + je - q

                def chain(A, edge):
                    """Lane maxima, the lane scan seeded by the edge,
                    then each column's exclusive prefix."""
                    A4 = A.reshape(32, 4)
                    lm = A4.max(1)
                    lm[0] = max(lm[0], edge)
                    inc = np.maximum.accumulate(lm)
                    run = np.concatenate([[edge], inc[:-1]])
                    runs = np.empty((32, 4), np.int64)
                    for c in range(4):
                        runs[:, c] = run
                        run = np.maximum(run, A4[:, c])
                    return runs.reshape(-1), int(inc[-1])

                run, o1 = chain(A, er[0])
                F = run - je
                o2 = o3 = 0
                if prm.two:
                    hc1 = np.minimum(np.maximum(hn, F), cv)
                    run2, o2 = chain(hc1 + je2 - q2, er[1])
                    Hn = np.minimum(np.maximum(hc1, run2 - je2), cv)
                    if prm.cig:
                        _, o3 = chain(Hn + je - q, er[2])
                    E2 = np.maximum(E2 - e2, Hn - gapoe2)
                elif prm.spl:
                    Hn = np.maximum(hn, F)
                    NI = np.maximum(NI, Hn + vd - q2)
                else:
                    Hn = np.minimum(np.maximum(hn, F), cv)
                E = np.maximum(E - e, Hn - gapoe)
                H = Hn
                out.append((int(H[127]), o1, o2, o3))
                # the window of diagonal maxima, the merge key in the
                # kernel's closed forms before the last 4 rows
                for k in range(128):
                    j = int(cols[k])
                    if j >= qlen:
                        continue
                    cls = min(i, qlen - 1 - j) & 3
                    if i + 4 < tlen and short_key:
                        low = KB - 2 - i - cls * tv
                    elif i + 4 < tlen:
                        jc = min(j, 4)
                        low = KB - 1 if jc == 0 else \
                            KB - 2 - i - (cls if cls + jc >= 4 else 4) * tv
                    else:
                        low = KB - 1 - _merge_key(i, i + j, qlen, tlen, tv)
                    acc[k] = max(acc[k], int(H[k]) * KB + low)
                    if j == qlen - 1:
                        Dq[p, i + j] = H[k]
                if i < tlen - 1:
                    if acc[0] != SENT:
                        D[p, i + s * 128] = max(D[p, i + s * 128], acc[0])
                    acc = np.concatenate([acc[1:], [SENT]])
                else:
                    for k in range(128):
                        if acc[k] != SENT:
                            D[p, i + s * 128 + k] = max(D[p, i + s * 128 + k],
                                                        acc[k])
                    for k in range(128):
                        if cols[k] < min(Lq, qlen):
                            hl[p, cols[k]] = H[k]
            edges = out
    return D, Dq, hl


EDGE_Q = (1, 127, 128, 129, 255, 256, 257, 300)


def _edge_launch(kind, cig=False):
    rng = np.random.default_rng(40)
    pairs = []
    for k, ql in enumerate(EDGE_Q):
        tl = (1, 7, 9, 5, 12, 3, 6, 10)[k]
        t, q = refcmp.random_pair(rng, max(ql, tl) + 4, divergence=0.15,
                                  indel=0.05)
        q = np.resize(encode_dna(q), ql)
        pairs.append((q, encode_dna(t)[:tl]))
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    qs, ts = [q for q, _ in pairs], [t for _, t in pairs]
    if kind == "spl":
        (ln,) = S.strips_exts_prep(qs, ts, ql, tl, 5, simple_mat(5, 1, 2), 2,
                                   1, 32, 9, 200, Flag.SPLICE_FOR, cig=cig)
        return ln
    two = kind == "two"
    (ln,) = S.strips_prep(qs, ts, ql, tl, 5, MAT, 4, 2, 100,
                          Flag.NONE if cig else Flag.SCORE_ONLY, cig=cig,
                          two=two, q2=13 if two else 0, e2=1 if two else 0)
    return ln


@pytest.mark.parametrize("kind,cig", [("one", False), ("two", False),
                                      ("two", True), ("spl", False)])
def test_strip_model_matches_plain(kind, cig):
    """The kernel's strip pipeline equals the plain version's D, Dq and
    hl on queries at strip edges (1, 127-129, 255-257, 300) and targets
    of 1-12 rows, so the fast merge key, the window's last rows and the
    partial last strip all occur."""
    ln = _edge_launch(kind, cig)
    args = S.upload(ln, "cpu")
    sites = S.site_rows(ln, "cpu")
    want = S.strips_forward_plain(*args, ln.prm, sites)
    got = _strip_model(ln)
    for a, b in zip(got, want[:3]):
        assert np.array_equal(a, b.numpy())


# --------------------------------------------------------------------------
# One strips launch a score batch


def _pairs(seed, lens, div=0.12):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=div / 2.5)
        out.append((encode_dna(q), encode_dna(t)))
    return out


EXTD = dict(q=4, e=2, q2=13, e2=1)
# name: (aligner keywords, pairs, the spec's result for one pair)
CASES = {
    "extz": (
        dict(zdrop=100, flag=Flag.SCORE_ONLY),
        lambda: _pairs(61, (140, 300, 560, 700, 1100, 1400, 2300)),
        lambda q, t: diagdiff.extz2(q, t, 5, MAT, 4, 2, zdrop=100,
                                    flag=Flag.SCORE_ONLY)[0]),
    "extz_right": (
        dict(zdrop=30, flag=Flag.SCORE_ONLY | Flag.RIGHT),
        lambda: _pairs(62, (150, 420, 900, 1700)),
        lambda q, t: diagdiff.extz2(q, t, 5, MAT, 4, 2, zdrop=30,
                                    flag=Flag.SCORE_ONLY | Flag.RIGHT)[0]),
    "extd": (
        dict(EXTD, zdrop=100, flag=Flag.SCORE_ONLY),
        lambda: _pairs(63, (160, 330, 650, 1000, 1500)),
        lambda q, t: diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, zdrop=100,
                                    flag=Flag.SCORE_ONLY)[0]),
    "extd_right": (
        dict(EXTD, zdrop=-1, flag=Flag.SCORE_ONLY | Flag.RIGHT),
        lambda: _pairs(64, (200, 520, 800)),
        lambda q, t: diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, zdrop=-1,
                                    flag=Flag.SCORE_ONLY | Flag.RIGHT)[0]),
}


def _run(name, merge=True):
    """The case's pairs, results and the strips launches the scheduler
    made (with ``merge=False`` each bucket launches on its own)."""
    kw, pairs, _ = CASES[name]
    pairs = pairs()
    aln = Aligner(device="cpu", **kw)
    seen = []
    rec = sched.strips_records
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            sched, "strips_records",
            lambda ln, dev: seen.append(ln) or rec(ln, dev)))
        if not merge:
            stack.enter_context(mock.patch.object(
                sched, "_merged_strips", lambda bks, *a: bks))
        got = aln.extend_batch(pairs)
    return pairs, got, seen


@functools.lru_cache(maxsize=None)
def _whole(name):
    return _run(name)


def _fields(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped)


def _per_pair(ln):
    return 12 * (ln.query.shape[1] + ln.prm.tv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_score_batch_is_one_strips_launch(name):
    """The batch's strips jobs span several buckets and go out as one
    launch: every pair, the largest bucket's canonical tv, within the
    budget; per bucket they would be several."""
    pairs, _, launches = _whole(name)
    assert len({sched._bucket_key(len(q), len(t)) for q, t in pairs}) > 1
    assert len(launches) == 1
    ln, = launches
    assert len(ln.qlen) == len(pairs)
    assert ln.prm.tv == S.launch_tv([len(t) for _, t in pairs])
    assert len(ln.qlen) * _per_pair(ln) <= S.LAUNCH_BYTES
    assert len(_run(name, merge=False)[2]) > 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_small_budget_fewest_strips_launches(monkeypatch, name):
    """Under a budget of 2 pairs' outputs the merged pairs go out in
    ceil(pairs / 2) launches; the results are the one launch's."""
    pairs, whole, (ln,) = _whole(name)
    monkeypatch.setattr(S, "LAUNCH_BYTES", 2 * _per_pair(ln) + 1)
    _, split, launches = _run(name)
    assert len(launches) == -(-len(pairs) // 2)
    assert [len(x.qlen) for x in launches[:-1]] == [2] * (len(launches) - 1)
    assert [_fields(g) for g in split] == [_fields(g) for g in whole]


@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_launch_matches_spec_and_buckets(name):
    """Every pair of the merged launch equals the JAX package's spec
    engine and the per-bucket launches: the 9 fields, exactly."""
    pairs, got, _ = _whole(name)
    spec = CASES[name][2]
    want = [_fields(spec(q, t)) for q, t in pairs]
    assert [_fields(g) for g in got] == want
    assert [_fields(g) for g in _run(name, merge=False)[1]] == want


def test_packing_guard_keeps_buckets_apart():
    """Buckets whose scores pack at their own tv but not at the merged
    one's stay separate launches."""
    bk = [sched._Bucket([0], np.array([100], np.int32),
                        np.array([100], np.int32), np.array([100]),
                        "strips"),
          sched._Bucket([1], np.array([3000], np.int32),
                        np.array([3000], np.int32), np.array([3000]),
                        "strips")]
    assert len(sched._merged_strips(bk, MAT, 4, 2)) == 1
    big = simple_mat(5, 44, 4)          # 44 * 3000 >= 2 ** 17
    assert not S.packing_fits([3000], [3000], big, 4, 2, 3072)
    assert S.packing_fits([100], [100], big, 4, 2, 128)
    assert len(sched._merged_strips(bk, big, 4, 2)) == 2


def test_cigar_and_splice_batches_keep_their_buckets():
    """CIGAR launches keep one launch a bucket (d8 would grow with the
    merged Lq x tv), and so does the splice path."""
    pairs = _pairs(65, (150, 700, 1400))
    seen = []
    fn = sched.strips_cigar_launch
    with mock.patch.object(sched, "strips_cigar_launch",
                           lambda ln, *a: seen.append(ln) or fn(ln, *a)):
        Aligner(device="cpu", zdrop=100).extend_batch(pairs)
    assert len(seen) == 3
