"""The port's band forward and walker against the JAX band engines and
the spec: records.

``ops.band.band_forward_plain`` (records) is held against
``ksw2_tpu.ops.band_batch.extz_band_batch_device`` /
``extd_band_batch_device`` run under the Pallas interpreter and against
``spec.diagdiff.extz2`` / ``extd2``, on the cases of tests/test_band.py;
tests/test_torch_band_cigar.py does the same for CIGARs.  All
comparisons are exact.  The CUDA kernels' own tests,
which need a card, are in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import band_batch as jband
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import band_walker as BW
from ksw2_tpu_torch.ops import bands

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
GMAT = np.array([[3, -2, -4, -3, 0],
                 [-3, 2, -2, -4, 0],
                 [-4, -2, 4, -1, 0],
                 [-2, -3, -1, 2, 0],
                 [0, 0, 0, 0, 0]], np.int8).reshape(-1)
EXTD = (4, 2, 13, 1)
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")


def _mk(seed, B, tlo, thi, div, ind, asym=0, with_n=False):
    """tests/test_band.py's pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        tl = int(rng.integers(tlo, thi))
        t, q = refcmp.random_pair(rng, tl, divergence=div, indel=ind,
                                  with_n=with_n)
        if asym:
            q = q[:max(10, len(q) - int(rng.integers(0, asym)))]
        pairs.append((encode_dna(q), encode_dna(t)))
    return pairs, rng


def _padded(pairs):
    B = len(pairs)
    Q = np.zeros((B, max(len(q) for q, _ in pairs)), np.int32)
    T = np.zeros((B, max(len(t) for _, t in pairs)), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)], T[i, :len(t)] = q, t
    return (Q, T, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def _port(pairs, wv, zdrop, flag, costs=None, mat=MAT):
    """The port's band route on the CPU: records, or ExtzResults with
    CIGARs, straight through ops.band and ops.band_walker."""
    q, e, q2, e2 = costs or (4, 2, 0, 0)
    cig = not flag & Flag.SCORE_ONLY
    _, _, ql, tl = _padded(pairs)
    out = []
    for ln in BD.band_prep([a for a, _ in pairs], [b for _, b in pairs], ql,
                           tl, wv, 5, mat, q, e, zdrop, flag, cig=cig,
                           two=costs is not None, q2=q2, e2=e2):
        if cig:
            rec, res, runs = BW.band_cigar_launch(ln, 0, "cpu")
            out += BW.unpack_band_cigars(ln, rec.numpy(), res.numpy(),
                                         runs.numpy(), mat, 0)
        else:
            out += [tuple(int(v) for v in r)
                    for r in BD.band_records(ln, "cpu").numpy()]
    return out


def _spec(q, t, w, zdrop, flag, costs=None, mat=MAT):
    if costs:
        return diagdiff.extd2(q, t, 5, mat, *costs, w=w, zdrop=zdrop,
                              flag=flag)[0]
    return diagdiff.extz2(q, t, 5, mat, 4, 2, w=w, zdrop=zdrop,
                          flag=flag)[0]


def _fields(ez):
    return tuple(int(getattr(ez, k)) for k in FIELDS)


# (name, _mk args, w range, zdrop): the cases of tests/test_band.py
SCORE_CASES = [
    ("zdrop_off", (4, 5, 150, 450, 0.12, 0.08), (10, 64), -1),
    ("zdrop_100", (104, 5, 150, 450, 0.12, 0.08), (10, 64), 100),
    ("p2_bands", (192, 3, 300, 700, 0.12, 0.06), (70, 192), 100),
    ("p4_bands", (448, 3, 500, 900, 0.12, 0.06), (200, 448), 100),
    ("divergent_drops", (14, 5, 250, 550, 0.35, 0.15), (10, 120), 25),
    ("asymmetric_empty_band", (15, 5, 250, 550, 0.2, 0.1, 180), (10, 120),
     30),
    ("tiny_pairs_with_n", (17, 6, 20, 200, 0.25, 0.12, 0, True), (1, 40),
     40),
]


# tests/test_band.py's two-piece cases: zdrop -1/100 and divergent P = 2
EXTD_CASES = SCORE_CASES[:2] + [
    ("p2_divergent_drops", (25, 3, 300, 800, 0.3, 0.12), (70, 192), 30)]


@pytest.mark.parametrize("case,two", [(c, False) for c in SCORE_CASES] +
                         [(c, True) for c in EXTD_CASES],
                         ids=[f"extz-{c[0]}" for c in SCORE_CASES] +
                         [f"extd-{c[0]}" for c in EXTD_CASES])
def test_band_records_match_jax_and_spec(case, two):
    _, mk, (wlo, whi), zdrop = case
    pairs, rng = _mk(*mk)
    wv = rng.integers(wlo, whi, len(pairs)).astype(np.int32)
    costs = EXTD if two else None
    got = _port(pairs, wv, zdrop, Flag.SCORE_ONLY, costs)
    Q, T, ql, tl = _padded(pairs)
    if two:
        jx = jband.extd_band_batch_device(Q, T, ql, tl, 5, MAT, *EXTD, wv,
                                          zdrop=zdrop, flag=Flag.SCORE_ONLY,
                                          interpret=True)
    else:
        jx = jband.extz_band_batch_device(Q, T, ql, tl, 5, MAT, 4, 2, wv,
                                          zdrop=zdrop, flag=Flag.SCORE_ONLY,
                                          interpret=True)
    for i, (q, t) in enumerate(pairs):
        want = _fields(_spec(q, t, int(wv[i]), zdrop, Flag.SCORE_ONLY, costs))
        assert got[i] == want, (i, int(wv[i]))
        assert tuple(int(jx[k][i]) for k in FIELDS) == want, i


@pytest.mark.parametrize("costs,post", [
    ((13, 1, 4, 2), (4, 2, 13, 1, 14, 8, -2)),
    ((4, 1, 13, 2), (4, 1, 13, 2, 5, -10, -1)),
], ids=["pre_swap", "e_below_e2"])
def test_band_records_pre_swap_costs(costs, post):
    """q+e > q2+e2 swaps the pieces and keeps the pre-swap H seed; e < e2
    after the swap needs C's truncating long_thres (ksw2_extd2_sse.c:
    68-92), which the strips route never sees."""
    pairs, rng = _mk(28, 3, 150, 450, 0.2, 0.1)
    wv = rng.integers(10, 100, len(pairs)).astype(np.int32)
    got = _port(pairs, wv, 60, Flag.SCORE_ONLY, costs)
    Q, T, ql, tl = _padded(pairs)
    jx = jband.extd_band_batch_device(Q, T, ql, tl, 5, MAT, *costs, wv,
                                      zdrop=60, flag=Flag.SCORE_ONLY,
                                      interpret=True)
    prm = BD.make_band_params(5, MAT, *costs[:2], 60, Flag.SCORE_ONLY,
                              two=True, q2=costs[2], e2=costs[3])
    assert (prm.q, prm.e, prm.q2, prm.e2, prm.qe_pre, prm.lt,
            prm.ld) == post
    for i, (q, t) in enumerate(pairs):
        want = _fields(_spec(q, t, int(wv[i]), 60, Flag.SCORE_ONLY, costs))
        assert got[i] == want == tuple(int(jx[k][i]) for k in FIELDS), i


@pytest.mark.parametrize("zdrop,flag", [
    (-1, Flag.SCORE_ONLY | Flag.APPROX_MAX),
    (-1, Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP),
    (40, Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP),
])
def test_band_approx_records_match_jax_and_spec(zdrop, flag):
    pairs, rng = _mk(41 + zdrop, 4, 150, 500, 0.2, 0.1)
    wv = rng.integers(10, 64, len(pairs)).astype(np.int32)
    Q, T, ql, tl = _padded(pairs)
    jz = jband.extz_band_batch_device(Q, T, ql, tl, 5, MAT, 4, 2, wv,
                                      zdrop=zdrop, flag=flag, interpret=True)
    jd = jband.extd_band_batch_device(Q, T, ql, tl, 5, MAT, *EXTD, wv,
                                      zdrop=zdrop, flag=flag, interpret=True)
    for costs, jx in ((None, jz), (EXTD, jd)):
        got = _port(pairs, wv, zdrop, flag, costs)
        for i, (q, t) in enumerate(pairs):
            want = _fields(_spec(q, t, int(wv[i]), zdrop, flag, costs))
            assert got[i] == want, (costs, i)
            # the JAX records agree on the fields its test pins
            assert [int(jx[k][i]) for k in ("score", "max", "max_t", "max_q",
                                            "zdropped")] == \
                [want[7], want[0], want[1], want[2], want[8]], (costs, i)


def test_band_bookkeeping_matches_jax():
    from ksw2_tpu.ops import bands as jbands

    rng = np.random.default_rng(3)
    for _ in range(200):
        ql, tl = (int(v) for v in rng.integers(1, 400, 2))
        w = int(rng.integers(0, 500))
        nd = ql + tl - 1
        for a, b in zip(bands.band_bounds_rounded(nd, ql, tl, w),
                        jbands.band_bounds_rounded(nd, ql, tl, w)):
            assert np.array_equal(a, b)
        assert bands.n_col_bytes(ql, tl, w) == jbands.n_col_bytes(ql, tl, w)
        st0, en0 = bands.band_bounds(nd, ql, tl, w)
        empty = np.nonzero(st0 > en0)[0]
        assert int(bands.first_empty_diag(ql, tl, w)) == \
            (int(empty[0]) if empty.size else nd)


def test_band_forward_refuses_what_the_kernel_does_not_take():
    pairs, _ = _mk(5, 2, 100, 200, 0.1, 0.05)
    (ln,) = BD.band_prep([a for a, _ in pairs], [b for _, b in pairs],
                         *_padded(pairs)[2:], [30, 30], 5, MAT, 4, 2, -1,
                         Flag.SCORE_ONLY)
    args = BD.band_upload(ln, "cpu")
    with pytest.raises(ValueError, match="device"):
        BD.band_forward(*(t.to("meta") for t in args), ln.prm, ln.nd,
                        ln.ncol)
    with pytest.raises(ValueError, match="CUDA"):
        BD.band_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
    rec, p = BD.band_forward(*args, ln.prm, ln.nd, ln.ncol)
    assert rec.dtype == torch.int32 and rec.shape == (2, 9) and p is None
