"""The port's splice pieces against the JAX package and the spec: the
donor/acceptor site profiles, the strips forward's ``spl`` form and the
strips walker's ``nop`` form.

``ops.splice.splice_profiles`` is held against
``ksw2_tpu.ops.batch_pallas.splice_profiles_batch``, the spec's
``diagdiff._splice_profiles`` and (unwrapped) the JAX strips route's site
classes ``strips_walker._splice_classes_batch``.  The strips launches of
``ops.strips.strips_exts_prep`` run the plain forward and walker on CPU
tensors; their records, direction bytes and N-op CIGARs are held against
the JAX strips exts route under the Pallas interpreter
(``strips_exts_cigar_batch``), ``spec/strips_cigar.py:strips_exts_cigar``
and ``spec/diagdiff.py:exts2`` (whose kept trace gives the reference's
bytes).  The CUDA kernels' own tests, which need a card, are in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from chip_smoke import spliced_pair
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.ops import batch_pallas as jbatch
from ksw2_tpu.ops import strips_walker as jsw
from ksw2_tpu.spec import diagdiff
from ksw2_tpu.spec.strips_cigar import strips_exts_cigar

from ksw2_tpu_torch.ops import strips as S
from ksw2_tpu_torch.ops import strips_walker as W
from ksw2_tpu_torch.ops.splice import semi_cost, splice_profiles

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 1, 2)
COSTS = (2, 1, 32, 9)           # -x splice: -O2,32 -E1,0, noncan 9
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")
SPL = Flag.SPLICE_FOR


def site_targets(seed, n=6, lo=8, hi=90):
    """Seeded targets rich in GT/AG/CT/AC dimers and their flanks (N
    bases included), lengths in [lo, hi), with junction tracks of random
    bits, padded to a common width."""
    rng = np.random.default_rng(seed)
    ts = [rng.choice([0, 1, 2, 3, 2, 3, 0, 4], int(rng.integers(lo, hi)))
          .astype(np.uint8) for _ in range(n)]
    ts[0] = np.array([2, 3, 0], np.uint8)          # shorter than a site
    tl = np.array([len(t) for t in ts], np.int32)
    T = np.zeros((n, int(tl.max()) + 5), np.uint8)
    J = np.zeros_like(T)
    for k, t in enumerate(ts):
        T[k, :len(t)] = t
        J[k, :len(t)] = rng.integers(0, 16, len(t))
    return T, tl, J


PROFILE_FLAGS = [SPL, Flag.SPLICE_REV, SPL | Flag.SPLICE_REV | Flag.SPLICE_FLANK,
                 SPL | Flag.REV_CIGAR,
                 Flag.SPLICE_REV | Flag.REV_CIGAR | Flag.SPLICE_FLANK,
                 Flag.NONE]


@pytest.mark.parametrize("junc_bonus", [0, 9, 150])
@pytest.mark.parametrize("flag", PROFILE_FLAGS)
def test_profiles_match_jax_and_spec(flag, junc_bonus):
    """int8 rows with the junction bits and the spec's wraparound."""
    T, tl, J = site_targets(int(flag) + junc_bonus)
    N = T.shape[1] + 3
    for noncan in (9, 200):
        don, acc = splice_profiles(T, tl, N, noncan, flag, J, junc_bonus)
        jd, ja = jbatch.splice_profiles_batch(T.astype(np.int64), tl, N,
                                              noncan, flag, J, junc_bonus)
        assert np.array_equal(don, jd) and np.array_equal(acc, ja)
        for k in range(len(tl)):
            sd, sa = diagdiff._splice_profiles(T[k, :tl[k]], int(tl[k]), N,
                                               noncan, flag, J[k, :tl[k]],
                                               junc_bonus)
            assert np.array_equal(don[k], sd) and np.array_equal(acc[k], sa)


@pytest.mark.parametrize("flag", PROFILE_FLAGS)
def test_strips_rows_are_the_jax_site_classes(flag):
    """The strips route's unwrapped rows are the JAX strips kernel's site
    classes {0, semi, -noncan}: for noncan > 128 they do not wrap, where
    the batched route's int8 rows do (ROADMAP Queue 3)."""
    T, tl, _ = site_targets(40 + int(flag))
    for noncan in (9, 200):
        don, acc = splice_profiles(T, tl, T.shape[1], noncan, flag,
                                   wrap=False)
        cls = jsw._splice_classes_batch(T, tl, noncan, flag).astype(int)
        semi = semi_cost(noncan, flag)
        if not flag & (SPL | Flag.SPLICE_REV):
            assert not cls.any() and not don.any() and not acc.any()
            continue
        vals = np.array([0, semi, -noncan])
        assert np.array_equal(don, vals[cls & 3])
        assert np.array_equal(acc, vals[cls >> 2])
        wd, _ = splice_profiles(T, tl, T.shape[1], noncan, flag)
        assert np.array_equal(wd.astype(np.int16), don) == \
            (noncan <= 128)


def splice_set(seed, n=5, lo=40, hi=250):
    """``n`` seeded spliced pairs with targets in [lo, hi) (N bases) and
    one unspliced random pair."""
    rng = np.random.default_rng(seed)
    pairs = [spliced_pair(rng, int(rng.integers(lo, hi)), with_n=True)
             for _ in range(n)]
    pairs.append((rng.integers(0, 4, 37).astype(np.uint8),
                  rng.integers(0, 4, 61).astype(np.uint8)))
    return pairs


def port_strips(pairs, zdrop, flag, mat=MAT, noncan=COSTS[3]):
    """The port's strips route on the CPU: the launch, its records, its
    bytes and the unpacked ExtzResults."""
    q, e, q2, _ = COSTS
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    (ln,) = S.strips_exts_prep([a for a, _ in pairs], [b for _, b in pairs],
                               ql, tl, 5, mat, q, e, q2, noncan, zdrop, flag,
                               cig=True)
    rec, res, runs = W.strips_cigar_launch(ln, 0, "cpu")
    d8 = S.strips_forward(*S.upload(ln, "cpu"), ln.prm,
                          S.site_rows(ln, "cpu"))[3].numpy()
    ezs = W.unpack_cigars(rec.numpy(), res.numpy(), runs.numpy(), mat, q, e,
                          0, flag, ln.prm.lt)
    return ln, rec.numpy(), d8, ezs


def fields(ez):
    return tuple(int(getattr(ez, k)) for k in FIELDS)


def padded(pairs):
    B = len(pairs)
    Q = np.zeros((B, max(len(a) for a, _ in pairs)), np.int32)
    T = np.zeros((B, max(len(b) for _, b in pairs)), np.int32)
    for k, (a, b) in enumerate(pairs):
        Q[k, :len(a)], T[k, :len(b)] = a, b
    return (Q, T, np.array([len(a) for a, _ in pairs], np.int32),
            np.array([len(b) for _, b in pairs], np.int32))


# (seed, zdrop, flag); the first two are also held against the JAX route
STRIPS_CASES = [
    (1, 200, SPL),
    (2, 30, SPL | Flag.RIGHT),
    (3, -1, SPL | Flag.SPLICE_FLANK),
    (4, 200, Flag.SPLICE_REV | Flag.REV_CIGAR),
    (5, 200, SPL | Flag.GENERIC_SC),
    (6, 200, Flag.NONE),
]


@pytest.mark.parametrize("seed,zdrop,flag", STRIPS_CASES)
def test_strips_splice_matches_spec_and_reference_bytes(seed, zdrop, flag):
    """Records and N-op CIGARs against ``strips_exts_cigar`` and
    ``exts2``; the direction bytes of every cell of the matrix against
    the reference's (``exts2``'s kept trace, rotated)."""
    pairs = splice_set(seed)
    _, rec, d8, ezs = port_strips(pairs, zdrop, flag)
    for k, (a, b) in enumerate(pairs):
        sez, scig = strips_exts_cigar(a, b, 5, MAT, *COSTS, zdrop=zdrop,
                                      flag=flag)
        ez, tr = diagdiff.exts2(a, b, 5, MAT, *COSTS, zdrop=zdrop,
                                flag=flag, keep_trace=True)
        assert tuple(int(v) for v in rec[k]) == fields(ez), k
        assert fields(ezs[k]) == fields(ez)
        assert list(ezs[k].cigar) == list(ez.cigar), k
        if not flag & Flag.GENERIC_SC:   # the strips spec reads mat[0:2]
            assert tuple(int(sez[f]) for f in FIELDS) == fields(ez), k
            assert list(scig) == list(ez.cigar), k
        # the reference's trace stops at a Z-drop: compare what it wrote
        nr = len(a) + len(b) - 1 if not ez.zdropped else ez.max_t + \
            ez.max_q + 1
        for r in range(min(nr, tr.p.shape[0])):
            st0, en0 = max(0, r - len(a) + 1), min(len(b) - 1, r)
            t = np.arange(st0, en0 + 1)
            assert np.array_equal(d8[k, t, r - t],
                                  tr.p[r, t - tr.off[r]]), (k, r)


@pytest.mark.parametrize("seed,zdrop,flag", STRIPS_CASES[:2])
def test_strips_splice_matches_jax_route(seed, zdrop, flag):
    """The 9 fields and CIGARs against the JAX strips exts route under
    the Pallas interpreter."""
    pairs = splice_set(seed)
    _, _, _, ezs = port_strips(pairs, zdrop, flag)
    jax = jsw.strips_exts_cigar_batch(*padded(pairs), 5, MAT, *COSTS,
                                      zdrop=zdrop, flag=flag, interpret=True)
    assert [fields(a) + (list(a.cigar),) for a in ezs] == \
        [fields(b) + (list(b.cigar),) for b in jax]


def test_nop_walker_emits_n_only_with_min_intron():
    """The same bytes walk to D runs with min_intron 0 and to N runs
    with min_intron = long_thres (ksw2.h:148-155)."""
    pairs = splice_set(7, n=3)
    ln, rec, _, _ = port_strips(pairs, 200, SPL)
    qs, ts, ql, tl, tab = S.upload(ln, "cpu")
    d8 = S.strips_forward(qs, ts, ql, tl, tab, ln.prm,
                          S.site_rows(ln, "cpu"))[3]
    import torch
    starts = W.start_cells(torch.from_numpy(rec), ql, tl, ln.prm.flag, 0)
    _, runs_n = W.strips_walk_plain(d8, starts, ln.prm.lt)
    _, runs_d = W.strips_walk_plain(d8, starts, 0)
    ops_n, ops_d = runs_n.numpy() & 0xF, runs_d.numpy() & 0xF
    assert (ops_n == 3).any() and not (ops_d == 3).any()
    assert np.array_equal(np.where(ops_n == 3, 2, ops_n), ops_d)
    assert [W.state_op(s, 0) for s in range(5)] == [0, 2, 1, 2, 1]
    assert [W.state_op(s, ln.prm.lt) for s in range(5)] == [0, 2, 1, 3, 1]
