"""The port's strips forward and record replay against the JAX package.

``strips_forward_plain`` (the CUDA kernel's plain twin) is held against
the NumPy spec (``spec/strips.py``, ``spec/strips_cigar.py``) cell for
cell, and the replayed 9-field records against the JAX strips engine run
under the Pallas interpreter.  Every comparison is exact integer
equality.  The CUDA kernel's own test, which needs a card, is in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import wavefront_strips as jws
from ksw2_tpu.spec import strips as sspec
from ksw2_tpu.spec import strips_cigar as scig

from ksw2_tpu_torch.convert import strip_params_from_jax
from ksw2_tpu_torch.ops import strips as S

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, -4)
GEN = np.array([[3, -5, -2, -6, -1],
                [-5, 2, -6, -3, -1],
                [-2, -6, 4, -5, -1],
                [-6, -3, -5, 2, -1],
                [-1, -1, -1, -1, -1]], np.int8).reshape(-1)


def _pairs(seed, lens):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(
            rng, L, divergence=float(rng.uniform(0, 0.4)),
            indel=float(rng.uniform(0, 0.2)), with_n=bool(rng.integers(2)))
        out.append((encode_dna(q), encode_dna(t)))
    return out


EDGE = [(1, 1), (1, 129), (129, 1), (127, 128), (128, 128), (129, 127),
        (128, 129), (257, 130)]


def _edge_pairs(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 5, ql).astype(np.uint8),
             rng.integers(0, 5, tl).astype(np.uint8)) for ql, tl in EDGE]


def _launch(pairs, mat, flag, zdrop, cig=False):
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = S.strips_prep([q for q, _ in pairs], [t for _, t in pairs], ql,
                          tl, 5, mat, 4, 2, zdrop, flag, cig=cig)
    return ln


def _forward(ln):
    return S.strips_forward(*S.upload(ln, "cpu"), ln.prm)


@pytest.mark.parametrize("generic", [False, True])
def test_forward_plain_matches_spec_records(generic):
    pairs = _pairs(1, [300, 20, 140]) + _edge_pairs(2)
    mat = GEN if generic else MAT
    flag = Flag.SCORE_ONLY | (Flag.GENERIC_SC if generic else 0)
    ln = _launch(pairs, mat, flag, -1)
    D, Dq, hl, d8 = _forward(ln)
    assert d8 is None
    for b, (q, t) in enumerate(pairs):
        ref = sspec.strips_forward(q, t, 5, mat, 4, 2, tv=ln.prm.tv,
                                   generic=generic)
        nd = len(q) + len(t) - 1
        assert np.array_equal(D[b, :nd].numpy(), ref["D"]), b
        assert bool((D[b, nd:] == S.SENT).all()), b
        assert np.array_equal(Dq[b, :nd].numpy(), ref["Dq"]), b
        assert np.array_equal(hl[b, :len(q)].numpy(), ref["hl"]), b


@pytest.mark.parametrize("right", [False, True])
def test_forward_plain_bytes_match_spec(right):
    pairs = _pairs(3, [260, 90, 400]) + _edge_pairs(4)
    flag = Flag.RIGHT if right else Flag.NONE
    ln = _launch(pairs, MAT, flag, 100, cig=True)
    D, Dq, hl, d8 = _forward(ln)
    for b, (q, t) in enumerate(pairs):
        rec, dmat = scig.strips_forward_cigar(q, t, 5, MAT, 4, 2,
                                              right=right)
        assert np.array_equal(d8[b, :len(t), :len(q)].numpy(), dmat), b
        nd = len(q) + len(t) - 1
        assert np.array_equal(Dq[b, :nd].numpy(), rec["Dq"]), b


def _jax_records(pairs, mat, flag, zdrop):
    B = len(pairs)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    Q = np.zeros((B, ql.max()), np.int32)
    T = np.zeros((B, tl.max()), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)], T[i, :len(t)] = q, t
    assert jws.strips_eligible(ql, tl, np.maximum(ql, tl), flag, 5, mat,
                               zdrop, 4, 2)
    return np.concatenate([np.asarray(p) for p in jws.strips_records(
        Q, T, ql, tl, 5, mat, 4, 2, zdrop=zdrop, flag=flag,
        interpret=True)])


@pytest.mark.parametrize("zdrop", [-1, 30, 100])
def test_records_match_jax_strips(zdrop):
    pairs = _pairs(10 + zdrop, [330, 180, 60]) + _edge_pairs(5)[::2]
    ln = _launch(pairs, MAT, Flag.SCORE_ONLY, zdrop)
    got = S.strips_records(ln, "cpu").numpy()
    want = _jax_records(pairs, MAT, Flag.SCORE_ONLY, zdrop)
    assert got.dtype == np.int32 and got.shape == (len(pairs), 9)
    assert np.array_equal(got, want)


def test_records_match_jax_strips_generic():
    pairs = _pairs(7, [200, 150]) + _edge_pairs(8)[3:6]
    flag = Flag.SCORE_ONLY | Flag.GENERIC_SC
    ln = _launch(pairs, GEN, flag, 40)
    got = S.strips_records(ln, "cpu").numpy()
    assert np.array_equal(got, _jax_records(pairs, GEN, flag, 40))


def test_launch_params_match_jax_prep():
    pairs = _pairs(9, [300, 120, 40])
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    for mat, flag in ((MAT, Flag.SCORE_ONLY),
                      (GEN, Flag.SCORE_ONLY | Flag.GENERIC_SC | Flag.RIGHT)):
        (jl,) = jws.strips_prep([q for q, _ in pairs],
                                [t for _, t in pairs], ql, tl, 5, mat, 4,
                                2, 100, flag)
        (ln,) = S.strips_prep([q for q, _ in pairs], [t for _, t in pairs],
                              ql, tl, 5, mat, 4, 2, 100, flag)
        assert strip_params_from_jax(jl[0]._asdict()) == ln.prm
    # splice launches carry spl, the intron open q2 and long_thres; the
    # site costs semi and non are the values of their donor and acceptor
    # rows
    from ksw2_tpu.ops.strips_walker import strips_exts_cigar_prep
    smat = simple_mat(5, 1, 2)
    for flag in (Flag.SPLICE_FOR,
                 Flag.SPLICE_FOR | Flag.SPLICE_FLANK | Flag.SCORE_ONLY):
        cig = not flag & Flag.SCORE_ONLY
        args = ([q for q, _ in pairs], [t for _, t in pairs], ql, tl, 5,
                smat, 2, 1, 32, 9, 200, flag)
        jl = strips_exts_cigar_prep(*args, cig=cig)
        (ln,) = S.strips_exts_prep(*args, cig=cig)
        jp = jl[0][0]
        assert strip_params_from_jax(jp._asdict()) == ln.prm
        assert ln.prm.spl == 1 and jp.non == -9
        for rows in (ln.don, ln.acc):
            assert set(np.unique(rows)) <= {0, jp.semi, jp.non}
            assert jp.non in rows


def test_eligibility_matches_jax():
    rng = np.random.default_rng(12)
    checked = 0
    for _ in range(300):
        B = int(rng.integers(1, 4))
        ql = rng.integers(1, 5200, B)
        tl = rng.integers(1, 3600, B)
        w = np.where(rng.random(B) < 0.3, rng.integers(1, 400, B),
                     np.maximum(ql, tl))
        flag = int(rng.choice([Flag.SCORE_ONLY,
                               Flag.SCORE_ONLY | Flag.APPROX_MAX,
                               Flag.SCORE_ONLY | Flag.RIGHT]))
        m = int(rng.choice([5, 9]))
        mat = MAT if m == 5 else np.ones(81, np.int8)
        if rng.random() < 0.2:
            mat = (MAT * 20).astype(np.int8)
        q, e = int(rng.integers(0, 30)), int(rng.integers(1, 12))
        want = jws.strips_eligible(ql, tl, w, flag, m, mat, 100, q, e)
        assert S.strips_eligible(ql, tl, w, flag, m, mat, 100, q, e) == want
        checked += want
    assert checked > 20


def test_forward_dispatch_by_device():
    ln = _launch(_pairs(13, [50]), MAT, Flag.SCORE_ONLY, -1)
    args = S.upload(ln, "cpu")
    a = S.strips_forward(*args, ln.prm)
    b = S.strips_forward_plain(*args, ln.prm)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    with pytest.raises(ValueError, match="device"):
        S.strips_forward(*(t.to("meta") for t in args), ln.prm)

