"""Batched local alignment (kernel 18's plain version) against the JAX
package and the oracle.

The port's ``local_batch_device(..., device="cpu")``, which runs the
plain version ``local_forward_plain``, is held against the JAX
package's ``local_batch_device(..., interpret=True)`` (as
``tests/test_local.py`` runs it) and against the port's copy of the NumPy
oracle ``spec/local.py`` (itself against the JAX package's copy), on
seeded inputs: the ``test_local.py`` seeds, queries over 128 bp, empty,
all-N and all-mismatch pairs, tied maxima, targets of exactly 128 and
over, more than the JAX function's 512 pairs a launch, a matrix that is
not simple, the JAX bench's anchor and local-mixed's pin.  Every
comparison is exact in all three fields (score, te, qe).
"""
import numpy as np
import pytest
import torch

import chip_smoke
import refcmp
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import batch_local as jbl
from ksw2_tpu.spec.local import local_align as j_local_align

from ksw2_tpu_torch import convert
from ksw2_tpu_torch.ops import batch_local as BL
from ksw2_tpu_torch.spec.local import local_align

torch.set_num_threads(1)
MAT = simple_mat(5, 2, 4)
FIELDS = ("score", "te", "qe")


def _both(Q, T, ql, tl, mat=MAT, q=4, e=2):
    """The JAX function in interpret mode and the port's on the CPU, held
    equal; returns the port's result."""
    j = jbl.local_batch_device(Q, T, ql, tl, 5, mat, q, e, interpret=True)
    p = BL.local_batch_device(Q, T, ql, tl, 5, mat, q, e, device="cpu")
    for k in FIELDS:
        assert p[k].dtype == np.int32
        assert np.array_equal(p[k], j[k]), k
    return p


def _triples(out):
    return [tuple(int(out[k][i]) for k in FIELDS)
            for i in range(len(out["score"]))]


def _oracle(Q, T, ql, tl, mat=MAT, q=4, e=2, idx=None):
    idx = range(len(ql)) if idx is None else idx
    return [local_align(Q[i, :ql[i]], T[i, :tl[i]], 5, mat, q, e)
            for i in idx]


def _pad(pairs, Lt=128):
    Lq = max([len(q) for q, _ in pairs] + [1])
    Q = np.zeros((len(pairs), Lq), np.int32)
    T = np.zeros((len(pairs), Lt), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    return (Q, T, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def _draws(seed, B, flank=0):
    """``tests/test_local.py``'s draws; ``flank`` > 0 sets each query in
    random flanks up to ``flank`` bp."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        tlen = int(rng.integers(8, 128))
        t, q = refcmp.random_pair(
            rng, tlen, divergence=float(rng.uniform(0, 0.5)),
            indel=float(rng.uniform(0, 0.25)),
            with_n=bool(rng.integers(0, 2)))
        q = encode_dna(q)
        if flank:
            pad = rng.integers(0, 4, int(rng.integers(129, flank + 1))
                               - len(q))
            at = int(rng.integers(0, len(pad) + 1))
            q = np.concatenate([pad[:at], q, pad[at:]])
        pairs.append((q, encode_dna(t)))
    return _pad(pairs)


@pytest.mark.parametrize("seed", [1, 9])
def test_local_batch_matches_jax_and_oracle(seed):
    arrays = _draws(seed, 12)
    assert _triples(_both(*arrays)) == _oracle(*arrays)


@pytest.mark.parametrize("seed", [3, 4])
def test_queries_over_128(seed):
    """Queries have no cap: 129-400 bp against targets of up to 128."""
    arrays = _draws(seed, 6, flank=400)
    assert arrays[2].min() > 128 and arrays[1].shape[1] == 128
    assert _triples(_both(*arrays)) == _oracle(*arrays)


@pytest.mark.parametrize("ql,tl", [(0, 50), (50, 0), (0, 0)])
def test_empty_pairs(ql, tl):
    rng = np.random.default_rng(ql + 2 * tl)
    arrays = _pad([(rng.integers(0, 4, ql), rng.integers(0, 4, tl)),
                   (rng.integers(0, 4, 30), rng.integers(0, 4, 30))])
    out = _triples(_both(*arrays))
    assert out[0] == (0, -1, -1)
    assert out == _oracle(*arrays)


@pytest.mark.parametrize("q,t", [(np.full(90, 4), np.arange(128) % 4),
                                 (np.zeros(70, np.int64), np.full(128, 2))],
                         ids=["all_n", "all_mismatch"])
def test_nothing_above_zero(q, t):
    arrays = _pad([(q, t)])
    assert _triples(_both(*arrays)) == [(0, -1, -1)] == _oracle(*arrays)


def test_tied_maxima_take_the_row_major_first():
    """The best cell on ties is the smallest target position, then the
    smallest query position: a target matched three times in the query,
    a query matched twice in the target, and repeats."""
    core = np.array([0, 1, 2, 3, 3, 1, 0, 2, 2, 3, 1, 0])
    gap = np.full(5, 4)
    twice = np.concatenate([core, gap, core])
    acac = np.tile([0, 1], 64)
    arrays = _pad([(np.concatenate([twice, gap, core]), core),
                   (core, twice), (acac[:60], acac[:40]),
                   (acac[:41], acac[1:128])])
    out = _triples(_both(*arrays))
    assert out[:2] == [(24, 11, 11), (24, 11, 11)]
    assert out == _oracle(*arrays)


def test_edge_pairs_of_the_smoke_run():
    """chip_smoke.local_edge_jobs, which phase 5h holds kernel 18 to:
    empty, all-N, all-mismatch, ties, one-base pairs, targets of 128 and
    queries of 129-512 bp."""
    arrays = chip_smoke.local_edge_jobs()
    assert arrays[3].max() == 128 and arrays[2].max() == 512
    assert _triples(_both(*arrays)) == _oracle(*arrays)


def test_target_width_128_and_over():
    rng = np.random.default_rng(5)
    ok = (rng.integers(0, 4, (2, 200)), rng.integers(0, 4, (2, 128)),
          np.array([200, 150], np.int32), np.array([128, 128], np.int32))
    assert _triples(_both(*ok)) == _oracle(*ok)
    wide = (ok[0], rng.integers(0, 4, (2, 129)), ok[2], ok[3])
    with pytest.raises(ValueError, match="128"):
        BL.local_batch_device(*wide, 5, MAT, 4, 2, device="cpu")
    with pytest.raises(AssertionError):
        jbl.local_batch_device(*wide, 5, MAT, 4, 2, interpret=True)
    with pytest.raises(ValueError, match="lengths"):
        BL.local_batch_device(ok[0], ok[1], np.array([201, 3]), ok[3], 5,
                              MAT, 4, 2, device="cpu")


def test_more_pairs_than_one_jax_launch():
    """600 short pairs: the JAX function splits them at 512 (``RMAX``),
    the port runs them in one launch."""
    rng = np.random.default_rng(6)
    pairs = []
    for _ in range(600):
        t, q = refcmp.random_pair(rng, int(rng.integers(8, 40)),
                                  divergence=0.2, indel=0.1, with_n=True)
        pairs.append((encode_dna(q), encode_dna(t)))
    arrays = _pad(pairs, Lt=40)
    out = _triples(_both(*arrays))
    idx = list(range(0, 600, 37)) + [511, 512, 599]
    assert [out[i] for i in idx] == _oracle(*arrays, idx=idx)


def test_non_simple_matrix_split():
    """On a matrix that is not simple the JAX kernel, and so the port,
    reads mat[0], mat[1] and mat[m*m-1] only, while the oracle reads the
    whole matrix: JAX and the port agree, the oracle differs (ROADMAP.md
    Queue 3, "Not port faults")."""
    gen = chip_smoke._generic_mat()
    arrays = _draws(11, 24)
    out = _triples(_both(*arrays, mat=gen))
    want = _oracle(*arrays, mat=gen)
    differ = [i for i in range(24) if out[i] != want[i]]
    assert len(differ) == 24
    simple = _oracle(*arrays, mat=simple_mat(5, 3, 5))
    assert _triples(BL.local_batch_device(
        *arrays, 5, simple_mat(5, 3, 5), 4, 2, device="cpu")) == simple


def test_local_params_from_jax():
    for mat, q, e in ((MAT, 4, 2), (chip_smoke._generic_mat(), 6, 1)):
        m8 = np.asarray(mat, np.int8)
        jp = jbl.LocalParams(n_rows=8, n_diag=128, m=5, sc_mch=int(m8[0]),
                             sc_mis=int(m8[1]), sc_N=int(m8[24]), q=q, e=e)
        assert convert.local_params_from_jax(jp._asdict()) == \
            BL.local_params(5, mat, q, e)


def test_spec_copy_matches_jax_spec():
    rng = np.random.default_rng(12)
    for mat in (MAT, chip_smoke._generic_mat()):
        for _ in range(6):
            q = rng.integers(0, 5, int(rng.integers(0, 60)))
            t = rng.integers(0, 5, int(rng.integers(0, 60)))
            assert local_align(q, t, 5, mat, 4, 2) == \
                j_local_align(q, t, 5, mat, 4, 2)


def test_local_512_anchor():
    """The JAX bench's local row (bench/suite.py:812-833): the JAX
    function and the port give its anchor."""
    arrays = chip_smoke.local_512_jobs()
    assert chip_smoke.local_pin(_both(*arrays)) == \
        list(chip_smoke.LOCAL_ANCHOR)


def test_local_mixed_pin():
    """chip_smoke.LOCAL_MIXED_PIN, recomputed from the JAX function on
    all 4096 pairs; the port's CPU route gives it too."""
    arrays = chip_smoke.local_mixed_jobs()
    assert arrays[2].min() >= 8 and arrays[2].max() <= 512
    assert arrays[3].min() >= 8 and arrays[3].max() <= 128
    assert chip_smoke.local_pin(_both(*arrays)) == \
        list(chip_smoke.LOCAL_MIXED_PIN)


def test_wrapper_takes_plain_version_only_on_cpu(monkeypatch):
    arrays = _draws(1, 4)
    args = [torch.from_numpy(np.ascontiguousarray(a, dt)) for a, dt in
            zip(arrays, (np.uint8, np.uint8, np.int32, np.int32))]
    prm = BL.local_params(5, MAT, 4, 2)
    assert torch.equal(BL.local_forward(*args, prm),
                       BL.local_forward_plain(*args, prm))
    with pytest.raises(ValueError, match="CUDA"):
        BL.local_forward_cuda(*args, prm)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        BL.local_batch_device(*arrays, 5, MAT, 4, 2)
