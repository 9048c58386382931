"""The port's strips walker and CIGAR assembly against the JAX package.

``strips_walk_plain`` (the CUDA walker's plain twin) followed by
``finish_runs_batch`` is held against the JAX strips CIGAR route run
under the Pallas interpreter and against the byte-exact NumPy spec
``spec/strips_cigar.py:strips_extz_cigar``: the 9 ez fields, reach_end
and the BAM CIGAR words, exactly.  The CUDA walker's own test, which
needs a card, is in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import strips_walker as jsw
from ksw2_tpu.spec.strips_cigar import strips_extz_cigar

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.ops import strips as S
from ksw2_tpu_torch.ops import strips_walker as W

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, -4)


def _pairs(seed, spec):
    rng = np.random.default_rng(seed)
    out = []
    for L, div, ind in spec:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=ind,
                                  with_n=True)
        out.append((encode_dna(q), encode_dna(t)))
    return out


PAIRS = ((220, 0.25, 0.12), (300, 0.1, 0.05), (150, 0.4, 0.2),
         (260, 0.55, 0.3), (1, 0.0, 0.0), (129, 0.05, 0.02))


def _port(pairs, mat, q, e, zdrop, flag, end_bonus=0):
    ql = np.array([len(x) for x, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = S.strips_prep([x for x, _ in pairs], [t for _, t in pairs], ql,
                          tl, 5, mat, q, e, zdrop, flag, cig=True)
    rec, res, runs = W.strips_cigar_launch(ln, end_bonus, "cpu")
    return W.unpack_cigars(rec.numpy(), res.numpy(), runs.numpy(), mat, q,
                           e, end_bonus, flag)


def _fields(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, bool(ez.zdropped))


def _spec_fields(ez):
    return (ez["max"], ez["max_t"], ez["max_q"], ez["mqe"], ez["mqe_t"],
            ez["mte"], ez["mte_q"], ez["score"], bool(ez["zdropped"]))


@pytest.mark.parametrize("flag,zdrop,end_bonus", [
    (Flag.NONE, 100, 0), (Flag.RIGHT, 100, 0), (Flag.NONE, 25, 0),
    (Flag.REV_CIGAR, -1, 0), (Flag.EXTZ_ONLY, 30, 20),
    (Flag.EXTZ_ONLY | Flag.RIGHT, 100, 0)])
def test_walker_matches_spec(flag, zdrop, end_bonus):
    pairs = _pairs(7, PAIRS)
    got = _port(pairs, MAT, 4, 2, zdrop, flag, end_bonus)
    for p, (q, t) in enumerate(pairs):
        ez, cig = strips_extz_cigar(q, t, 5, MAT, 4, 2, zdrop=zdrop,
                                    end_bonus=end_bonus, flag=flag)
        assert _fields(got[p]) == _spec_fields(ez), p
        assert got[p].cigar == cig, (p, got[p].cigar_string())


@pytest.mark.parametrize("flag,zdrop", [(Flag.NONE, 30), (Flag.RIGHT, -1),
                                        (Flag.REV_CIGAR, 100)])
def test_walker_matches_jax_route(flag, zdrop):
    pairs = _pairs(21, PAIRS[:4])
    B = len(pairs)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    Q = np.zeros((B, ql.max()), np.int32)
    T = np.zeros((B, tl.max()), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)], T[i, :len(t)] = q, t
    want = jsw.strips_cigar_align(Q, T, ql, tl, 5, MAT, 4, 2, zdrop=zdrop,
                                  flag=flag, interpret=True)
    got = _port(pairs, MAT, 4, 2, zdrop, flag)
    for g, w in zip(got, want):
        assert _fields(g) == _fields(w)
        assert (g.reach_end, g.cigar) == (w.reach_end, w.cigar)


def test_degenerate_scoring_resets_without_cigar():
    pairs = _pairs(3, PAIRS[:3])
    for flag in (Flag.NONE, Flag.EXTZ_ONLY, Flag.SCORE_ONLY):
        # b = 20: -min_sc > 2 * (q + e)
        aln = Aligner(a=1, b=20, q=4, e=2, zdrop=100, flag=flag,
                      device="cpu")
        for ez in aln.extend_batch(pairs):
            assert _fields(ez) == (0, -1, -1, -(1 << 30), -1, -(1 << 30),
                                   -1, -(1 << 30), False)
            assert ez.cigar == [] and not ez.reach_end


@pytest.mark.parametrize("seed", range(3))
def test_finish_runs_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, W_ = 6, 12
    runs = (rng.integers(1, 20, (B, W_)) << 4) | rng.integers(0, 3, (B, W_))
    counts = rng.integers(0, W_ + 1, B)
    i_end = rng.integers(-1, 5, B)
    j_end = rng.integers(-1, 5, B)
    for rev in (False, True):
        assert W.finish_runs_batch(runs, counts, i_end, j_end, 0, rev) == \
            jsw.finish_runs_batch(runs, counts, i_end, j_end, 0, rev)

