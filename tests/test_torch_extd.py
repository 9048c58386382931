"""The port's two-piece (extd) strips route against the JAX package.

``strips_forward_plain`` with ``two`` (kernel A's plain twin) is held
cell for cell against the NumPy spec (``spec/strips_extd.py`` for the
record streams, ``spec/strips_cigar.py`` for the 7-bit bytes); the
replayed records against the JAX ``strips_extd_records`` run under the
Pallas interpreter; ``strips_walk_plain`` on 7-bit bytes against the
spec's ``strips_extd_cigar``; and ``Aligner(q2=..., e2=...)`` end to end
against ``ksw2_tpu.Aligner`` and the reference-binary golden corpus.
Every comparison is exact integer equality.  Costs (4, 2, 13, 1) are
minimap2's defaults, which do not swap; (24, 1, 4, 2) swap, giving
``off0 = -19``.
"""
import json
import os

import numpy as np
import pytest
import torch

import ksw2_tpu
import refcmp
from ksw2_tpu.batch.scheduler import AlignJob as JAlignJob
from ksw2_tpu.batch.scheduler import align_batch_scores2_async as j_async2
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import wavefront_strips as jws
from ksw2_tpu.spec import strips_cigar as scig
from ksw2_tpu.spec import strips_extd as sextd

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch.scheduler import (AlignJob,
                                            align_batch_scores2_async)
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.convert import aligner_from_jax, strip_params_from_jax
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import strips as S
from ksw2_tpu_torch.ops import strips_walker as W

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, -4)
GEN = np.array([[3, -5, -2, -6, -1],
                [-5, 2, -6, -3, -1],
                [-2, -6, 4, -5, -1],
                [-6, -3, -5, 2, -1],
                [-1, -1, -1, -1, -1]], np.int8).reshape(-1)
DEFAULT = (4, 2, 13, 1)
SWAPPED = (24, 1, 4, 2)
EDGE = [(1, 1), (1, 129), (129, 1), (127, 128), (128, 128), (129, 127),
        (128, 129), (257, 130)]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")


def _pairs(seed, lens):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(
            rng, L, divergence=float(rng.uniform(0, 0.4)),
            indel=float(rng.uniform(0, 0.2)), with_n=bool(rng.integers(2)))
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _edge_pairs(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 5, ql).astype(np.uint8),
             rng.integers(0, 5, tl).astype(np.uint8)) for ql, tl in EDGE]


def _launch(pairs, mat, flag, zdrop, costs, cig=False):
    q, e, q2, e2 = costs
    ql = np.array([len(x) for x, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = S.strips_prep([x for x, _ in pairs], [t for _, t in pairs], ql,
                          tl, 5, mat, q, e, zdrop, flag, cig=cig, two=True,
                          q2=q2, e2=e2)
    return ln


def _forward(ln):
    return S.strips_forward(*S.upload(ln, "cpu"), ln.prm)


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, bool(ez.zdropped), ez.reach_end, ez.cigar)


@pytest.mark.parametrize("costs", [DEFAULT, SWAPPED])
def test_prep_params_match_jax(costs):
    pairs = _pairs(9, [300, 120, 40])
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    q, e, q2, e2 = costs
    for mat, flag in ((MAT, Flag.SCORE_ONLY),
                      (GEN, Flag.SCORE_ONLY | Flag.GENERIC_SC | Flag.RIGHT)):
        (jl,) = jws.strips_prep([x for x, _ in pairs],
                                [t for _, t in pairs], ql, tl, 5, mat, q, e,
                                100, flag, two=True, q2=q2, e2=e2)
        ln = _launch(pairs, mat, flag, 100, costs)
        assert strip_params_from_jax(jl[0]._asdict()) == ln.prm
    assert ln.prm.off0 == (0 if costs == DEFAULT else -19)
    assert (ln.prm.lt, ln.prm.ld) == sextd.long_params(
        ln.prm.q, ln.prm.e, ln.prm.q2, ln.prm.e2)


@pytest.mark.parametrize("costs", [DEFAULT, SWAPPED])
@pytest.mark.parametrize("generic", [False, True])
def test_forward_plain_matches_spec_records(costs, generic):
    pairs = _pairs(1, [300, 20, 140]) + _edge_pairs(2)
    mat = GEN if generic else MAT
    flag = Flag.SCORE_ONLY | (Flag.GENERIC_SC if generic else 0)
    ln = _launch(pairs, mat, flag, -1, costs)
    p = ln.prm
    D, Dq, hl, d8 = _forward(ln)
    assert d8 is None
    for b, (q, t) in enumerate(pairs):
        ref = sextd.strips_forward_extd(q, t, 5, mat, p.q, p.e, p.q2, p.e2,
                                        tv=p.tv, generic=generic)
        nd = len(q) + len(t) - 1
        assert np.array_equal(D[b, :nd].numpy(), ref["D"]), b
        assert bool((D[b, nd:] == S.SENT).all()), b
        assert np.array_equal(Dq[b, :nd].numpy(), ref["Dq"]), b
        assert np.array_equal(hl[b, :len(q)].numpy(), ref["hl"]), b


@pytest.mark.parametrize("costs", [DEFAULT, SWAPPED])
@pytest.mark.parametrize("right", [False, True])
def test_forward_plain_bytes_match_spec(costs, right):
    pairs = _pairs(3, [260, 90, 400]) + _edge_pairs(4)
    flag = Flag.RIGHT if right else Flag.NONE
    ln = _launch(pairs, MAT, flag, 100, costs, cig=True)
    p = ln.prm
    D, Dq, hl, d8 = _forward(ln)
    for b, (q, t) in enumerate(pairs):
        rec, dmat = scig.strips_forward_cigar_extd(
            q, t, 5, MAT, p.q, p.e, p.q2, p.e2, right=right)
        assert np.array_equal(d8[b, :len(t), :len(q)].numpy(), dmat), b
        nd = len(q) + len(t) - 1
        assert np.array_equal(Dq[b, :nd].numpy(), rec["Dq"]), b
        assert np.array_equal(hl[b, :len(q)].numpy(), rec["hl"]), b


def _jax_records(pairs, mat, flag, zdrop, costs):
    B = len(pairs)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    Q = np.zeros((B, ql.max()), np.int32)
    T = np.zeros((B, tl.max()), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)], T[i, :len(t)] = q, t
    assert jws.strips_extd_eligible(ql, tl, np.maximum(ql, tl), flag, 5,
                                    mat, zdrop, *costs)
    return np.concatenate([np.asarray(p) for p in jws.strips_extd_records(
        Q, T, ql, tl, 5, mat, *costs, zdrop=zdrop, flag=flag,
        interpret=True)])


@pytest.mark.parametrize("costs", [DEFAULT, SWAPPED])
@pytest.mark.parametrize("zdrop", [-1, 30, 100])
def test_records_match_jax_strips_extd(costs, zdrop):
    pairs = _pairs(20 + zdrop, [330, 180, 60]) + _edge_pairs(5)[::2]
    ln = _launch(pairs, MAT, Flag.SCORE_ONLY, zdrop, costs)
    got = S.strips_records(ln, "cpu").numpy()
    want = _jax_records(pairs, MAT, Flag.SCORE_ONLY, zdrop, costs)
    assert got.dtype == np.int32 and got.shape == (len(pairs), 9)
    assert np.array_equal(got, want)


def test_records_match_jax_strips_extd_generic():
    pairs = _pairs(7, [200, 150]) + _edge_pairs(8)[3:6]
    flag = Flag.SCORE_ONLY | Flag.GENERIC_SC
    ln = _launch(pairs, GEN, flag, 40, DEFAULT)
    got = S.strips_records(ln, "cpu").numpy()
    assert np.array_equal(got, _jax_records(pairs, GEN, flag, 40, DEFAULT))


PAIRS = ((220, 0.25, 0.12), (300, 0.1, 0.05), (150, 0.4, 0.2),
         (260, 0.55, 0.3), (1, 0.0, 0.0), (129, 0.05, 0.02))


def _walk_pairs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for L, div, ind in PAIRS:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=ind,
                                  with_n=True)
        out.append((encode_dna(q), encode_dna(t)))
    return out


@pytest.mark.parametrize("costs", [DEFAULT, SWAPPED])
@pytest.mark.parametrize("flag,zdrop,end_bonus", [
    (Flag.NONE, 100, 0), (Flag.RIGHT, 100, 0), (Flag.NONE, 25, 0),
    (Flag.REV_CIGAR, -1, 0), (Flag.EXTZ_ONLY, 30, 20)])
def test_walker_on_7bit_bytes_matches_spec(costs, flag, zdrop, end_bonus):
    pairs = _walk_pairs(7)
    ln = _launch(pairs, MAT, flag, zdrop, costs, cig=True)
    rec, res, runs = W.strips_cigar_launch(ln, end_bonus, "cpu")
    got = W.unpack_cigars(rec.numpy(), res.numpy(), runs.numpy(), MAT,
                          ln.prm.q, ln.prm.e, end_bonus, flag)
    for p, (q, t) in enumerate(pairs):
        ez, cig = scig.strips_extd_cigar(q, t, 5, MAT, *costs, zdrop=zdrop,
                                         end_bonus=end_bonus, flag=flag)
        assert _row(got[p])[:9] == (
            ez["max"], ez["max_t"], ez["max_q"], ez["mqe"], ez["mqe_t"],
            ez["mte"], ez["mte_q"], ez["score"], bool(ez["zdropped"])), p
        assert got[p].cigar == cig, (p, got[p].cigar_string())


def _mixed(seed=11, n=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(20, 360))
        t, q = refcmp.random_pair(rng, L, divergence=float(rng.uniform(0, .3)),
                                  indel=float(rng.uniform(0, .15)),
                                  with_n=True)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _cfg(jal):
    return {"m": jal.m, "mat": np.asarray(jal.mat), "q": jal.q, "e": jal.e,
            "w": jal.w, "zdrop": jal.zdrop, "end_bonus": jal.end_bonus,
            "flag": int(jal.flag), "q2": jal.q2, "e2": jal.e2,
            "splice": jal.splice}


@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY, Flag.NONE])
@pytest.mark.parametrize("zdrop", [-1, 100])
def test_slice_matches_jax_aligner_extd(flag, zdrop):
    pairs = _mixed(30 + zdrop)
    jal = ksw2_tpu.Aligner(a=2, b=4, q=4, e=2, q2=13, e2=1, zdrop=zdrop,
                           flag=flag)
    port = aligner_from_jax(_cfg(jal), device="cpu")
    assert (port.q2, port.e2) == (13, 1)
    want = jal.extend_batch(pairs)
    assert [_row(g) for g in port.extend_batch(pairs)] == \
        [_row(w) for w in want]
    h = port.extend_batch_async(pairs)
    assert [_row(g) for g in h.result()] == [_row(w) for w in want]


def test_single_pair_extend_matches_batch_extd():
    (q, t), = _mixed(13, 1)
    aln = Aligner(q2=13, e2=1, zdrop=100, flag=Flag.RIGHT, device="cpu")
    assert _row(aln.extend(q, t)) == _row(aln.extend_batch([(q, t)])[0])


def test_result_array_matches_jax_extd():
    pairs = _mixed(12, 10) + [(np.zeros(0, np.uint8), encode_dna("ACGT"))]
    jobs = [(q, t) for q, t in pairs]
    for costs in (DEFAULT, SWAPPED):
        want = j_async2([JAlignJob(q, t) for q, t in jobs], 5, MAT, *costs,
                        zdrop=30).result_array()
        got = align_batch_scores2_async([AlignJob(q, t) for q, t in jobs],
                                        5, MAT, *costs, zdrop=30,
                                        device="cpu").result_array()
        assert got.dtype == np.int32 and np.array_equal(got, want), costs


def test_swapped_degenerate_job_matches_jax():
    # q=24, e=1, q2=4, e2=2 and a mismatch of -20: the job is not reset
    # (20 <= 2 * (24 + 1)) but the handle's guard on the cheaper arm
    # trips (20 > 2 * (4 + 2)), so every record reads as reset
    mat = simple_mat(5, 1, -20)
    pairs = _mixed(15, 3)
    jobs = [JAlignJob(q, t) for q, t in pairs]
    want = j_async2(jobs, 5, mat, *SWAPPED, zdrop=100)
    got = align_batch_scores2_async([AlignJob(q, t) for q, t in pairs], 5,
                                    mat, *SWAPPED, zdrop=100, device="cpu")
    assert np.array_equal(got.result_array(), want.result_array())
    for flag in (Flag.SCORE_ONLY, Flag.NONE):
        port = Aligner(a=1, b=20, q=24, e=1, q2=4, e2=2, zdrop=100,
                       flag=flag, device="cpu")
        for ez in port.extend_batch(pairs):
            assert _row(ez) == (0, -1, -1, -(1 << 30), -1, -(1 << 30), -1,
                                -(1 << 30), False, False, [])


def _golden_extd():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    return [c for c in cases if c["algo"] == "extd2_sse"
            and not c["params"]["approx"]]


def _golden_aligner(p):
    flag = (Flag.RIGHT if p["right"] else Flag.NONE) | \
        (Flag.SCORE_ONLY if p["score_only"] else Flag.NONE)
    return Aligner(a=p["a"], b=p["b"], q=p["q"], e=p["e"], q2=p["q2"],
                   e2=p["e2"], w=p["w"], zdrop=p["z"], flag=flag,
                   device="cpu")


def test_golden_extd2_cases():
    """In-envelope cases match the reference binary through the scheduler
    (``extend_batch``), on the strips route or, when strips refuses them,
    on the band route, the batched route or else the single-pair
    two-piece engine (which raised naming ROADMAP item 12b before kernel
    13 was ported), except jobs the degenerate-scoring rule resets
    before routing (pre-swap costs for SCORE_ONLY, post-swap for
    CIGARs), which match the reference's reset record."""
    from ksw2_tpu_torch.ops.batch import batch_ineligible_reason

    inside = outside = reset = band = batch = 0
    for c in _golden_extd():
        p = c["params"]
        ql, tl = len(c["query"]), len(c["target"])
        w = p["w"] if p["w"] >= 0 else max(ql, tl)
        mat = simple_mat(5, p["a"], -p["b"])
        aln = _golden_aligner(p)
        reason = ql and tl and S.strips_extd_ineligible_reason(
            [ql], [tl], [w], Flag.SCORE_ONLY, 5, mat, p["z"], p["q"],
            p["e"], p["q2"], p["e2"])
        if reason:
            qc, ec = S.canonical_costs(p["q"], p["e"], p["q2"], p["e2"])[:2]
            qe = p["q"] + p["e"] if p["score_only"] else qc + ec
            Lt = sched._bucket_key(ql, tl)[1]
            if p["b"] > 2 * qe:
                reset += 1
            elif BD.band_ineligible_reason(
                    Lt, [ql], [tl], [w if p["score_only"] else p["w"]], mat,
                    aln.flag, cigar=not p["score_only"], two=True) is None:
                band += 1
            elif batch_ineligible_reason(
                    Lt, [ql], [tl], mat, aln.flag, p["z"],
                    cigar=not p["score_only"], two=True) is None:
                batch += 1
            else:
                outside += 1
        else:
            inside += 1
        got = aln.extend_batch([(c["query"], c["target"])])[0].tsv_fields()
        if c.get("fields_only"):
            got = got[:4]
        assert got == c["expect"], (p, c["query"], c["target"])
    assert inside >= 20 and batch >= 10 and reset >= 1 and band >= 1
