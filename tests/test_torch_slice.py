"""The port's slice end to end: Aligner -> scheduler -> strips route.

``ksw2_tpu_torch.Aligner(device="cpu")``, built from a JAX-package
configuration by ``convert.aligner_from_jax``, is held against
``ksw2_tpu.Aligner.extend_batch`` (the JAX package on CPU, Pallas kernels
interpreted) on a seeded mixed batch, and against the reference-binary
golden corpus; jobs beyond the batch routes run on the single-pair
engines, and a mesh batch equals the local one.
"""
import json
import os

import numpy as np
import pytest
import torch

import ksw2_tpu
import refcmp
from ksw2_tpu.batch.scheduler import AlignJob as JAlignJob
from ksw2_tpu.batch.scheduler import align_batch_scores_async as j_async
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch.scheduler import AlignJob, align_batch_scores_async
from ksw2_tpu_torch.convert import aligner_from_jax
from ksw2_tpu_torch.ops.strips import strips_ineligible_reason
from ksw2_tpu_torch.parallel.mesh import make_mesh

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")


def _mixed(seed=11, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(20, 400))
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


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, ez.cigar)


@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY, Flag.NONE])
def test_slice_matches_jax_aligner(flag):
    pairs = _mixed()
    jal = ksw2_tpu.Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=flag)
    port = aligner_from_jax(_cfg(jal), device="cpu")
    assert port.flag == jal.flag and np.array_equal(port.mat, jal.mat)
    want = jal.extend_batch(pairs)
    got = port.extend_batch(pairs)
    assert [_row(g) for g in got] == [_row(w) for w in want]
    h = port.extend_batch_async(pairs)
    assert [_row(g) for g in h.result()] == [_row(w) for w in want]


def test_result_array_matches_jax():
    pairs = _mixed(12, 16) + [(np.zeros(0, np.uint8), encode_dna("ACGT"))]
    mat = simple_mat(5, 2, -4)
    want = j_async([JAlignJob(q, t) for q, t in pairs], 5, mat, 4, 2,
                   zdrop=30).result_array()
    got = align_batch_scores_async([AlignJob(q, t) for q, t in pairs], 5,
                                   mat, 4, 2, zdrop=30,
                                   device="cpu").result_array()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY, Flag.NONE])
def test_bucket_split_into_launches(monkeypatch, flag):
    """A bucket larger than one launch's byte budget runs as several
    launches; results land on the right jobs."""
    from ksw2_tpu_torch.ops import strips

    pairs = _mixed(14, 10)
    aln = Aligner(zdrop=100, flag=flag, device="cpu")
    whole = aln.extend_batch(pairs)
    monkeypatch.setattr(strips, "LAUNCH_BYTES", 20_000)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    assert len(strips.strips_prep([q for q, _ in pairs],
                                  [t for _, t in pairs], ql, tl, 5,
                                  aln.mat, 4, 2, 100, flag,
                                  cig=flag == Flag.NONE)) > 2
    assert [_row(g) for g in aln.extend_batch(pairs)] == \
        [_row(w) for w in whole]


def test_single_pair_extend_matches_batch():
    (q, t), = _mixed(13, 1)
    aln = Aligner(zdrop=100, flag=Flag.RIGHT, device="cpu")
    assert _row(aln.extend(q, t)) == _row(aln.extend_batch([(q, t)])[0])
    ez = aln.extend("ACGTGGTAC", "ACGTGGTTC")
    assert ez.cigar_string() == "9M" and ez.score == 12


def _golden_in_envelope():
    cases = []
    with open(GOLDEN) as f:
        for line in f:
            c = json.loads(line)
            p = c["params"]
            if c["algo"] != "extz2_sse" or p["approx"]:
                continue
            ql, tl = len(c["query"]), len(c["target"])
            if ql == 0 or tl == 0:
                continue
            w = p["w"] if p["w"] >= 0 else max(ql, tl)
            mat = simple_mat(5, p["a"], -p["b"])
            if strips_ineligible_reason([ql], [tl], [w], Flag.SCORE_ONLY, 5,
                                        mat, p["z"], p["q"], p["e"]):
                continue
            cases.append(c)
    return cases


def test_golden_extz2_cases():
    cases = _golden_in_envelope()
    assert len(cases) >= 20
    for c in cases:
        p = c["params"]
        flag = (Flag.RIGHT if p["right"] else Flag.NONE) | \
            (Flag.SCORE_ONLY if p["score_only"] else Flag.NONE)
        aln = Aligner(a=p["a"], b=p["b"], q=p["q"], e=p["e"], w=p["w"],
                      zdrop=p["z"], flag=flag, device="cpu")
        got = aln.extend(c["query"], c["target"]).tsv_fields()
        if c.get("fields_only"):
            got = got[:4]
        assert got == c["expect"], (c["params"], c["query"], c["target"])


def _spec_row(q, t, w, flag, two=False, eqx=False):
    """The spec's result at A2 B4 O4 E2 (O4,13 E2,1 two-piece), z100;
    ``eqx`` converts a one-piece CIGAR, as the batched route does."""
    from ksw2_tpu.core import cigar as jcigar
    from ksw2_tpu.spec import diagdiff

    mat = simple_mat(5, 2, -4)
    if two:
        ez = diagdiff.extd2(q, t, 5, mat, 4, 2, 13, 1, w=w, zdrop=100,
                            flag=flag)[0]
    else:
        ez = diagdiff.extz2(q, t, 5, mat, 4, 2, w=w, zdrop=100, flag=flag)[0]
    if eqx and ez.cigar:
        ez.cigar = jcigar.to_eqx(ez.cigar, q, t)
    return _row(ez)


def test_out_of_envelope_raises():
    """A mesh batch (one-piece) equals the local one and a two-piece mesh
    batch raises, as in the JAX package; global alignment runs on
    the single-pair gg2 engine; the buckets beyond the batch routes run
    on the single-pair engines
    (one-piece and two-piece CIGARs) and the any-device route (one-piece
    scores), and a one-piece ``extend`` keeps M ops under EQX, as the
    reference's extz2 and the JAX ``extend`` do; the short clipping,
    APPROX, EQX and two-piece end_bonus buckets run on the batched route;
    all match the spec."""
    q, t = encode_dna("ACGT" * 8), encode_dna("ACGA" * 8)
    aln = Aligner(zdrop=100, device="cpu")
    t3073 = encode_dna("A" * 3073)
    assert _row(aln.extend_batch([(q, t3073)])[0]) == \
        _spec_row(q, t3073, -1, Flag.NONE)
    from ksw2_tpu.spec import diagdiff
    got = Aligner(flag=Flag.SCORE_ONLY, device="cpu").extend_batch(
        [(q, t3073)])[0]
    assert _row(got) == _row(diagdiff.extz2(
        q, t3073, 5, simple_mat(5, 2, -4), 4, 2, flag=Flag.SCORE_ONLY)[0])
    assert _row(aln.extend_batch([(q, t)], w=[2])[0]) == \
        _spec_row(q, t, 2, Flag.NONE)
    flag = Flag.APPROX_MAX | Flag.SCORE_ONLY
    assert _row(Aligner(zdrop=100, flag=flag, device="cpu").extend_batch(
        [(q, t)])[0]) == _spec_row(q, t, 32, flag)
    eqx = Aligner(zdrop=100, flag=Flag.EQX, device="cpu").extend(q, t)
    assert eqx.cigar_string() == "32M"
    assert _row(eqx) == _spec_row(q, t, 32, Flag.EQX)
    assert _row(Aligner(q2=13, e2=1, zdrop=100, device="cpu").extend_batch(
        [(q, t3073)])[0]) == _spec_row(q, t3073, -1, Flag.NONE, two=True)
    with pytest.raises(ValueError, match="both q2 and e2"):
        Aligner(q2=24, device="cpu")
    bonus = Aligner(q2=24, e2=1, zdrop=100, end_bonus=5, flag=Flag.SCORE_ONLY,
                    device="cpu").extend_batch([(q, t)])
    plain = Aligner(q2=24, e2=1, zdrop=100, flag=Flag.SCORE_ONLY,
                    device="cpu").extend_batch([(q, t)])
    assert _row(bonus[0]) == _row(plain[0])
    with pytest.raises(ValueError, match="q2"):
        Aligner(splice=True, device="cpu")
    ga = aln.global_align(q, t)
    ws, wc, _ = diagdiff.gg2_sse(q, t, 5, simple_mat(5, 2, -4), 4, 2)
    assert (ga.score, ga.cigar, ga.reach_end) == (ws, list(wc), True)
    mesh = make_mesh(devices=["cpu"] * 2)
    assert [_row(ez) for ez in aln.extend_batch([(q, t)] * 3, mesh=mesh)] \
        == [_row(ez) for ez in aln.extend_batch([(q, t)] * 3)]
    with pytest.raises(ValueError, match="one-piece configurations"):
        Aligner(q2=13, e2=1, device="cpu").extend_batch([(q, t)], mesh=mesh)
    with pytest.raises(ValueError, match="splice"):
        aln.extend_batch([(q, t)], juncs=[None])


def test_two_piece_out_of_envelope_raises():
    q, t = encode_dna("ACGT" * 8), encode_dna("ACGA" * 8)
    # e < e2 after the swap: the strips chains do not decouple, and the
    # batched route takes the bucket
    got = Aligner(q=4, e=1, q2=13, e2=2, zdrop=100,
                  device="cpu").extend_batch([(q, t)])
    from ksw2_tpu.spec import diagdiff
    ez = diagdiff.extd2(q, t, 5, simple_mat(5, 2, -4), 4, 1, 13, 2, w=32,
                        zdrop=100)[0]
    assert _row(got[0]) == _row(ez)
    # SCORE_ONLY | EXTZ_ONLY and CIGARs on targets over 1536: the
    # single-pair two-piece engine
    flag = Flag.SCORE_ONLY | Flag.EXTZ_ONLY
    assert _row(Aligner(q2=13, e2=1, zdrop=100, flag=flag,
                        device="cpu").extend_batch([(q, t)])[0]) == \
        _spec_row(q, t, -1, flag, two=True)
    assert _row(Aligner(q2=13, e2=1, zdrop=100, flag=Flag.EQX,
                        device="cpu").extend(q, t)) == \
        _spec_row(q, t, 32, Flag.EQX, two=True)
    t3073 = encode_dna("A" * 3073)
    assert _row(Aligner(q2=13, e2=1, zdrop=100, device="cpu").extend_batch(
        [(q, t3073)])[0]) == _spec_row(q, t3073, -1, Flag.NONE, two=True)


@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY, Flag.NONE])
def test_one_and_two_piece_handles_in_flight(flag):
    """Handles of one- and two-piece batches in flight together give what
    each batch gives alone."""
    pairs = _mixed(16, 8)
    one = Aligner(zdrop=100, flag=flag, device="cpu")
    two = Aligner(q2=13, e2=1, zdrop=100, flag=flag, device="cpu")
    hs = [a.extend_batch_async(pairs) for a in (one, two, one, two)]
    want = [[_row(ez) for ez in a.extend_batch(pairs)] for a in (one, two)]
    assert want[0] != want[1]
    for k, h in enumerate(hs):
        assert [_row(ez) for ez in h.result()] == want[k % 2]
