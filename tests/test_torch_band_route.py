"""The band route through the port's scheduler, against the JAX package.

Routes are observed on the CPU by counting calls of the launch functions
the scheduler takes; results are held against the JAX package's
``align_batch`` (its band engines run under the Pallas interpreter), the
spec and the reference-binary golden corpus, exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

import ksw2_tpu
import ksw2_tpu.core.cigar
import refcmp
from ksw2_tpu.batch.scheduler import AlignJob as JAlignJob
from ksw2_tpu.batch.scheduler import align_batch as j_align_batch
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.convert import aligner_from_jax
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import band_walker as BW
from ksw2_tpu_torch.ops import strips

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")
MAT = simple_mat(5, 2, 4)
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")
LAUNCHERS = ("rows_records", "strips_records", "band_records",
             "batch_records", "strips_cigar_launch", "band_cigar_launch",
             "batch_cigar_launch")
# the single-pair engines' launch functions, named by their route
EXTZ_LAUNCHERS = {"extz_records": "any_records",
                  "extz_cigar_launch": "single_cigar",
                  "extd_records": "extd_records",
                  "extd_cigar_launch": "extd_cigar"}


@pytest.fixture
def calls(monkeypatch):
    """Names of the scheduler's launch functions, in call order."""
    seen = []
    for name in LAUNCHERS + tuple(EXTZ_LAUNCHERS):
        fn = getattr(sched, name)
        tag = EXTZ_LAUNCHERS.get(name, name)
        monkeypatch.setattr(
            sched, name,
            lambda *a, fn=fn, tag=tag: seen.append(tag) or fn(*a))
    return seen


def _pairs(seed, n, lo, hi, div=0.15, ind=0.08):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(lo, hi)),
                                  divergence=div, indel=ind)
        out.append((encode_dna(q), encode_dna(t)))
    return out, rng


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _spec(q, t, w, zdrop, flag, two):
    if two:
        return diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, w=w, zdrop=zdrop,
                              flag=flag)[0]
    return diagdiff.extz2(q, t, 5, MAT, 4, 2, w=w, zdrop=zdrop, flag=flag)[0]


@pytest.mark.parametrize("flag,two", [
    (Flag.SCORE_ONLY, True),
    (Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, True),
    (Flag.NONE, False), (Flag.NONE, True), (Flag.EQX, True)],
    ids=["extd-score", "extd-approx", "extz-cigar", "extd-cigar",
         "extd-eqx"])
def test_band_route_matches_jax_align_batch(flag, two):
    """tests/test_band.py:178-192, 247-263 through the port: long banded
    buckets (t 560-800, w 20-120) ride the band route, EQX and APPROX
    buckets included, and every field and CIGAR equals the JAX
    package's."""
    pairs, rng = _pairs(31, 3, 560, 800)
    ws = [int(rng.integers(20, 120)) for _ in pairs]
    kw = dict(q2=13, e2=1) if two else {}
    got = sched.align_batch([sched.AlignJob(q, t, w) for (q, t), w in
                             zip(pairs, ws)], 5, MAT, 4, 2, zdrop=100,
                            flag=flag, device="cpu", **kw)
    want = j_align_batch([JAlignJob(q, t, w) for (q, t), w in
                          zip(pairs, ws)], 5, MAT, 4, 2, zdrop=100,
                         flag=flag, **kw)
    assert [_row(g) for g in got] == [_row(w) for w in want]


def test_buckets_take_their_routes(calls):
    """Long clipping buckets take the band route; unclipped ones keep
    strips (or rows); the results equal the spec's."""
    long, _ = _pairs(7, 2, 600, 700)
    short, _ = _pairs(8, 2, 200, 300)
    pairs = long + short
    w = [40, 60, -1, -1]
    for flag, want_calls in (
            (Flag.SCORE_ONLY, ["band_records", "strips_records"]),
            (Flag.NONE, ["band_cigar_launch", "strips_cigar_launch"])):
        calls.clear()
        got = Aligner(zdrop=100, flag=flag, device="cpu").extend_batch(
            pairs, w=w)
        assert set(calls) == set(want_calls)
        for (q, t), wi, g in zip(pairs, w, got):
            assert _row(g) == _row(_spec(q, t, wi, 100, flag, False))


def test_band_route_sorts_and_splits_launches(calls, monkeypatch):
    """A band bucket runs longest pair first and, past the byte budget
    of its direction bytes, as several launches; results land on the
    right jobs."""
    pairs, rng = _pairs(9, 4, 520, 760)
    w = [int(v) for v in rng.integers(20, 90, len(pairs))]
    aln = Aligner(q2=13, e2=1, zdrop=100, device="cpu")
    whole = aln.extend_batch(pairs, w=w)
    assert calls == ["band_cigar_launch"]
    calls.clear()
    monkeypatch.setattr(strips, "LAUNCH_BYTES", 200_000)
    split = aln.extend_batch(pairs, w=w)
    assert calls.count("band_cigar_launch") > 2
    assert [_row(g) for g in split] == [_row(g) for g in whole]
    h = aln.extend_batch_async(pairs, w=w)
    assert [_row(g) for g in h.result()] == [_row(g) for g in whole]


def test_out_of_band_envelope_raises(calls):
    q, t = encode_dna("ACGT" * 60), encode_dna("ACGA" * 60)
    # a clipping band on targets of 512 or less: the batched route
    got = Aligner(zdrop=100, device="cpu").extend_batch([(q, t)], w=[20])
    assert calls == ["batch_cigar_launch"]
    assert _row(got[0]) == _row(_spec(q, t, 20, 100, Flag.NONE, False))
    long_t = encode_dna("ACGT" * 800)
    long_q = encode_dna("ACGT" * 790)
    # w > 1472 (or no band) on a long pair: the single-pair engine for
    # one-piece CIGARs, the any-device route for one-piece scores, the
    # single-pair two-piece engine for two-piece buckets
    # (scheduler.py:278-285, 514-521, 755-767)
    for aln, item in ((Aligner(device="cpu"), "single_cigar"),
                      (Aligner(q2=13, e2=1, device="cpu"), "extd_cigar"),
                      (Aligner(q2=13, e2=1, flag=Flag.SCORE_ONLY,
                               device="cpu"), "extd_records"),
                      (Aligner(flag=Flag.SCORE_ONLY, device="cpu"),
                       "any_records")):
        for w in (1500, -1):
            calls.clear()
            got = aln.extend_batch([(long_q, long_t)], w=[w])
            assert calls == [item]
            assert _row(got[0]) == _row(_spec(long_q, long_t, w, -1,
                                              aln.flag, aln.q2 is not None))
    # a long EXTZ_ONLY CIGAR bucket with w <= 1536: the single-pair engine
    calls.clear()
    got = Aligner(flag=Flag.EXTZ_ONLY, device="cpu").extend_batch(
        [(long_q, long_t)], w=[100])
    assert calls == ["single_cigar"]
    assert _row(got[0]) == _row(_spec(long_q, long_t, 100, -1,
                                      Flag.EXTZ_ONLY, False))


def test_cigars_read_the_raw_w(calls):
    """With w = -1 the score path bands at max(qlen, tlen) and takes the
    band route for an APPROX bucket; the CIGAR path reads the raw w, so
    the band route refuses an EQX bucket and the batched route takes it
    at max(qlen, tlen), converting to =/X (scheduler.py:229-231, 672,
    730)."""
    q, t = encode_dna("AC" * 380), encode_dna("ACGT" * 150)
    flag = Flag.SCORE_ONLY | Flag.APPROX_MAX
    got = Aligner(flag=flag, device="cpu").extend_batch([(q, t)])
    assert calls == ["band_records"]
    assert _row(got[0]) == _row(_spec(q, t, 760, -1, flag, False))
    calls.clear()
    got = Aligner(flag=Flag.EQX, device="cpu").extend_batch([(q, t)])
    assert calls == ["batch_cigar_launch"]
    want = _spec(q, t, 760, -1, Flag.EQX, False)
    want.cigar = ksw2_tpu.core.cigar.to_eqx(want.cigar, q, t)
    assert _row(got[0]) == _row(want)


def test_band_ineligible_reason_paths():
    ql, tl = np.array([900]), np.array([1000])
    assert BD.band_ineligible_reason(1024, ql, tl, [751], MAT,
                                     Flag.SCORE_ONLY, cigar=False) is None
    assert "take the batched route" in BD.band_ineligible_reason(
        512, ql, tl, [751], MAT, Flag.SCORE_ONLY, cigar=False)
    assert "take the batched route" in BD.band_ineligible_reason(
        1024, ql, tl, [1473], MAT, Flag.SCORE_ONLY, cigar=False)
    assert "take the any-device route" in BD.band_ineligible_reason(
        4096, ql, tl, [0], MAT, Flag.SCORE_ONLY, cigar=False)
    assert "take the single-pair engine" in BD.band_ineligible_reason(
        4096, ql, tl, [-1], MAT, Flag.NONE, cigar=True)
    assert "take the single-pair two-piece engine" in \
        BD.band_ineligible_reason(4096, ql, tl, [-1], MAT, Flag.NONE,
                                  cigar=True, two=True)
    assert "EXTZ_ONLY" in BD.band_ineligible_reason(
        1024, ql, tl, [50], MAT, Flag.EXTZ_ONLY, cigar=True)
    assert "range" in BD.band_ineligible_reason(
        2048, [2000], [2000], [50], simple_mat(5, 100, 4), Flag.SCORE_ONLY,
        cigar=False)


def test_jax_aligner_w751_reaches_band(calls):
    """A JAX ``Aligner(w=751)`` configuration carried across by
    ``aligner_from_jax`` takes the band route on pairs its band clips."""
    pairs, _ = _pairs(12, 2, 880, 960)
    jal = ksw2_tpu.Aligner(a=2, b=4, q=4, e=2, q2=13, e2=1, w=751,
                           zdrop=400)
    cfg = {"m": jal.m, "mat": np.asarray(jal.mat), "q": jal.q, "e": jal.e,
           "w": jal.w, "zdrop": jal.zdrop, "end_bonus": jal.end_bonus,
           "flag": int(jal.flag), "q2": jal.q2, "e2": jal.e2,
           "splice": jal.splice}
    port = aligner_from_jax(cfg, device="cpu")
    assert port.w == 751
    got = port.extend_batch(pairs)
    assert calls == ["band_cigar_launch"]
    for (q, t), g in zip(pairs, got):
        assert _row(g) == _row(_spec(q, t, 751, 400, Flag.NONE, True))


def _golden_banded():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    out = []
    for c in cases:
        p = c["params"]
        ql, tl = len(c["query"]), len(c["target"])
        if c["algo"] in ("extz2_sse", "extd2_sse") and \
                0 <= p["w"] < max(ql, tl) and 1 <= p["w"] <= BD.W_MAX:
            out.append(c)
    return out


def test_golden_banded_cases_through_the_band_functions():
    """Every banded extz2_sse / extd2_sse golden case with 1 <= w <= 1472
    run straight through ops.band and ops.band_walker matches the
    reference binary, whatever route the scheduler would give it."""
    cases = _golden_banded()
    assert len(cases) == 73
    for c in cases:
        p = c["params"]
        two = c["algo"] == "extd2_sse"
        q, t = encode_dna(c["query"]), encode_dna(c["target"])
        mat = simple_mat(5, p["a"], -p["b"])
        flag = (Flag.RIGHT if p["right"] else Flag.NONE) | \
            (Flag.SCORE_ONLY if p["score_only"] else Flag.NONE) | \
            (Flag.APPROX_MAX | Flag.APPROX_DROP if p["approx"]
             else Flag.NONE)        # tests/refcmp.py:94-100
        (ln,) = BD.band_prep([q], [t], [len(q)], [len(t)], [p["w"]], 5, mat,
                             p["q"], p["e"], p["z"], flag,
                             cig=not p["score_only"], two=two, q2=p["q2"],
                             e2=p["e2"])
        ez = sched.ExtzResult()
        if -int(mat[1:].min()) > 2 * (ln.prm.q + ln.prm.e):
            ez.reset()           # the reference's degenerate-scoring reset
        elif p["score_only"]:
            r = BD.band_records(ln, "cpu").numpy()[0]
            ez = sched.ExtzResult(**{k: int(v) for k, v in zip(FIELDS, r)})
            ez.zdropped = bool(ez.zdropped)
        else:
            rec, res, runs = BW.band_cigar_launch(ln, 0, "cpu")
            (ez,) = BW.unpack_band_cigars(ln, rec.numpy(), res.numpy(),
                                          runs.numpy(), mat, 0)
        got = ez.tsv_fields()
        if c.get("fields_only"):
            got = got[:4]
        assert got == c["expect"], (c["algo"], p, c["query"], c["target"])
