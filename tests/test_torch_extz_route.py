"""The single-pair engine and the any-device route through the port's
scheduler and ``Aligner``.

Routes are observed on the CPU by counting calls of the launch functions
the scheduler takes (as in ``test_torch_band_route.py``); results are held
against the spec and the reference-binary golden corpus, exactly.  Every
golden ``extz2_sse`` case runs through ``Aligner.extend``, the single-pair
engine, and none may raise; two-piece and splice buckets beyond the batch
routes run on the single-pair two-piece and splice engines (kernels 13
and 14).
"""
import json
import os

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")
MAT = simple_mat(5, 2, 4)
LAUNCHERS = {"rows_records": "rows", "strips_records": "strips",
             "band_records": "band", "batch_records": "batch",
             "extz_records": "any", "strips_cigar_launch": "strips",
             "band_cigar_launch": "band", "batch_cigar_launch": "batch",
             "extz_cigar_launch": "single", "extd_records": "extd",
             "extd_cigar_launch": "extd", "exts_records": "exts",
             "exts_cigar_launch": "exts"}


@pytest.fixture
def calls(monkeypatch):
    """The routes of the scheduler's launches, in call order."""
    seen = []
    for name, route in LAUNCHERS.items():
        fn = getattr(sched, name)
        monkeypatch.setattr(
            sched, name,
            lambda *a, fn=fn, route=route: seen.append(route) or fn(*a))
    return seen


def _pair(seed, tlen, div=0.15, ind=0.06):
    rng = np.random.default_rng(seed)
    t, q = refcmp.random_pair(rng, tlen, divergence=div, indel=ind)
    return encode_dna(q), encode_dna(t)


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _spec(q, t, w, zdrop, flag, mat=MAT, end_bonus=0):
    return diagdiff.extz2(q, t, 5, mat, 4, 2, w=w, zdrop=zdrop,
                          end_bonus=end_bonus, flag=flag)[0]


def test_route_table_sends_each_bucket_class(calls):
    """One-piece buckets that the batch routes refuse: EXTZ_ONLY CIGARs
    (short banded, and long) and clipping CIGARs over 1536 in bands wider
    than the band route's 1472 take the single-pair engine; scores over
    3072 and exact Z-drop outside the batched route's packed-argmax
    range, in such bands, take the any-device route; the batch routes
    keep what they take (a short clipping CIGAR stays batched, a long
    w = 751 score stays on the band route)."""
    S, X = Flag.SCORE_ONLY, Flag.EXTZ_ONLY
    short = _pair(1, 300)
    long_ = _pair(2, 1700)
    big = simple_mat(5, 100, 4)
    for kw, pair, w, route in (
            (dict(flag=X, end_bonus=10, zdrop=100), short, 100, "single"),
            (dict(flag=X, zdrop=100), long_, 751, "single"),
            (dict(flag=Flag.NONE, zdrop=100), long_, 1500, "single"),
            (dict(flag=S, zdrop=100), _pair(3, 3100), 1500, "any"),
            (dict(flag=S, mat=big, zdrop=100), long_, 1500, "any"),
            (dict(flag=Flag.NONE, zdrop=100), short, 50, "batch"),
            (dict(flag=S, zdrop=100), long_, 751, "band")):
        calls.clear()
        aln = Aligner(device="cpu", **kw)
        got, = aln.extend_batch([pair], w=[w])
        assert calls == [route], (kw, w)
        want = _spec(*pair, w, kw.get("zdrop", -1), aln.flag,
                     kw.get("mat", MAT), kw.get("end_bonus", 0))
        assert _row(got) == _row(want), (kw, w)


def test_bucket_is_one_launch_of_each_kernel(calls):
    """A bucket of EXTZ_ONLY CIGARs goes out as one launch (forward and
    walker), its pairs ordered longest first; every pair equals the spec,
    ``reach_end`` included, and the async handle gives the same."""
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(12):
        t, q = refcmp.random_pair(rng, int(rng.integers(150, 250)),
                                  divergence=0.15, indel=0.06)
        pairs.append((encode_dna(q), encode_dna(t)))
    aln = Aligner(zdrop=100, end_bonus=10, flag=Flag.EXTZ_ONLY, device="cpu")
    got = aln.extend_batch(pairs, w=[100] * len(pairs))
    assert calls == ["single"] * len({sched._bucket_key(len(q), len(t))
                                      for q, t in pairs})
    want = [_spec(q, t, 100, 100, Flag.EXTZ_ONLY, end_bonus=10)
            for q, t in pairs]
    assert [_row(g) for g in got] == [_row(x) for x in want]
    assert any(g.reach_end for g in got)
    h = aln.extend_batch_async(pairs, w=[100] * len(pairs))
    assert [_row(g) for g in h.result()] == [_row(x) for x in want]


def _golden_extz2():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    return [c for c in cases if c["algo"] == "extz2_sse"]


def test_golden_extz2_cases_through_extend():
    """All 77 golden ``extz2_sse`` cases run through ``Aligner.extend``,
    the single-pair engine (as the JAX ``extend`` runs ``extz2_device``),
    and equal the reference binary's rows; none raises."""
    cases = _golden_extz2()
    assert len(cases) == 77
    for c in cases:
        p = c["params"]
        flag = ((Flag.RIGHT if p["right"] else Flag.NONE)
                | (Flag.SCORE_ONLY if p["score_only"] else Flag.NONE)
                | (Flag.APPROX_MAX | Flag.APPROX_DROP if p["approx"]
                   else Flag.NONE))
        aln = Aligner(a=p["a"], b=p["b"], q=p["q"], e=p["e"], w=p["w"],
                      zdrop=p["z"], flag=flag, device="cpu")
        got = aln.extend(c["query"], c["target"]).tsv_fields()
        if c.get("fields_only"):
            got = got[:4]
        assert got == c["expect"], (p, c["query"], c["target"])


def test_two_piece_and_splice_buckets_raise_item_12b(calls):
    """The two-piece and splice buckets beyond the batch routes, which
    raised naming ROADMAP item 12b until kernels 13 and 14 were ported,
    run on the single-pair two-piece and splice engines, one launch a
    bucket, and equal the spec: two-piece CIGARs in a band wider than
    1472, EXTZ_ONLY CIGARs and SCORE_ONLY|EXTZ_ONLY scores, scores on
    targets over 3072, splice EXTZ_ONLY CIGARs and an annotated splice
    pair through ``extend``."""
    q, t = _pair(5, 1700)
    S, X = Flag.SCORE_ONLY, Flag.EXTZ_ONLY
    for aln, w in ((Aligner(q2=13, e2=1, device="cpu"), 1500),
                   (Aligner(q2=13, e2=1, flag=X, device="cpu"), 100),
                   (Aligner(q2=13, e2=1, flag=S | X, device="cpu"), 100)):
        calls.clear()
        got, = aln.extend_batch([(q, t)], w=[w])
        assert calls == ["extd"], (aln.flag, w)
        want = diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, w=w, flag=aln.flag)
        assert _row(got) == _row(want[0]), (aln.flag, w)
    smat = simple_mat(5, 1, 2)
    calls.clear()
    spl = Aligner(a=1, b=2, q=2, e=1, q2=32, splice=True,
                  flag=Flag.SPLICE_FOR | X, device="cpu")
    got, = spl.extend_batch([(q, t)])
    assert calls == ["exts"]
    want = diagdiff.exts2(q, t, 5, smat, 2, 1, 32, 0, flag=spl.flag)[0]
    assert _row(got) == _row(want)
    huge = encode_dna("ACGT" * 800)
    calls.clear()
    got, = Aligner(q2=13, e2=1, flag=S, zdrop=100,
                   device="cpu").extend_batch([(huge, huge[:3100])])
    assert calls == ["extd"]
    assert _row(got) == _row(diagdiff.extd2(huge, huge[:3100], 5, MAT, 4, 2,
                                            13, 1, zdrop=100, flag=S)[0])
    junc = np.zeros(len(t), np.uint8)
    junc[[200, 900]] = (1, 2)
    got = Aligner(a=1, b=2, q=2, e=1, q2=32, splice=True, junc_bonus=9,
                  flag=Flag.SPLICE_FOR, device="cpu").extend(q, t, junc=junc)
    want = diagdiff.exts2(q, t, 5, smat, 2, 1, 32, 0, junc_bonus=9,
                          flag=Flag.SPLICE_FOR, junc=junc)[0]
    assert _row(got) == _row(want)
