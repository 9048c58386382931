"""The batched route through the port's scheduler, against the JAX
package.

Routes are observed on the CPU by counting calls of the launch functions
the scheduler takes; results are held against the JAX package's
``align_batch`` (its batched engines run under the Pallas interpreter),
the spec and the reference-binary golden corpus, exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.batch.scheduler import AlignJob as JAlignJob
from ksw2_tpu.batch.scheduler import align_batch as j_align_batch
from ksw2_tpu.core import cigar as jcigar
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
LAUNCHERS = ("rows_records", "strips_records", "band_records",
             "batch_records", "strips_cigar_launch", "band_cigar_launch",
             "batch_cigar_launch")


@pytest.fixture
def calls(monkeypatch):
    """Names of the scheduler's launch functions, in call order."""
    seen = []
    for name in LAUNCHERS:
        fn = getattr(sched, name)
        monkeypatch.setattr(
            sched, name,
            lambda *a, fn=fn, name=name: seen.append(name) or fn(*a))
    return seen


def _pairs(seed, n, lo, hi, div=0.15, ind=0.06):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(lo, hi)),
                                  divergence=div, indel=ind)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _spec(q, t, w, zdrop, flag, two, eqx_one_piece=False):
    w = w if w >= 0 else max(len(q), len(t))
    if two:
        return diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, w=w, zdrop=zdrop,
                              flag=flag)[0]
    ez = diagdiff.extz2(q, t, 5, MAT, 4, 2, w=w, zdrop=zdrop, flag=flag)[0]
    if eqx_one_piece and flag & Flag.EQX and ez.cigar:
        ez.cigar = jcigar.to_eqx(ez.cigar, q, t)
    return ez


@pytest.mark.parametrize("flag,two", [
    (Flag.SCORE_ONLY, False), (Flag.NONE, True)],
    ids=["extz-scores", "extd-cigars"])
def test_mixed_batch_takes_every_route(calls, flag, two):
    """One batch whose buckets take the rows (one-piece scores only),
    strips, band and batched routes; every field and CIGAR equals the
    spec's."""
    rows = _pairs(1, 1, 40, 100)
    strips = _pairs(2, 1, 150, 240)
    band = _pairs(3, 1, 520, 560)
    batch = _pairs(4, 2, 270, 480)
    pairs = rows + strips + band + batch
    w = [-1, -1, 40, 30, 0]
    kw = dict(q2=13, e2=1) if two else {}
    got = Aligner(zdrop=100, flag=flag, device="cpu", **kw).extend_batch(
        pairs, w=w)
    score = bool(flag & Flag.SCORE_ONLY)
    want = ({"batch_records", "band_records", "strips_records"}
            | ({"rows_records"} if not two else set()) if score else
            {"batch_cigar_launch", "band_cigar_launch",
             "strips_cigar_launch"})
    assert set(calls) == want
    for (q, t), wi, g in zip(pairs, w, got):
        assert _row(g) == _row(_spec(q, t, wi, 100, flag, two))


@pytest.mark.parametrize("flag,two,end_bonus", [
    (Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, False, 0),
    (Flag.SCORE_ONLY | Flag.APPROX_MAX, True, 0),
    (Flag.EQX, False, 0), (Flag.EQX | Flag.RIGHT, True, 0),
    (Flag.REV_CIGAR, False, 0), (Flag.SCORE_ONLY, True, 10)],
    ids=["extz-approx", "extd-approx", "extz-eqx", "extd-eqx-right",
         "extz-rev", "extd-end-bonus-scores"])
def test_batch_route_matches_jax_align_batch(calls, flag, two, end_bonus):
    """Short buckets that strips refuses (a clipping band, APPROX, EQX)
    or that skip strips (two-piece SCORE_ONLY with end_bonus) take the
    batched route beside the buckets strips takes; every field and CIGAR
    equals the JAX package's ``align_batch``."""
    pairs = _pairs(11, 3, 80, 160)
    ws = [20, -1, 0]
    kw = dict(q2=13, e2=1) if two else {}
    got = sched.align_batch([sched.AlignJob(q, t, w) for (q, t), w in
                             zip(pairs, ws)], 5, MAT, 4, 2, zdrop=100,
                            end_bonus=end_bonus, flag=flag, device="cpu",
                            **kw)
    want = j_align_batch([JAlignJob(q, t, w) for (q, t), w in
                          zip(pairs, ws)], 5, MAT, 4, 2, zdrop=100,
                         end_bonus=end_bonus, flag=flag, **kw)
    assert {"batch_records", "batch_cigar_launch"} & set(calls)
    assert [_row(g) for g in got] == [_row(w) for w in want]
    for (q, t), wi, g in zip(pairs, ws, got):
        assert _row(g) == _row(_spec(q, t, wi, 100, flag, two, True))
    if end_bonus:
        plain = sched.align_batch([sched.AlignJob(q, t, w) for (q, t), w in
                                   zip(pairs, ws)], 5, MAT, 4, 2, 13, 1,
                                  zdrop=100, flag=flag, device="cpu")
        assert [_row(g) for g in got] == [_row(p) for p in plain]


def test_eqx_split_between_routes(calls):
    """The JAX package converts one-piece CIGARs to EQX on its batched
    route (batch_pallas.py:499-505, 773-782) but not on its band route
    (band_batch.py:384-540, as the reference's extz2); two-piece CIGARs
    convert on both.  The port follows each route."""
    (q, t), = _pairs(12, 1, 520, 540)
    for two in (False, True):
        kw = dict(q2=13, e2=1) if two else {}
        aln = Aligner(zdrop=100, flag=Flag.EQX, device="cpu", **kw)
        calls.clear()
        band = aln.extend_batch([(q, t)], w=[50])[0]
        assert calls == ["band_cigar_launch"]
        calls.clear()
        batch = aln.extend_batch([(q, t)])[0]         # no band: batched
        assert calls == ["batch_cigar_launch"]
        ops = {c & 0xF for c in band.cigar}
        assert (0 in ops) != two and bool(ops & {7, 8}) == two
        assert not {c & 0xF for c in batch.cigar} & {0}
        assert _row(batch) == _row(_spec(q, t, -1, 100, Flag.EQX, two, True))


def test_every_raise_names_its_item():
    """The buckets no batch route takes, which raised naming their
    ROADMAP item before their engines were ported (items 7 and 12 for
    one-piece, 12b for two-piece), run on the any-device route, the
    single-pair engine (M ops under EQX) and the single-pair two-piece
    engine (=/X under EQX, EXTZ_ONLY scores, end_bonus scores over 1536)
    and match the spec."""
    from ksw2_tpu.core import cigar as jcigar
    short = _pairs(13, 1, 200, 220)
    wide = [(encode_dna("ACGT" * 500), encode_dna("ACGA" * 500))]
    huge = [(encode_dna("ACGT" * 800), encode_dna("ACGA" * 800))]
    big = simple_mat(5, 100, 4)
    S, X = Flag.SCORE_ONLY, Flag.EXTZ_ONLY
    for kw, pairs, w in (
            (dict(flag=S), huge, -1),                         # t > 3072
            (dict(flag=S, q2=13, e2=1), huge, -1),
            (dict(flag=S, mat=big, zdrop=100), [(
                encode_dna("ACGT" * 700), encode_dna("ACGT" * 700))],
             -1),                                             # Z-drop range
            (dict(flag=Flag.EQX), wide, -1),                  # EQX, 2000
            (dict(flag=Flag.EQX, q2=13, e2=1), wide, -1),
            (dict(flag=X), short, 30),                        # EXTZ_ONLY
            (dict(flag=S | X, q2=13, e2=1), short, 30),
            (dict(flag=S, q2=13, e2=1, end_bonus=5), wide, -1)):
        aln = Aligner(device="cpu", **kw)
        (q, t), = pairs
        got, = aln.extend_batch(pairs, w=[w])
        z, mat = kw.get("zdrop", -1), kw.get("mat", MAT)
        if "q2" in kw:
            want = diagdiff.extd2(q, t, 5, mat, 4, 2, 13, 1, w=w, zdrop=z,
                                  end_bonus=kw.get("end_bonus", 0),
                                  flag=aln.flag)[0]
            if aln.flag & Flag.EQX:
                want.cigar = jcigar.to_eqx(want.cigar, q, t)
        else:
            want = diagdiff.extz2(q, t, 5, mat, 4, 2, w=w, zdrop=z,
                                  flag=aln.flag)[0]
        assert _row(got) == _row(want), kw


def _golden_short_banded():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    out = []
    for c in cases:
        p = c["params"]
        ql, tl = len(c["query"]), len(c["target"])
        if c["algo"] in ("extz2_sse", "extd2_sse") and ql and tl and \
                0 <= p["w"] < max(ql, tl) and \
                sched._bucket_key(ql, tl)[1] <= 512:
            out.append(c)
    return out


def test_golden_short_banded_cases_run_and_match(calls):
    """Every banded extz2_sse / extd2_sse golden case with a target
    bucket of 512 or less runs through ``Aligner`` (w = 0 included), on
    the single-pair engines (``extend``) and through the scheduler
    (``extend_batch``), and matches the reference binary; the clipping
    ones take the batched route."""
    cases = _golden_short_banded()
    assert len(cases) >= 40
    for c in cases:
        p = c["params"]
        flag = (Flag.RIGHT if p["right"] else Flag.NONE) | \
            (Flag.SCORE_ONLY if p["score_only"] else Flag.NONE) | \
            (Flag.APPROX_MAX | Flag.APPROX_DROP if p["approx"]
             else Flag.NONE)        # tests/refcmp.py:94-100
        two = c["algo"] == "extd2_sse"
        kw = dict(q2=p["q2"], e2=p["e2"]) if two else {}
        aln = Aligner(a=p["a"], b=p["b"], q=p["q"], e=p["e"], w=p["w"],
                      zdrop=p["z"], flag=flag, device="cpu", **kw)
        for got in (aln.extend(c["query"], c["target"]),
                    aln.extend_batch([(c["query"], c["target"])])[0]):
            got = got.tsv_fields()
            if c.get("fields_only"):
                got = got[:4]
            assert got == c["expect"], (c["algo"], p, c["query"],
                                        c["target"])
    assert calls.count("batch_records") + \
        calls.count("batch_cigar_launch") >= 30
