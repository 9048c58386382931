"""The port's splice path end to end on the CPU: the route table, the
golden ``exts2_sse`` cases and the API's splice arguments.

``Aligner(splice=True, device="cpu")`` runs the plain versions of the
strips ``spl`` forward, the ``nop`` walker, the batched exts forward and
the band walker.  The golden corpus (tests/golden/cases.jsonl, made with
the reference binary: A1 B2 O2 E1, q2 = 32, noncan = 4, SPLICE_FOR, as
tests/refcmp.py runs it) is matched exactly.  Two corner cases where the
JAX routes and the spec part are pinned here (ROADMAP Queue 3): strips
runs ``q2 <= q + e``, which exts2 resets, and its site classes do not
wrap ``noncan > 128``.
"""
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import splice_jobs, splice_junc, spliced_pair
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.ops import strips_walker as jsw
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")
MAT = simple_mat(5, 1, 2)
SPL = Flag.SPLICE_FOR
KW = dict(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=9, zdrop=200)


def track(tlen):
    """A junction track with the forward donor bit at tlen / 3 and the
    acceptor bit at 2 tlen / 3."""
    j = np.zeros(tlen, np.uint8)
    j[tlen // 3], j[2 * tlen // 3] = 1, 2
    return j


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, list(ez.cigar))


def _pairs(seed, n=4, lo=60, hi=200):
    rng = np.random.default_rng(seed)
    return [spliced_pair(rng, int(rng.integers(lo, hi))) for _ in range(n)]


def routes(pairs, flag, juncs=None, junc_bonus=0, q2=32):
    """Each bucket's route as the splice path plans it."""
    jobs = [sched.AlignJob(a, b) for a, b in pairs]
    plan = sched.plan_splice(jobs, 5, MAT, 2, 1, q2, 9, 200, junc_bonus,
                             Flag(flag), juncs, [None] * len(jobs))
    return [route for _, route, _ in plan]


@pytest.mark.parametrize("flag,juncs,junc_bonus,want", [
    (SPL, False, 0, "strips"),
    (SPL | Flag.SCORE_ONLY, False, 0, "strips"),
    (SPL | Flag.RIGHT | Flag.SPLICE_FLANK, False, 0, "strips"),
    (SPL, True, 0, "batch"),
    (SPL, True, 9, "batch"),
    (SPL, False, 9, "batch"),           # a bonus alone declines strips
    (SPL | Flag.EQX, False, 0, "batch"),
    (SPL | Flag.SCORE_ONLY | Flag.APPROX_MAX, False, 0, "batch"),
])
def test_route_table(flag, juncs, junc_bonus, want):
    pairs = _pairs(1)
    tracks = [track(len(t)) for _, t in pairs] if juncs else None
    assert set(routes(pairs, flag, tracks, junc_bonus)) == {want}


def test_a_bucket_with_one_track_takes_the_batched_route():
    pairs = _pairs(2, lo=130, hi=140)          # one bucket
    tracks = [None] * len(pairs)
    tracks[1] = track(len(pairs[1][1]))
    assert routes(pairs, SPL, tracks) == ["batch"]
    assert routes(pairs, SPL, [None] * len(pairs)) == ["strips"]


@pytest.mark.parametrize("flag", [SPL | Flag.EXTZ_ONLY,
                                  SPL | Flag.EXTZ_ONLY | Flag.SCORE_ONLY])
def test_extz_only_raises_naming_item_12(flag):
    """EXTZ_ONLY splice buckets, which raised naming ROADMAP item 12b
    until kernel 14 was ported, take the single-pair splice engine and
    equal the spec (no reach_end, no end bonus)."""
    pairs = _pairs(3)
    assert set(routes(pairs, flag)) == {"single"}
    got = Aligner(flag=flag, device="cpu", **KW).extend_batch(pairs)
    want = [diagdiff.exts2(a, b, 5, MAT, 2, 1, 32, 9, zdrop=200,
                           flag=flag)[0] for a, b in pairs]
    assert [_row(g) for g in got] == [_row(w) for w in want]
    assert not any(g.reach_end for g in got)


def test_long_annotated_targets_raise_naming_item_12():
    """Targets over 1536 with a track: neither strips nor the batched
    engine takes them (they raised naming item 12b before kernel 14), so
    the single-pair splice engine does and equals the spec; without the
    track strips takes them."""
    rng = np.random.default_rng(4)
    pairs = [spliced_pair(rng, 1700)]
    (q, t), = pairs
    flag = SPL | Flag.SCORE_ONLY
    assert routes(pairs, flag, [track(1700)]) == ["single"]
    got = Aligner(flag=flag, device="cpu", **KW).extend_batch(
        pairs, juncs=[track(1700)])
    want = diagdiff.exts2(q, t, 5, MAT, 2, 1, 32, 9, zdrop=200, flag=flag,
                          junc=track(1700))[0]
    assert [_row(g) for g in got] == [_row(want)]
    assert set(routes(pairs, SPL | Flag.SCORE_ONLY)) == {"strips"}


def test_eqx_splice_keeps_m_ops():
    """exts2 has no =/X pass: EQX CIGARs equal the plain ones."""
    pairs = _pairs(5)
    eqx = Aligner(flag=SPL | Flag.EQX, device="cpu", **KW).extend_batch(pairs)
    want = [diagdiff.exts2(a, b, 5, MAT, 2, 1, 32, 9, zdrop=200,
                           flag=SPL | Flag.EQX)[0] for a, b in pairs]
    assert [_row(g) for g in eqx] == [_row(w) for w in want]
    ops = {c & 0xF for ez in eqx for c in ez.cigar}
    assert 0 in ops and not ops & {7, 8}


def _golden_exts():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    return [c for c in cases if c["algo"] == "exts2_sse"]


def test_golden_exts2_cases():
    """All 86 reference-binary cases, as tests/refcmp.py runs them."""
    cases = _golden_exts()
    assert len(cases) == 86
    for c in cases:
        p = c["params"]
        flag = SPL
        if p["right"]:
            flag |= Flag.RIGHT
        if p["score_only"]:
            flag |= Flag.SCORE_ONLY
        if p["approx"]:
            flag |= Flag.APPROX_MAX | Flag.APPROX_DROP
        aln = Aligner(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=4,
                      zdrop=p["z"], flag=flag, device="cpu")
        got = aln.extend(c["query"], c["target"]).tsv_fields()
        if c.get("fields_only"):
            got = got[:4]
        assert got == c["expect"], (p, c["query"], c["target"])


def test_splice_api_value_errors():
    with pytest.raises(ValueError, match="q2"):
        Aligner(a=1, b=2, q=2, e=1, splice=True, device="cpu")
    plain = Aligner(device="cpu")
    q, t = _pairs(6, n=1)[0]
    junc = track(len(t))
    with pytest.raises(ValueError, match="splice"):
        plain.extend(q, t, junc=junc)
    with pytest.raises(ValueError, match="splice"):
        plain.extend_batch([(q, t)], juncs=[junc])
    with pytest.raises(ValueError, match="splice"):
        plain.extend_batch_async([(q, t)], juncs=[junc])


@pytest.mark.parametrize("junc_bonus", [0, 9])
def test_extend_with_junc_equals_extend_batch(junc_bonus):
    pairs = _pairs(7, n=3)
    tracks = [track(len(t)) if k != 1 else None
              for k, (_, t) in enumerate(pairs)]
    aln = Aligner(junc_bonus=junc_bonus, flag=SPL, device="cpu", **KW)
    batch = aln.extend_batch(pairs, juncs=tracks)
    for (q, t), j, ez in zip(pairs, tracks, batch):
        assert _row(aln.extend(q, t, junc=j)) == _row(ez)
        want = diagdiff.exts2(q, t, 5, MAT, 2, 1, 32, 9, zdrop=200,
                              junc_bonus=junc_bonus, flag=SPL, junc=j)[0]
        assert _row(ez) == _row(want)


def test_async_handles_match_the_sync_batch():
    pairs = splice_jobs(n=6)
    aln = Aligner(flag=SPL, device="cpu", **KW)
    hs = [aln.extend_batch_async(pairs), aln.extend_batch_async(
        pairs, juncs=[splice_junc()] * len(pairs))]
    want = [aln.extend_batch(pairs),
            aln.extend_batch(pairs, juncs=[splice_junc()] * len(pairs))]
    for h, w in zip(hs, want):
        assert [_row(a) for a in h.result()] == [_row(b) for b in w]


def test_strips_runs_q2_not_above_q_plus_e():
    """ROADMAP Queue 3 pin: with ``q2 <= q + e`` the strips route (the
    port's and the JAX package's) aligns, where exts2 and the batched
    route reset."""
    pairs = _pairs(8, n=3)
    assert set(routes(pairs, SPL, q2=3)) == {"strips"}
    got = sched.align_batch_splice([sched.AlignJob(a, b) for a, b in pairs],
                                   5, MAT, 2, 1, 3, 9, zdrop=200, flag=SPL,
                                   device="cpu")
    Q = np.zeros((3, max(len(a) for a, _ in pairs)), np.int32)
    T = np.zeros((3, max(len(b) for _, b in pairs)), np.int32)
    for k, (a, b) in enumerate(pairs):
        Q[k, :len(a)], T[k, :len(b)] = a, b
    jax = jsw.strips_exts_cigar_batch(
        Q, T, np.array([len(a) for a, _ in pairs], np.int32),
        np.array([len(b) for _, b in pairs], np.int32), 5, MAT, 2, 1, 3, 9,
        zdrop=200, flag=SPL, interpret=True)
    assert [_row(g) for g in got] == [_row(j) for j in jax]
    for (a, b), g in zip(pairs, got):
        spec = diagdiff.exts2(a, b, 5, MAT, 2, 1, 3, 9, zdrop=200,
                              flag=SPL)[0]
        assert spec.max == 0 and not spec.cigar
        assert g.max > 0 and g.cigar


def test_strips_does_not_wrap_noncan_above_128():
    """ROADMAP Queue 3 pin: the strips route reads its site costs
    unwrapped (the JAX strips classes), exts2 and the batched route as
    int8, so noncan = 200 costs a non-canonical site -200 on strips and
    +56 on the batched route."""
    pairs = _pairs(9, n=3)
    kw = dict(KW, noncan=200)
    strips = Aligner(flag=SPL, device="cpu", **kw).extend_batch(pairs)
    batch = Aligner(flag=SPL, device="cpu", junc_bonus=0, **kw).extend_batch(
        pairs, juncs=[np.zeros(len(t), np.uint8) for _, t in pairs])
    spec = [diagdiff.exts2(a, b, 5, MAT, 2, 1, 32, 200, zdrop=200,
                           flag=SPL)[0] for a, b in pairs]
    assert [_row(b) for b in batch] == [_row(s) for s in spec]
    assert [_row(a) for a in strips] != [_row(s) for s in spec]
