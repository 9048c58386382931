"""The single-pair two-piece and splice engines through the port's
scheduler: the route table, one launch of each kernel a bucket, the
budget split, the resets, and the buckets earlier routes keep.

Routes are observed on the CPU by counting calls of the launch functions
the scheduler takes (as in ``test_torch_extz_route.py``); results are held
against the spec (``ksw2_tpu.spec.diagdiff.extd2`` / ``exts2``), exactly.
"""
import numpy as np
import pytest
import torch

import refcmp
from chip_smoke import spliced_pair
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import strips

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
SPL_MAT = simple_mat(5, 1, 2)
S, X = Flag.SCORE_ONLY, Flag.EXTZ_ONLY
SPL = Flag.SPLICE_FOR
SPLICE = dict(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=9, zdrop=200)
LAUNCHERS = ("strips_records", "band_records", "batch_records",
             "strips_cigar_launch", "band_cigar_launch",
             "batch_cigar_launch", "batch_exts_records",
             "batch_exts_cigar_launch", "extz_records", "extz_cigar_launch",
             "extd_records", "extd_cigar_launch", "exts_records",
             "exts_cigar_launch")


@pytest.fixture
def calls(monkeypatch):
    """Names of the scheduler's launch functions, in call order."""
    seen = []
    for name in LAUNCHERS:
        fn = getattr(sched, name)
        monkeypatch.setattr(
            sched, name,
            lambda *a, fn=fn, name=name, **kw: seen.append(name) or fn(*a,
                                                                      **kw))
    return seen


def _pairs(seed, n, lo, hi, div=0.15):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(lo, hi)),
                                  divergence=div, indel=div / 2.5)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _spliced(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [spliced_pair(rng, int(rng.integers(lo, hi))) for _ in range(n)]


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _buckets(pairs, key=sched._bucket_key):
    return len({key(len(q), len(t)) for q, t in pairs})


@pytest.mark.parametrize("flag", [X, S | X])
def test_two_piece_extz_only_bucket_is_one_launch(calls, flag):
    """EXTZ_ONLY two-piece CIGARs and SCORE_ONLY|EXTZ_ONLY scores at
    minimap2 -x sr's costs (-A2 -B8 -O12,24 -E2,1 -r100 --end-bonus 10
    -z100): one launch of kernel 13 (and 17) a bucket, pairs ordered
    longest first; each pair equals the spec, reach_end included, and
    the async handle gives the same."""
    pairs = _pairs(7, 12, 150, 260, div=0.03)
    aln = Aligner(a=2, b=8, q=12, e=2, q2=24, e2=1, w=100, zdrop=100,
                  end_bonus=10, flag=flag, device="cpu")
    got = aln.extend_batch(pairs)
    name = "extd_records" if flag & S else "extd_cigar_launch"
    assert calls == [name] * _buckets(pairs)
    want = [diagdiff.extd2(q, t, 5, simple_mat(5, 2, 8), 12, 2, 24, 1,
                           w=100, zdrop=100, end_bonus=10, flag=flag)[0]
            for q, t in pairs]
    assert [_row(g) for g in got] == [_row(w) for w in want]
    if not flag & S:
        assert any(g.reach_end for g in got)
    h = aln.extend_batch_async(pairs)
    assert [_row(g) for g in h.result()] == [_row(w) for w in want]


def test_two_piece_end_bonus_scores_over_1536(calls):
    """Two-piece SCORE_ONLY with ``end_bonus`` on targets over 1536 and no
    band: band and batched refuse, the single-pair two-piece engine takes
    the bucket in score form."""
    pairs = _pairs(8, 2, 1600, 1700)
    aln = Aligner(q2=13, e2=1, zdrop=100, end_bonus=5, flag=S, device="cpu")
    got = aln.extend_batch(pairs)
    assert calls == ["extd_records"] * _buckets(pairs)
    want = [diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, zdrop=100, flag=S)[0]
            for q, t in pairs]
    assert [_row(g) for g in got] == [_row(w) for w in want]


@pytest.mark.parametrize("flag", [SPL | X,
                                  SPL | X | Flag.RIGHT | Flag.REV_CIGAR,
                                  SPL | X | S])
def test_splice_extz_only_bucket_is_one_launch(calls, flag):
    """minimap2 -x splice's end extensions (EXTZ_ONLY; the left end
    EXTZ_ONLY|RIGHT|REV_CIGAR): strips and the batched exts engine refuse
    EXTZ_ONLY, the single-pair splice engine takes each bucket in one
    launch of kernel 14 (and 17); N ops, no reach_end."""
    pairs = _spliced(9, 10, 150, 300)
    aln = Aligner(flag=flag, device="cpu", **SPLICE)
    got = aln.extend_batch(pairs)
    name = "exts_records" if flag & S else "exts_cigar_launch"
    assert calls == [name] * _buckets(pairs, sched._jax_bucket_key)
    want = [diagdiff.exts2(q, t, 5, SPL_MAT, 2, 1, 32, 9, zdrop=200,
                           flag=flag)[0] for q, t in pairs]
    assert [_row(g) for g in got] == [_row(w) for w in want]
    if not flag & S:
        assert any(c & 0xF == 3 for g in got for c in g.cigar)


def test_long_annotated_splice_bucket(calls):
    """Annotated splice pairs with targets over 1536 take the single-pair
    splice engine, their junction tracks folded into the site rows."""
    rng = np.random.default_rng(10)
    pairs, juncs = [], []
    for _ in range(2):
        q, t, (a, b) = spliced_pair(rng, int(rng.integers(1600, 1800)),
                                    sites=True)
        j = np.zeros(len(t), np.uint8)
        j[a], j[b] = 1, 2
        pairs.append((q, t))
        juncs.append(j)
    aln = Aligner(flag=SPL, junc_bonus=9, device="cpu", **SPLICE)
    got = aln.extend_batch(pairs, juncs=juncs)
    assert calls == ["exts_cigar_launch"] * _buckets(pairs,
                                                     sched._jax_bucket_key)
    want = [diagdiff.exts2(q, t, 5, SPL_MAT, 2, 1, 32, 9, zdrop=200,
                           junc_bonus=9, flag=SPL, junc=j)[0]
            for (q, t), j in zip(pairs, juncs)]
    assert [_row(g) for g in got] == [_row(w) for w in want]


def test_single_pair_splice_route_resets_as_exts2(calls):
    """``q2 <= q + e`` resets the single-pair splice buckets before any
    launch, as ``exts2`` does."""
    pairs = _spliced(11, 3, 100, 200)
    kw = dict(SPLICE, q2=3)
    got = Aligner(flag=SPL | X, device="cpu", **kw).extend_batch(pairs)
    assert calls == []
    want = [diagdiff.exts2(q, t, 5, SPL_MAT, 2, 1, 3, 9, zdrop=200,
                           flag=SPL | X)[0] for q, t in pairs]
    assert [_row(g) for g in got] == [_row(w) for w in want]


@pytest.mark.parametrize("kind", ["extd", "exts"])
def test_budget_splits_a_bucket(calls, monkeypatch, kind):
    """A bucket whose buffers pass ``ops.strips.LAUNCH_BYTES`` goes out as
    several launches, and the results are the unsplit bucket's."""
    if kind == "extd":
        pairs = _pairs(12, 6, 150, 200)
        aln = Aligner(q2=13, e2=1, w=60, zdrop=100, flag=X, device="cpu")
    else:
        pairs = _spliced(12, 6, 150, 200)
        aln = Aligner(flag=SPL | X, device="cpu", **SPLICE)
    whole = aln.extend_batch(pairs)
    n = len(calls)
    monkeypatch.setattr(strips, "LAUNCH_BYTES", 60000)
    split = aln.extend_batch(pairs)
    assert len(calls) - n > n
    assert [_row(g) for g in split] == [_row(g) for g in whole]


def test_earlier_routes_keep_their_buckets(calls):
    """Buckets the strips, band and batched routes take stay there: a
    two-piece unbanded CIGAR on a short pair (strips), a long pair at
    w = 50 (band), a short clipping band (batched), an unannotated splice
    pair (strips) and an annotated short one (batched exts)."""
    short = _pairs(13, 1, 300, 320)
    long_ = _pairs(14, 1, 600, 620)
    for pairs, w, want in ((short, -1, "strips_cigar_launch"),
                           (long_, 50, "band_cigar_launch"),
                           (short, 20, "batch_cigar_launch")):
        calls.clear()
        Aligner(q2=13, e2=1, zdrop=100, device="cpu").extend_batch(
            pairs, w=[w])
        assert calls == [want], (w, calls)
    spl = _spliced(15, 1, 200, 220)
    calls.clear()
    Aligner(flag=SPL, device="cpu", **SPLICE).extend_batch(spl)
    assert calls == ["strips_cigar_launch"]
    calls.clear()
    j = np.zeros(len(spl[0][1]), np.uint8)
    Aligner(flag=SPL, junc_bonus=9, device="cpu", **SPLICE).extend_batch(
        spl, juncs=[j])
    assert calls == ["batch_exts_cigar_launch"]
