"""One launch a batch for the single-pair engines (kernels 12, 13, 14).

The scheduler merges every bucket of a batch that its route table sends
to a single-pair engine ("any" or "single") and plans the merged pairs
with one ``single_prep`` call, split only by ``ops.strips.LAUNCH_BYTES``:
the single-pair forward takes mixed lengths in one launch.  For each
single-pair path (one-piece CIGARs, the one-piece "any" score route,
two-piece scores and CIGARs, splice scores and CIGARs) a batch whose jobs
fall into several JAX buckets is held to (a) one launch under the default
budget and, under a small one, the fewest launches that fit; (b) the JAX
package's spec (``ksw2_tpu.spec.diagdiff``), exactly, for the 9 fields
and the CIGAR words, whatever the packing.  Run on the CPU, where the
wrappers take the kernels' plain versions.
"""
import functools
from unittest import mock

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
from ksw2_tpu_torch.ops import extz_fwd as F
from ksw2_tpu_torch.ops import strips

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

S, X = Flag.SCORE_ONLY, Flag.EXTZ_ONLY
SPL = Flag.SPLICE_FOR
LAUNCHERS = ("extz_records", "extz_cigar_launch", "extd_records",
             "extd_cigar_launch", "exts_records", "exts_cigar_launch")
SPLICE = dict(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=9, zdrop=200)
SR = dict(a=2, b=8, q=12, e=2, q2=24, e2=1, zdrop=100, end_bonus=10)
BIG = simple_mat(5, 100, 4)   # exact Z-drop past the packed-argmax range


def _pairs(seed, lens, div=0.12):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=div / 2.5)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _spliced(seed, lens):
    rng = np.random.default_rng(seed)
    return [spliced_pair(rng, L) for L in lens]


# name: (aligner keywords, pairs, w, the spec's result for one pair, the
# scheduler's bucket key); every batch spans several buckets
CASES = {
    "extz_cigar": (
        dict(zdrop=100, end_bonus=10, flag=X),
        lambda: _pairs(31, (160, 240, 330, 420, 650)), 100,
        lambda q, t: diagdiff.extz2(q, t, 5, simple_mat(5, 2, 4), 4, 2,
                                    w=100, zdrop=100, end_bonus=10,
                                    flag=X)[0],
        sched._bucket_key),
    "any_score": (
        dict(mat=BIG, zdrop=100, flag=S),
        lambda: _pairs(32, (1600, 1550)) +
        [(lambda p: (p[0][:1400], p[1]))(_pairs(33, (2100,))[0])],
        -1,
        lambda q, t: diagdiff.extz2(q, t, 5, BIG, 4, 2, zdrop=100,
                                    flag=S)[0],
        sched._bucket_key),
    "extd_score": (
        dict(SR, w=100, flag=S | X),
        lambda: _pairs(34, (170, 230, 350, 480, 600), div=0.03), 100,
        lambda q, t: diagdiff.extd2(q, t, 5, simple_mat(5, 2, 8), 12, 2,
                                    24, 1, w=100, zdrop=100, end_bonus=10,
                                    flag=S | X)[0],
        sched._bucket_key),
    "extd_cigar": (
        dict(SR, w=100, flag=X),
        lambda: _pairs(35, (150, 260, 380, 520, 700), div=0.03), 100,
        lambda q, t: diagdiff.extd2(q, t, 5, simple_mat(5, 2, 8), 12, 2,
                                    24, 1, w=100, zdrop=100, end_bonus=10,
                                    flag=X)[0],
        sched._bucket_key),
    "exts_score": (
        dict(SPLICE, flag=SPL | S | X),
        lambda: _spliced(36, (140, 210, 300, 420)), -1,
        lambda q, t: diagdiff.exts2(q, t, 5, simple_mat(5, 1, 2), 2, 1, 32,
                                    9, zdrop=200, flag=SPL | S | X)[0],
        sched._jax_bucket_key),
    "exts_cigar": (
        dict(SPLICE, flag=SPL | X | Flag.RIGHT | Flag.REV_CIGAR),
        lambda: _spliced(37, (150, 200, 290, 400)), -1,
        lambda q, t: diagdiff.exts2(q, t, 5, simple_mat(5, 1, 2), 2, 1, 32,
                                    9, zdrop=200,
                                    flag=SPL | X | Flag.RIGHT |
                                    Flag.REV_CIGAR)[0],
        sched._jax_bucket_key),
}


def _recording(seen):
    """Patches of the scheduler's single-pair launch functions that append
    each launch they are handed to ``seen``."""
    return [mock.patch.object(
        sched, name,
        lambda ln, *a, fn=getattr(sched, name), **kw:
        seen.append(ln) or fn(ln, *a, **kw)) for name in LAUNCHERS]


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _run(name):
    """The case's pairs, results and the launches the scheduler made."""
    kw, pairs, w, _, key = CASES[name]
    pairs = pairs()
    assert len({key(len(q), len(t)) for q, t in pairs}) > 1
    aln = Aligner(device="cpu", **kw)
    seen = []
    patches = _recording(seen)
    for p in patches:
        p.start()
    try:
        got = aln.extend_batch(pairs, w=[w] * len(pairs))
    finally:
        for p in patches:
            p.stop()
    return pairs, got, seen


@functools.lru_cache(maxsize=None)
def _whole(name):
    """:func:`_run` under the default budget, once a case a process."""
    return _run(name)


def _sizes(ln):
    return F.launch_bytes(ln.qlen, ln.tlen, ln.w, ln.lay.tp, ln.prm.cig)


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_is_one_launch(name):
    """The batch's single-pair jobs, several buckets of them, go out as
    one launch holding every pair, longest first, within the budget."""
    pairs, _, launches = _whole(name)
    assert len(launches) == 1
    ln, = launches
    assert len(ln.qlen) == len(pairs)
    n = (ln.qlen.astype(np.int64) + ln.tlen)
    assert list(n) == sorted(n, reverse=True)
    assert int(_sizes(ln).sum()) <= strips.LAUNCH_BYTES


@pytest.mark.parametrize("name", sorted(CASES))
def test_small_budget_fewest_launches(monkeypatch, name):
    """Under a budget of half the batch's buffers plus its largest pair,
    the merged pairs go out as two launches, the fewest that fit: each
    within the budget, together every pair once, the first as full as the
    budget lets it be; the results are the one launch's."""
    _, whole, (ln,) = _whole(name)
    sizes = _sizes(ln)
    budget = int(sizes.sum()) // 2 + int(sizes.max())
    assert budget < int(sizes.sum())
    monkeypatch.setattr(strips, "LAUNCH_BYTES", budget)
    _, split, launches = _run(name)
    assert len(launches) == 2
    assert sum(len(x.qlen) for x in launches) == len(ln.qlen)
    assert all(int(_sizes(x).sum()) <= budget for x in launches)
    first = int(_sizes(launches[0]).sum())
    assert first + int(_sizes(launches[1])[0]) > budget
    assert [_row(g) for g in split] == [_row(g) for g in whole]


@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_batch_matches_jax_spec(name):
    """Every pair of the merged launch equals the JAX package's spec
    engine: the 9 fields, reach_end and the CIGAR words, exactly."""
    pairs, got, _ = _whole(name)
    spec = CASES[name][3]
    assert [_row(g) for g in got] == [_row(spec(q, t)) for q, t in pairs]
