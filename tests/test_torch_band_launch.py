"""One band launch a batch (kernels 9 and 10).

The scheduler merges every bucket of a batch that its route table sends
to the band route into one, its pairs longest first, and plans it with
one ``band_prep`` call: score launches never split, CIGAR launches split
only by ``ops.strips.LAUNCH_BYTES`` (the rotated store, ``B * nd *
ncol`` bytes a launch).  The batched route's buckets launch apart from
the band route's: that route runs other kernels under other EQX rules.  For each
band path (one- and two-piece scores and CIGARs, APPROX scores, and a
batch where strips and band share the work) a batch whose band jobs fall
into several JAX buckets is held to (a) one band launch under the
default budget and, under a small one, the fewest launches that fit;
(b) the JAX package's spec (``ksw2_tpu.spec.diagdiff``), exactly, for
the 9 fields and the CIGAR words, whatever the packing.  Run on the CPU,
where the wrappers take the kernels' plain versions.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import strips
from ksw2_tpu_torch.ops.bands import first_empty_diag, n_col_bytes

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

S = Flag.SCORE_ONLY
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
MAT = simple_mat(5, 2, 4)
BAND = ("band_records", "band_cigar_launch")
LAUNCHERS = BAND + ("strips_records", "strips_cigar_launch", "batch_records",
                    "batch_cigar_launch")


def _pairs(seed, lens, div=0.12):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = refcmp.random_pair(rng, L, divergence=div, indel=div / 2.5)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _spec(two, flag):
    if two:
        return lambda q, t, w: diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, w=w,
                                              zdrop=100, flag=flag)[0]
    return lambda q, t, w: diagdiff.extz2(q, t, 5, MAT, 4, 2, w=w,
                                          zdrop=100, flag=flag)[0]


# band-route pairs: targets of 600-1000 bp (the strips ladder's buckets
# 768 and 1024) clipped by bands of 16-100
LENS = (1000, 610, 760, 880)
BANDS = (100, 16, 37, 64)
# name: (aligner keywords, pairs, bands, the spec's result for one pair)
CASES = {
    "extz_score": (dict(zdrop=100, flag=S), lambda: _pairs(41, LENS), BANDS,
                   _spec(False, S)),
    "extd_score": (dict(q2=13, e2=1, zdrop=100, flag=S),
                   lambda: _pairs(42, LENS), BANDS, _spec(True, S)),
    "approx_score": (dict(zdrop=100, flag=S | APPROX),
                     lambda: _pairs(43, LENS), BANDS, _spec(False, S | APPROX)),
    "extz_cigar": (dict(zdrop=100), lambda: _pairs(44, LENS), BANDS,
                   _spec(False, Flag.NONE)),
    "extd_cigar": (dict(q2=13, e2=1, zdrop=100, flag=Flag.RIGHT),
                   lambda: _pairs(45, LENS), BANDS, _spec(True, Flag.RIGHT)),
    # strips takes the unbanded pairs, band the clipped ones
    "mixed_score": (dict(zdrop=100, flag=S),
                    lambda: _pairs(46, (700, 300, 1000, 650, 200)),
                    (40, -1, 90, 25, -1), _spec(False, S)),
}
CIGAR_CASES = ("extz_cigar", "extd_cigar")


def _recording(seen):
    """Patches of the scheduler's launch functions that append (name,
    launch) of each launch they are handed to ``seen``."""
    return [mock.patch.object(
        sched, name,
        lambda ln, *a, fn=getattr(sched, name), name=name, **kw:
        seen.append((name, ln)) or fn(ln, *a, **kw)) for name in LAUNCHERS]


def _row(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped, ez.reach_end, list(ez.cigar))


def _run(name):
    """The case's pairs, results and the launches the scheduler made."""
    kw, pairs, w, _ = CASES[name]
    pairs = pairs()
    banded = [sched._bucket_key(len(q), len(t))
              for (q, t), wi in zip(pairs, w) if wi >= 0]
    assert len(set(banded)) > 1
    seen = []
    patches = _recording(seen)
    for p in patches:
        p.start()
    try:
        got = Aligner(device="cpu", **kw).extend_batch(pairs, w=list(w))
    finally:
        for p in patches:
            p.stop()
    return pairs, got, seen


@functools.lru_cache(maxsize=None)
def _whole(name):
    """:func:`_run` under the default budget, once a case a process."""
    return _run(name)


def _band(launches):
    return [ln for name, ln in launches if name in BAND]


def _store(ln):
    return len(ln.qlen) * ln.nd * ln.ncol


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_is_one_band_launch(name):
    """The batch's band jobs, several buckets of them, go out as one
    launch holding every one of them, longest first."""
    pairs, _, launches = _whole(name)
    w = CASES[name][2]
    ln, = _band(launches)
    assert len(ln.qlen) == sum(1 for wi in w if wi >= 0)
    n = ln.qlen.astype(np.int64) + ln.tlen
    assert list(n) == sorted(n, reverse=True)
    if ln.prm.cig:
        assert _store(ln) <= strips.LAUNCH_BYTES
    if name == "mixed_score":
        assert {nm for nm, _ in launches} == {"band_records",
                                              "strips_records"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_small_budget_fewest_launches(monkeypatch, name):
    """Under a budget of half the batch's rotated store plus its largest
    pair's, the merged CIGAR pairs go out as two launches, the fewest
    that fit, each within the budget and the first as full as it lets
    it be; score launches hold no store and stay one.  The results are
    the one launch's."""
    _, whole, launches = _whole(name)
    ln, = _band(launches)
    per = ln.nd * ln.ncol
    budget = _store(ln) // 2 + per
    assert budget < _store(ln)
    monkeypatch.setattr(strips, "LAUNCH_BYTES", budget)
    if name not in CIGAR_CASES:
        qs = [ln.query[k, :n] for k, n in enumerate(ln.qlen)]
        ts = [ln.target[k, :n] for k, n in enumerate(ln.tlen)]
        assert len(BD.band_prep(qs, ts, ln.qlen, ln.tlen, ln.w, 5, MAT, 4,
                                2, 100, ln.prm.flag)) == 1
        return
    _, split, launches = _run(name)
    band = _band(launches)
    assert len(band) == 2
    assert sum(len(x.qlen) for x in band) == len(ln.qlen)
    assert all(_store(x) <= budget for x in band)
    first = band[0]
    assert (len(first.qlen) + 1) * first.nd * max(
        first.ncol, int(band[1].ncol)) > budget
    assert [_row(g) for g in split] == [_row(g) for g in whole]


@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_batch_matches_jax_spec(name):
    """Every pair of the merged launch (and, in the mixed batch, of the
    strips launch) equals the JAX package's spec engine: the 9 fields,
    reach_end and the CIGAR words, exactly."""
    pairs, got, _ = _whole(name)
    w, spec = CASES[name][2], CASES[name][3]
    assert [_row(g) for g in got] == [
        _row(spec(q, t, wi if wi >= 0 else max(len(q), len(t))))
        for (q, t), wi in zip(pairs, w)]


def test_batched_route_buckets_launch_apart():
    """Clipped buckets of targets of 512 or less take the batched route,
    whose launches stay apart from the band route's: its kernels and EQX
    rule are not the band route's.  Its buckets whose pairs take kernel
    E's register form go out as one launch; a bucket of the wide form (a
    band of 201 cells) keeps its own."""
    pairs = _pairs(47, (100, 200, 300, 620))
    wide_q, wide_t = _pairs(48, (450,))[0]
    tail = _pairs(49, (150,))[0][0]
    pairs.append((np.concatenate([wide_q, tail]), wide_t))
    w = [30, 30, 30, 50, 200]
    seen = []
    patches = _recording(seen)
    for p in patches:
        p.start()
    try:
        got = Aligner(zdrop=100, device="cpu").extend_batch(pairs, w=w)
    finally:
        for p in patches:
            p.stop()
    names = [nm for nm, _ in seen]
    assert names.count("batch_cigar_launch") == 2
    assert names.count("band_cigar_launch") == 1
    sizes = sorted(len(ln.qlen) for nm, ln in seen
                   if nm == "batch_cigar_launch")
    assert sizes == [1, 3]
    spec = _spec(False, Flag.NONE)
    assert [_row(g) for g in got] == [_row(spec(q, t, wi))
                                      for (q, t), wi in zip(pairs, w)]


def test_merged_keeps_other_routes_in_place():
    """``_merged`` gathers one route group's buckets into the first's
    place, longest pairs first, and leaves every other bucket as it
    was."""
    def bk(idxs, lens, route):
        n = np.array(lens, np.int32)
        return sched._Bucket(idxs, n, n, n // 10, route)
    buckets = [bk([0, 1], [900, 800], "band"), bk([2], [300], "batch"),
               bk([3, 4], [1000, 700], "band"), bk([5], [400], "batch"),
               bk([6], [5000], "single"), bk([7], [9000], "single")]
    out = sched._merged(sched._merged(buckets, sched._SINGLE), ("band",))
    assert [b.route for b in out] == ["band", "batch", "batch", "single"]
    assert out[0].idxs == [3, 0, 1, 4]
    assert list(out[0].tlen) == [1000, 900, 800, 700]
    assert out[1] is buckets[1] and out[2] is buckets[3]
    assert out[3].idxs == [7, 6]


def _tile_first(t0, w):
    return 0 if t0 == 0 else max(t0 - 15, 2 * (t0 - 15) - w)


def _tile_last(t0, tp, qlen, w, rlim):
    x = t0 + tp - 1
    return min(rlim - 1, x + qlen - 1, 2 * x + w)


@pytest.mark.parametrize("w", [1, 16, 100, 751, 752, 1000, 1472])
def test_band_layout_gives_a_warp_one_tile_at_a_time(w):
    """``band_layout`` (from the launch's ncol alone) gives every pair of
    the launch enough warps that a warp's next tile starts after its
    tile's last diagonal (csrc/band_fwd.cu's tile_first / tile_last), at
    most ``NW_MAX`` warps, a ring of at least (warps + 2) groups and a
    block that fits in shared memory."""
    for qlen, tlen in ((w + 1, w + 5), (2000, 3000), (40, 3000),
                       (3000, 40), (5000, 5000)):
        ncol = n_col_bytes(qlen, tlen, w)
        tp, nw, ring = BD.band_layout(ncol)
        assert 2 <= nw <= BD.NW_MAX
        assert ring >= (nw + 2) * BD.KD and ring & (ring - 1) == 0
        assert BD.fwd_smem_bytes(tp, nw, ring) <= strips.SMEM_MAX
        rlim = int(first_empty_diag(qlen, tlen, w))
        ntiles = -(-(tlen + 15) // tp)
        for k in range(ntiles - nw):
            nxt = (k + nw) * tp
            first = _tile_first(nxt, w)
            if first <= _tile_last(nxt, tp, qlen, w, rlim):
                assert first > _tile_last(k * tp, tp, qlen, w, rlim)
