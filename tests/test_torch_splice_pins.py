"""The splice path's anchor and pins in chip_smoke.py, recomputed from
the spec.

``chip_smoke.SPLICE_ANCHOR`` is the JAX bench's checksum of
``chip_smoke.splice_jobs()`` (``bench/regen_checksums.py``: the spec
exts2 over 256 two-exon pairs at A1 B2 O2,32 E1 C9 z200, SPLICE_FOR).
``chip_smoke.SPLICE_PINS`` are the annotated run's: each pair with the
junction track ``splice_junc()`` and ``junc_bonus = 9``.  The tier-1
tests recompute the pins of the first SPLICE_PREFIX pairs and run the
port's CPU route on them (the batched exts route for the annotated run,
strips for the anchor's).  ``chip_smoke.SPLICE_WIDE_PINS`` are
splice-wide's (``chip_smoke.splice_wide_jobs()``: 256 reads of 871 bp
against 1536 bp windows, each with ``splice_wide_junc()``, junc_bonus 9),
which kernel 6's wide form takes on the card; the tier-1 tests recompute
its CIGAR pin's prefix with the spec and run the port's CPU route (the
batched exts route's plain versions) on the same pairs.  The test marked
``slow`` recomputes the whole workloads' pins with a process pool:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_splice_pins.py -m slow
"""
import functools
import os
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch

import chip_smoke
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 1, 2)
SPL = Flag.SPLICE_FOR

# pin name -> (flag, annotated)
CONFIGS = {
    "splice_cigar": (SPL, False),
    "splice_junc_cigar": (SPL, True),
    "splice_junc_score": (SPL | Flag.SCORE_ONLY, True),
    "splice_wide_junc_cigar": (SPL, True),
    "splice_wide_junc_score": (SPL | Flag.SCORE_ONLY, True),
}


@functools.lru_cache(maxsize=1)
def _jobs():
    return chip_smoke.splice_jobs()


@functools.lru_cache(maxsize=1)
def _wide_jobs():
    return chip_smoke.splice_wide_jobs()


def _one(args):
    q, t, flag, annotated = args
    junc = None
    if annotated:
        junc = chip_smoke.splice_junc() if len(t) == 512 else \
            chip_smoke.splice_wide_junc()
    ez, _ = diagdiff.exts2(
        q, t, 5, MAT, *chip_smoke.SPLICE, zdrop=chip_smoke.SPLICE_ZDROP,
        junc_bonus=chip_smoke.SPLICE_JUNC_BONUS if annotated else 0,
        flag=flag, junc=junc)
    return ez.max, len(ez.cigar)


def _pin(flag, out):
    smax = sum(o[0] for o in out)
    return smax if flag & Flag.SCORE_ONLY else (smax,
                                                sum(o[1] for o in out))


def spec_pin(name, prefix: bool, workers: int = 1):
    flag, annotated = CONFIGS[name]
    jobs = _wide_jobs() if name.startswith("splice_wide") else _jobs()
    jobs = jobs[:chip_smoke.SPLICE_PREFIX] if prefix else jobs
    args = [(q, t, int(flag), annotated) for q, t in jobs]
    if workers > 1:
        with ProcessPoolExecutor(workers) as ex:
            out = list(ex.map(_one, args, chunksize=8))
    else:
        out = [_one(a) for a in args]
    return _pin(flag, out)


def want(name, prefix: bool):
    if name == "splice_cigar":
        assert not prefix
        return chip_smoke.SPLICE_ANCHOR
    pins = chip_smoke.SPLICE_WIDE_PINS if name.startswith("splice_wide") \
        else chip_smoke.SPLICE_PINS
    return pins[name][1 if prefix else 0]


def test_workload_is_the_bench_rows():
    jobs = _jobs()
    assert len(jobs) == 256
    assert {len(t) for _, t in jobs} == {512}
    assert {len(q) for q, _ in jobs} == {290}
    assert all(tuple(t[200:202]) == (2, 3) and tuple(t[348:350]) == (0, 2)
               for _, t in jobs)
    j = chip_smoke.splice_junc()
    assert list(j.nonzero()[0]) == [200, 349] and list(j[[200, 349]]) == [1, 2]


def test_wide_workload_is_annotated_exons():
    """splice-wide: 256 reads of 871 bp (t[120:600] + t[1049:1440]) on
    1536 bp windows with GT at 600 and AG at 1047, the junction track's
    donor bit at 600 and acceptor bit at 1048; its score pins are its
    CIGAR pins' sums of max."""
    jobs = _wide_jobs()
    assert len(jobs) == chip_smoke.SPLICE_WIDE_N == 256
    assert {len(t) for _, t in jobs} == {1536}
    assert {len(q) for q, _ in jobs} == {871}
    assert all(tuple(t[600:602]) == (2, 3) and tuple(t[1047:1049]) == (0, 2)
               for _, t in jobs)
    assert all((a == c).all() and (b == d).all() for (a, b), (c, d) in
               zip(jobs, chip_smoke.splice_wide_jobs(n=4)))
    j = chip_smoke.splice_wide_junc()
    assert list(j.nonzero()[0]) == [600, 1048] and \
        list(j[[600, 1048]]) == [1, 2]
    pins = chip_smoke.SPLICE_WIDE_PINS
    cig, score = pins["splice_wide_junc_cigar"], pins["splice_wide_junc_score"]
    assert (cig[0][0], cig[1][0]) == score


@pytest.mark.parametrize("name", ["splice_junc_cigar", "splice_junc_score",
                                  "splice_wide_junc_cigar"])
def test_prefix_pin_matches_spec(name):
    assert spec_pin(name, prefix=True) == want(name, prefix=True)


@pytest.mark.parametrize("name", ["splice_junc_cigar", "splice_junc_score",
                                  "splice_wide_junc_cigar"])
def test_port_prefix_matches_pin(name):
    """The port's batched exts route on the CPU (the plain versions
    chip_smoke holds kernel 6 and the band walker to) gives the prefix
    pins of the annotated runs."""
    flag, _ = CONFIGS[name]
    q, e, q2, noncan = chip_smoke.SPLICE
    aln = Aligner(a=1, b=2, q=q, e=e, q2=q2, splice=True, noncan=noncan,
                  junc_bonus=chip_smoke.SPLICE_JUNC_BONUS,
                  zdrop=chip_smoke.SPLICE_ZDROP, flag=flag, device="cpu")
    wide = name.startswith("splice_wide")
    jobs = (_wide_jobs() if wide else _jobs())[:chip_smoke.SPLICE_PREFIX]
    junc = chip_smoke.splice_wide_junc() if wide else chip_smoke.splice_junc()
    ezs = aln.extend_batch(jobs, juncs=[junc] * len(jobs))
    assert _pin(flag, [(ez.max, len(ez.cigar)) for ez in ezs]) == \
        want(name, prefix=True)


def test_port_strips_prefix_matches_spec():
    """The unannotated run's first pairs on the port's strips route."""
    q, e, q2, noncan = chip_smoke.SPLICE
    aln = Aligner(a=1, b=2, q=q, e=e, q2=q2, splice=True, noncan=noncan,
                  zdrop=chip_smoke.SPLICE_ZDROP, flag=SPL, device="cpu")
    jobs = _jobs()[:chip_smoke.SPLICE_PREFIX]
    ezs = aln.extend_batch(jobs)
    assert _pin(SPL, [(ez.max, len(ez.cigar)) for ez in ezs]) == \
        _pin(SPL, [_one((a, b, int(SPL), False)) for a, b in jobs])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_pin_matches_spec(name):
    workers = min(8, os.cpu_count() or 1)
    assert spec_pin(name, prefix=False, workers=workers) == \
        want(name, prefix=False)
