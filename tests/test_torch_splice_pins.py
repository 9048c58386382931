"""The splice path's anchor and pins in chip_smoke.py, recomputed from
the spec.

``chip_smoke.SPLICE_ANCHOR`` is the JAX bench's checksum of
``chip_smoke.splice_jobs()`` (``bench/regen_checksums.py``: the spec
exts2 over 256 two-exon pairs at A1 B2 O2,32 E1 C9 z200, SPLICE_FOR).
``chip_smoke.SPLICE_PINS`` are the annotated run's: each pair with the
junction track ``splice_junc()`` and ``junc_bonus = 9``.  The tier-1
tests recompute the pins of the first SPLICE_PREFIX pairs and run the
port's CPU route on them (the batched exts route for the annotated run,
strips for the anchor's); the test marked ``slow`` recomputes the whole
workload's with a process pool:

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
}


@functools.lru_cache(maxsize=1)
def _jobs():
    return chip_smoke.splice_jobs()


def _one(args):
    q, t, flag, annotated = args
    ez, _ = diagdiff.exts2(
        q, t, 5, MAT, *chip_smoke.SPLICE, zdrop=chip_smoke.SPLICE_ZDROP,
        junc_bonus=chip_smoke.SPLICE_JUNC_BONUS if annotated else 0,
        flag=flag, junc=chip_smoke.splice_junc() if annotated else None)
    return ez.max, len(ez.cigar)


def _pin(flag, out):
    smax = sum(o[0] for o in out)
    return smax if flag & Flag.SCORE_ONLY else (smax,
                                                sum(o[1] for o in out))


def spec_pin(name, prefix: bool, workers: int = 1):
    flag, annotated = CONFIGS[name]
    jobs = _jobs()[:chip_smoke.SPLICE_PREFIX] if prefix else _jobs()
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
    return chip_smoke.SPLICE_PINS[name][1 if prefix else 0]


def test_workload_is_the_bench_rows():
    jobs = _jobs()
    assert len(jobs) == 256
    assert {len(t) for _, t in jobs} == {512}
    assert {len(q) for q, _ in jobs} == {290}
    assert all(tuple(t[200:202]) == (2, 3) and tuple(t[348:350]) == (0, 2)
               for _, t in jobs)
    j = chip_smoke.splice_junc()
    assert list(j.nonzero()[0]) == [200, 349] and list(j[[200, 349]]) == [1, 2]


@pytest.mark.parametrize("name", ["splice_junc_cigar", "splice_junc_score"])
def test_prefix_pin_matches_spec(name):
    assert spec_pin(name, prefix=True) == want(name, prefix=True)


@pytest.mark.parametrize("name", ["splice_junc_cigar", "splice_junc_score"])
def test_port_prefix_matches_pin(name):
    """The port's batched exts route on the CPU (the plain versions
    chip_smoke holds kernel 6 and the band walker to) gives the prefix
    pins of the annotated run."""
    flag, _ = CONFIGS[name]
    q, e, q2, noncan = chip_smoke.SPLICE
    aln = Aligner(a=1, b=2, q=q, e=e, q2=q2, splice=True, noncan=noncan,
                  junc_bonus=chip_smoke.SPLICE_JUNC_BONUS,
                  zdrop=chip_smoke.SPLICE_ZDROP, flag=flag, device="cpu")
    jobs = _jobs()[:chip_smoke.SPLICE_PREFIX]
    ezs = aln.extend_batch(jobs, juncs=[chip_smoke.splice_junc()] * len(jobs))
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
