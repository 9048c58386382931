"""The batched route's pins in chip_smoke.py, recomputed from the spec.

No reference-binary anchors exist in this tree for a short banded
workload, so ``chip_smoke.BATCH_PINS`` were computed with the byte-parity
spec ``ksw2_tpu.spec.diagdiff.extz2`` / ``extd2`` at ``w = 100``, z100 on
``chip_smoke.short_banded_jobs()`` (seed 780, 4096 pairs of 150-512 bp).
The spec takes about 30 ms a pair here, so the tier-1 tests recompute
the pins of the first 64 pairs (and run the port's CPU route on them for
two of the pins), and the test marked ``slow`` recomputes the
whole-workload pins with a process pool:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_batch_pins.py -m slow
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

MAT = simple_mat(5, 2, 4)
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP

# pin name -> (two-piece, flag); every job has w = 100, zdrop 100
CONFIGS = {
    "short_banded_score": (False, Flag.SCORE_ONLY),
    "short_banded_extd_score": (True, Flag.SCORE_ONLY),
    "short_banded_approx_score": (False, Flag.SCORE_ONLY | APPROX),
    "short_banded_cigar": (False, Flag.NONE),
    "short_banded_extd_cigar": (True, Flag.NONE),
}


@functools.lru_cache(maxsize=1)
def _jobs():
    return chip_smoke.short_banded_jobs()


def _one(args):
    q, t, two, flag = args
    if two:
        ez, _ = diagdiff.extd2(q, t, 5, MAT, *chip_smoke.EXTD,
                               w=chip_smoke.SHORT_BANDED_W, zdrop=100,
                               flag=flag)
    else:
        ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2,
                               w=chip_smoke.SHORT_BANDED_W, zdrop=100,
                               flag=flag)
    return ez.max, len(ez.cigar)


def _pin(name, out):
    smax = sum(o[0] for o in out)
    if CONFIGS[name][1] & Flag.SCORE_ONLY:
        return smax
    return (smax, sum(o[1] for o in out))


def spec_pin(name, prefix: bool, workers: int = 1):
    """The spec's sum of max (scores) or (sum of max, CIGAR ops) over the
    short-banded workload, or over its first SHORT_BANDED_PREFIX pairs."""
    two, flag = CONFIGS[name]
    jobs = _jobs()
    if prefix:
        jobs = jobs[:chip_smoke.SHORT_BANDED_PREFIX]
    args = [(q, t, two, int(flag)) for q, t in jobs]
    if workers > 1:
        with ProcessPoolExecutor(workers) as ex:
            out = list(ex.map(_one, args, chunksize=16))
    else:
        out = [_one(a) for a in args]
    return _pin(name, out)


def test_pins_cover_the_configs():
    assert set(chip_smoke.BATCH_PINS) == set(CONFIGS)
    jobs = _jobs()
    assert len(jobs) == 4096
    assert min(len(t) for _, t in jobs) >= 150
    assert max(len(t) for _, t in jobs) <= 512


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefix_pin_matches_spec(name):
    assert spec_pin(name, prefix=True) == chip_smoke.BATCH_PINS[name][1]


@pytest.mark.parametrize("name", ["short_banded_cigar",
                                  "short_banded_extd_score"])
def test_port_prefix_matches_pin(name):
    """The port's batched route on the CPU (the plain version chip_smoke
    holds the kernels to) gives the prefix pin: the one-piece CIGAR path
    (forward, walker) and the two-piece score path."""
    two, flag = CONFIGS[name]
    kw = dict(zip(("q", "e", "q2", "e2"), chip_smoke.EXTD)) if two else {}
    aln = Aligner(w=chip_smoke.SHORT_BANDED_W, zdrop=100, flag=flag,
                  device="cpu", **kw)
    ezs = aln.extend_batch(_jobs()[:chip_smoke.SHORT_BANDED_PREFIX])
    assert _pin(name, [(ez.max, len(ez.cigar)) for ez in ezs]) == \
        chip_smoke.BATCH_PINS[name][1]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_pin_matches_spec(name):
    workers = min(8, os.cpu_count() or 1)
    assert spec_pin(name, prefix=False, workers=workers) == \
        chip_smoke.BATCH_PINS[name][0]
