"""The band route's pins in chip_smoke.py, recomputed from the spec.

No reference-binary anchors exist in this tree for a long banded
workload, so ``chip_smoke.BAND_PINS`` were computed with the byte-parity
spec ``ksw2_tpu.spec.diagdiff.extz2`` / ``extd2`` at ``w = 751``.  The
spec takes about 0.13 s per 1,000 bp of a pair here, so the tier-1 test
recomputes the pins of fixed prefixes of both workloads (the first 4
long-banded pairs, the first 64 mixed pairs), and the test marked
``slow`` recomputes the whole-workload pins with a process pool:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_band_pins.py -m slow
"""
import os
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch

import chip_smoke
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.spec import diagdiff

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)

# pin name -> (workload, two-piece, flag, zdrop); every job has w = 751
CONFIGS = {
    "long_score": ("long", False, Flag.SCORE_ONLY, 400),
    "long_extd_score": ("long", True, Flag.SCORE_ONLY, 400),
    "long_approx_score": (
        "long", False, Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP,
        400),
    "long_cigar": ("long", False, Flag.NONE, 400),
    "long_extd_cigar": ("long", True, Flag.NONE, 400),
    "mixed751_score": ("mixed", False, Flag.SCORE_ONLY, 100),
    "mixed751_cigar": ("mixed", False, Flag.NONE, 100),
}


def _one(args):
    q, t, two, flag, zdrop = args
    if two:
        ez, _ = diagdiff.extd2(q, t, 5, MAT, *chip_smoke.EXTD,
                               w=chip_smoke.BAND_W, zdrop=zdrop, flag=flag)
    else:
        ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2, w=chip_smoke.BAND_W,
                               zdrop=zdrop, flag=flag)
    return ez.max, len(ez.cigar)


def spec_pin(name, prefix: bool, workers: int = 1):
    """The spec's sum of max (scores) or (sum of max, CIGAR ops) over the
    workload of pin ``name``, or over its prefix."""
    wl, two, flag, zdrop = CONFIGS[name]
    if wl == "long":
        jobs = chip_smoke.long_banded_jobs()
        n = chip_smoke.LONG_PREFIX
    else:
        jobs = chip_smoke.mixed_jobs()
        n = chip_smoke.MIXED_PREFIX
    args = [(q, t, two, int(flag), zdrop)
            for q, t in (jobs[:n] if prefix else jobs)]
    if workers > 1:
        with ProcessPoolExecutor(workers) as ex:
            out = list(ex.map(_one, args, chunksize=1))
    else:
        out = [_one(a) for a in args]
    smax = sum(o[0] for o in out)
    if flag & Flag.SCORE_ONLY:
        return smax
    return (smax, sum(o[1] for o in out))


def test_pins_cover_the_configs():
    assert set(chip_smoke.BAND_PINS) == set(CONFIGS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefix_pin_matches_spec(name):
    assert spec_pin(name, prefix=True) == chip_smoke.BAND_PINS[name][1]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_pin_matches_spec(name):
    workers = min(8, os.cpu_count() or 1)
    assert spec_pin(name, prefix=False, workers=workers) == \
        chip_smoke.BAND_PINS[name][0]
