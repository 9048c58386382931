"""The single-pair engine's pins in chip_smoke.py, recomputed from the spec.

No reference-binary anchors exist in this tree for the single-pair
workloads (the JAX bench's 50 kb and MT pairs are not in it), so
``chip_smoke.SINGLE_PINS`` were computed with the byte-parity spec
``ksw2_tpu.spec.diagdiff.extz2``: the seeded 50 kb pair (exact score,
``-sg``, CIGAR), the seeded MT-length pair (CIGAR at -z100, EXTZ_ONLY
CIGAR with end_bonus 10) and the short-banded workload as EXTZ_ONLY
CIGARs at -w100 -z100 --end-bonus 10.  The tier-1 tests recompute the
prefix pins (the MT pair cut to its first 2 kb, the first 64 short-banded
pairs) and run the port's CPU route on them; the tests marked ``slow``
recompute the whole pins (about 5 minutes on 3 processes):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_extz_pins.py -m slow
"""
import functools
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch

import chip_smoke
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.spec import backtrack as spec_backtrack
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
EB = chip_smoke.END_BONUS

# pin name -> (flag, zdrop, end_bonus) on its pair, unbanded
SINGLE = {
    "single_score": (Flag.SCORE_ONLY, -1, 0),
    "single_sg": (Flag.SCORE_ONLY | APPROX, -1, 0),
    "single_cigar": (Flag.NONE, -1, 0),
    "single_mt_cigar": (Flag.NONE, 100, 0),
    "single_mt_extz_cigar": (Flag.EXTZ_ONLY, 100, EB),
}


def _backtrack64(p, off, off_end, n_col, i0, j0, **kw):
    """The spec's backtrack with Python-int row offsets: a 50 kb pair's
    flat byte index passes 2**31, past the int32 of its offset arrays."""
    def ints(a):
        return None if a is None else [int(v) for v in a]
    if kw.get("store_off") is not None:
        kw["store_off"] = ints(kw["store_off"])
    return spec_backtrack.backtrack(p, ints(off), ints(off_end), n_col, i0,
                                    j0, **kw)


def _pair(name, prefix):
    if name.startswith("single_mt"):
        q, t = chip_smoke.single_pair(chip_smoke.MT_SEED, chip_smoke.MT_LEN)
        if prefix:
            q, t = q[:chip_smoke.MT_PREFIX], t[:chip_smoke.MT_PREFIX]
        return q, t
    return chip_smoke.single_pair(chip_smoke.SINGLE_SEED,
                                  chip_smoke.SINGLE_LEN)


def spec_single_pin(name, prefix=False):
    flag, zdrop, eb = SINGLE[name]
    q, t = _pair(name, prefix)
    ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2, zdrop=zdrop, end_bonus=eb,
                           flag=flag)
    return chip_smoke.single_pin(ez, not flag & Flag.SCORE_ONLY)


def _want(name, prefix):
    pin = chip_smoke.SINGLE_PINS[name]
    return pin[1 if prefix else 0] if name.startswith("single_mt") else pin


def _sr_one(pair):
    q, t = pair
    ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2, w=chip_smoke.SHORT_BANDED_W,
                           zdrop=100, end_bonus=EB, flag=Flag.EXTZ_ONLY)
    return ez


@functools.lru_cache(maxsize=1)
def _sr_jobs():
    return chip_smoke.short_banded_jobs()


def spec_sr_pin(prefix: bool, workers: int = 1):
    jobs = _sr_jobs()
    if prefix:
        jobs = jobs[:chip_smoke.SR_PREFIX]
    if workers > 1:
        with ProcessPoolExecutor(workers) as ex:
            out = list(ex.map(_sr_one, jobs, chunksize=32))
    else:
        out = [_sr_one(p) for p in jobs]
    return chip_smoke.sr_pin(out)


def _sr_aligner():
    return Aligner(w=chip_smoke.SHORT_BANDED_W, zdrop=100, end_bonus=EB,
                   flag=Flag.EXTZ_ONLY, device="cpu")


@pytest.mark.parametrize("name", ["single_mt_cigar", "single_mt_extz_cigar"])
def test_single_mt_prefix_pins(name):
    """The MT-length pair cut to its first 2 kb: the spec's pin, and the
    port's single-pair engine on the CPU gives it too."""
    want = _want(name, True)
    assert spec_single_pin(name, prefix=True) == want
    flag, zdrop, eb = SINGLE[name]
    q, t = _pair(name, True)
    got = Aligner(zdrop=zdrop, end_bonus=eb, flag=flag,
                  device="cpu").extend(q, t)
    assert chip_smoke.single_pin(got, True) == want


def test_sr_extension_prefix_pin():
    """The first 64 short-banded pairs as EXTZ_ONLY CIGARs: the spec's pin
    and the port's CPU route (the single-pair engine) agree with it."""
    want = chip_smoke.SINGLE_PINS["sr_extension"][1]
    assert spec_sr_pin(prefix=True) == want
    jobs = _sr_jobs()[:chip_smoke.SR_PREFIX]
    assert chip_smoke.sr_pin(_sr_aligner().extend_batch(jobs)) == want


def test_single_pair_workloads_are_the_bench_lengths():
    """The seeded pairs have the bench rows' target lengths."""
    assert len(_pair("single_score", False)[1]) == chip_smoke.SINGLE_LEN
    assert len(_pair("single_mt_cigar", False)[1]) == 16569


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SINGLE))
def test_single_pins_whole(name, monkeypatch):
    """Every single-pair pin recomputed whole from the spec (the 50 kb
    ones take 1-2 minutes each, the CIGAR ~5 GB of spec byte store)."""
    monkeypatch.setattr(diagdiff, "backtrack", _backtrack64)
    assert spec_single_pin(name) == _want(name, False)


@pytest.mark.slow
def test_sr_extension_pin_whole():
    assert spec_sr_pin(prefix=False, workers=3) == \
        chip_smoke.SINGLE_PINS["sr_extension"][0]
