"""The single-pair two-piece and splice engines' pins in chip_smoke.py,
recomputed from the spec.

No reference-binary anchors exist in this tree for these workloads, so
``chip_smoke.SINGLE2_PINS`` were computed with the byte-parity spec
``ksw2_tpu.spec.diagdiff.extd2`` / ``exts2``: the seeded 50 kb pair at
A2 B4 -O4,13 -E2,1 (exact score, ``-sg``, CIGAR), the short-banded
workload as minimap2 -x sr's extension (-A2 -B8 -O12,24 -E2,1 -r100
--end-bonus 10 -z100, EXTZ_ONLY CIGARs and scores), the splice workload's
end extensions (EXTZ_ONLY, and EXTZ_ONLY|RIGHT|REV_CIGAR) and 64 seeded
annotated spliced pairs of 2-12 kb (--junc-bonus 9).  The tier-1 tests
recompute the prefix pins (the 50 kb pair cut to its first 2 kb, the
first 64 sr pairs, the first 64 splice pairs, the first 16 long spliced
pairs cut to 2 kb) and run the port's CPU route on them; the tests
marked ``slow`` recompute the whole pins (the 50 kb CIGAR needs ~5 GB and
an int64 backtrack, which the test patches in):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_single2_pins.py -m slow
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
SR_MAT = simple_mat(5, *chip_smoke.SR_EXTD_MAT)
SPL_MAT = simple_mat(5, 1, 2)
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
X, S, SPL = Flag.EXTZ_ONLY, Flag.SCORE_ONLY, Flag.SPLICE_FOR
EB = chip_smoke.END_BONUS
JB = chip_smoke.SPLICE_JUNC_BONUS

# pin name -> flag of the 50 kb pair's run (unbanded, no Z-drop)
SINGLE = {"single_extd_score": S, "single_extd_sg": S | APPROX,
          "single_extd_cigar": Flag.NONE}
# pin name -> flag of the batch run
SR = {"sr_extd_cigar": X, "sr_extd_score": S | X}
ENDS = {"splice_ends_cigar": SPL | X,
        "splice_ends_left_cigar": SPL | X | Flag.RIGHT | Flag.REV_CIGAR}
LONG = {"splice_long_cigar": SPL, "splice_long_score": SPL | S}


def _backtrack64(p, off, off_end, n_col, i0, j0, **kw):
    """The spec's backtrack with Python-int row offsets: a 50 kb pair's
    flat byte index passes 2**31, past the int32 of its offset arrays."""
    def ints(a):
        return None if a is None else [int(v) for v in a]
    if kw.get("store_off") is not None:
        kw["store_off"] = ints(kw["store_off"])
    return spec_backtrack.backtrack(p, ints(off), ints(off_end), n_col, i0,
                                    j0, **kw)


def _single(prefix):
    q, t = chip_smoke.single_pair(chip_smoke.SINGLE_SEED,
                                  chip_smoke.SINGLE_LEN)
    n = chip_smoke.SINGLE2_PREFIX
    return (q[:n], t[:n]) if prefix else (q, t)


def spec_single_pin(name, prefix=False):
    flag = SINGLE[name]
    ez, _ = diagdiff.extd2(*_single(prefix), 5, MAT, *chip_smoke.EXTD,
                           flag=flag)
    return chip_smoke.single_pin(ez, not flag & S)


def _sr_one(pair, flag):
    return diagdiff.extd2(*pair, 5, SR_MAT, *chip_smoke.SR_EXTD,
                          w=chip_smoke.SHORT_BANDED_W, zdrop=100,
                          end_bonus=EB, flag=flag)[0]


def _ends_one(pair, flag):
    q, e, q2, noncan = chip_smoke.SPLICE
    return diagdiff.exts2(*pair, 5, SPL_MAT, q, e, q2, noncan,
                          zdrop=chip_smoke.SPLICE_ZDROP, flag=flag)[0]


def _long_one(job, flag):
    (qq, tt), junc = job
    q, e, q2, noncan = chip_smoke.SPLICE
    return diagdiff.exts2(qq, tt, 5, SPL_MAT, q, e, q2, noncan,
                          zdrop=chip_smoke.SPLICE_ZDROP, junc_bonus=JB,
                          flag=flag, junc=junc)[0]


@functools.lru_cache(maxsize=1)
def _sr_jobs():
    return chip_smoke.short_banded_jobs()


@functools.lru_cache(maxsize=1)
def _splice_jobs():
    return chip_smoke.splice_jobs()


@functools.lru_cache(maxsize=2)
def _long_jobs(cut: bool):
    pairs, juncs = chip_smoke.splice_long_jobs()
    if cut:
        n = chip_smoke.SPLICE_LONG_PREFIX
        pairs, juncs = chip_smoke.cut_jobs(pairs[:n], juncs[:n],
                                           chip_smoke.SPLICE_LONG_CUT)
    return pairs, juncs


def _map(fn, items, workers):
    if workers > 1:
        with ProcessPoolExecutor(workers) as ex:
            return list(ex.map(fn, items, chunksize=8))
    return [fn(x) for x in items]


def spec_batch_pin(name, prefix: bool, workers: int = 1):
    """The spec's sr_pin of a batch pin: the whole workload's, or its
    prefix's (the first pairs; the first 16 long spliced pairs cut to
    2 kb)."""
    if name in SR:
        jobs = _sr_jobs()[:chip_smoke.SR_PREFIX if prefix else None]
        fn = functools.partial(_sr_one, flag=SR[name])
    elif name in ENDS:
        jobs = _splice_jobs()[
            :chip_smoke.SPLICE_ENDS_PREFIX if prefix else None]
        fn = functools.partial(_ends_one, flag=ENDS[name])
    else:
        pairs, juncs = _long_jobs(prefix)
        jobs = list(zip(pairs, juncs))
        fn = functools.partial(_long_one, flag=LONG[name])
    return chip_smoke.sr_pin(_map(fn, jobs, workers))


def port_batch_pin(name, prefix: bool):
    """The port's CPU route on a batch pin's prefix."""
    if name in SR:
        a, b = chip_smoke.SR_EXTD_MAT
        q, e, q2, e2 = chip_smoke.SR_EXTD
        aln = Aligner(a=a, b=b, q=q, e=e, q2=q2, e2=e2,
                      w=chip_smoke.SHORT_BANDED_W, zdrop=100, end_bonus=EB,
                      flag=SR[name], device="cpu")
        return chip_smoke.sr_pin(aln.extend_batch(
            _sr_jobs()[:chip_smoke.SR_PREFIX]))
    q, e, q2, noncan = chip_smoke.SPLICE
    flag = ENDS.get(name, LONG.get(name))
    aln = Aligner(a=1, b=2, q=q, e=e, q2=q2, splice=True, noncan=noncan,
                  zdrop=chip_smoke.SPLICE_ZDROP,
                  junc_bonus=0 if name in ENDS else JB, flag=flag,
                  device="cpu")
    if name in ENDS:
        return chip_smoke.sr_pin(aln.extend_batch(
            _splice_jobs()[:chip_smoke.SPLICE_ENDS_PREFIX]))
    pairs, juncs = _long_jobs(True)
    return chip_smoke.sr_pin(aln.extend_batch(pairs, juncs=juncs))


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_extd_prefix_pins(name):
    """The 50 kb pair cut to its first 2 kb: the spec's pin, and the
    port's single-pair two-piece engine on the CPU gives it too."""
    want = chip_smoke.SINGLE2_PINS[name][1]
    assert spec_single_pin(name, prefix=True) == want
    q, e, q2, e2 = chip_smoke.EXTD
    got = Aligner(q=q, e=e, q2=q2, e2=e2, flag=SINGLE[name],
                  device="cpu").extend(*_single(True))
    assert chip_smoke.single_pin(got, not SINGLE[name] & S) == want


@pytest.mark.parametrize("name", [*SR, *ENDS, *LONG])
def test_batch_prefix_pins(name):
    """A batch pin's prefix: the spec's, and the port's CPU route (the
    single-pair engines) agrees with it."""
    want = chip_smoke.SINGLE2_PINS[name][1]
    assert spec_batch_pin(name, prefix=True) == want
    assert port_batch_pin(name, prefix=True) == want


def test_workloads_are_the_stated_sizes():
    """The long spliced pairs have targets of 2-12 kb (over the batched
    exts route's 1536, so annotated they take the single-pair engine)
    and an annotated intron each; the sr pairs are the short-banded
    workload's."""
    pairs, juncs = _long_jobs(False)
    assert len(pairs) == chip_smoke.SPLICE_LONG_N
    lo, hi = chip_smoke.SPLICE_LONG_T
    assert all(lo <= len(t) <= hi for _, t in pairs)
    assert all(int((j == 1).sum()) == 1 and int((j == 2).sum()) == 1
               for j in juncs)
    assert len(_sr_jobs()) == 4096


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SINGLE))
def test_single_extd_pins_whole(name, monkeypatch):
    """The 50 kb pair's pins recomputed whole (1-3 minutes each; the
    CIGAR ~5 GB of spec byte store)."""
    monkeypatch.setattr(diagdiff, "backtrack", _backtrack64)
    assert spec_single_pin(name) == chip_smoke.SINGLE2_PINS[name][0]


@pytest.mark.slow
@pytest.mark.parametrize("name", [*SR, *ENDS, *LONG])
def test_batch_pins_whole(name):
    assert spec_batch_pin(name, prefix=False, workers=3) == \
        chip_smoke.SINGLE2_PINS[name][0]
