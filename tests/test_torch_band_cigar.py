"""The port's band forward and walker against the JAX band engines and
the spec: CIGARs.

The plain band forward with bytes plus ``ops.band_walker.band_walk_plain``
against ``ksw2_tpu.ops.band_batch.extz_band_batch_align`` /
``extd_band_batch_align`` run under the Pallas interpreter and against
``spec.diagdiff.extz2`` / ``extd2``, exactly, on the cases of
tests/test_band.py.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna
from ksw2_tpu.ops import band_batch as jband

from test_torch_band import EXTD, GMAT, MAT, _fields, _mk, _padded, _port, \
    _spec

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)


def _tsv(ez):
    return (ez.tsv_fields(), list(ez.cigar), _fields(ez))


@pytest.mark.parametrize("zdrop,flag", [
    (-1, Flag.NONE), (60, Flag.NONE), (60, Flag.RIGHT),
    (60, Flag.APPROX_MAX | Flag.APPROX_DROP), (60, Flag.REV_CIGAR),
    (60, Flag.EQX),
])
def test_band_cigars_match_jax_and_spec(zdrop, flag):
    pairs, rng = _mk(51 + zdrop, 4, 150, 450, 0.15, 0.08)
    wv = rng.integers(10, 64, len(pairs)).astype(np.int32)
    Q, T, ql, tl = _padded(pairs)
    jz = jband.extz_band_batch_align(Q, T, ql, tl, 5, MAT, 4, 2, wv,
                                     zdrop=zdrop, flag=flag, interpret=True)
    jd = jband.extd_band_batch_align(Q, T, ql, tl, 5, MAT, *EXTD, wv,
                                     zdrop=zdrop, flag=flag, interpret=True)
    for costs, jx in ((None, jz), (EXTD, jd)):
        got = _port(pairs, wv, zdrop, flag, costs)
        for i, (q, t) in enumerate(pairs):
            want = _spec(q, t, int(wv[i]), zdrop, flag, costs)
            assert _tsv(got[i]) == _tsv(want) == _tsv(jx[i]), (costs, i)


def test_band_eqx_converts_two_piece_only():
    """The extd route turns M into =/X (band_batch.py:833-838); extz2
    ignores KSW_EZ_EQX (batch_pallas.py:773-775), so its CIGARs keep M."""
    pairs, rng = _mk(77, 3, 200, 600, 0.2, 0.1)
    wv = rng.integers(30, 180, len(pairs)).astype(np.int32)
    one = _port(pairs, wv, 60, Flag.EQX)
    two = _port(pairs, wv, 60, Flag.EQX, EXTD)
    ops = lambda ez: {c & 0xF for c in ez.cigar}     # noqa: E731
    assert all(0 in ops(ez) and not ops(ez) & {7, 8} for ez in one)
    assert all(0 not in ops(ez) and ops(ez) & {7, 8} for ez in two)
    for i, (q, t) in enumerate(pairs):
        assert two[i].cigar == _spec(q, t, int(wv[i]), 60, Flag.EQX,
                                     EXTD).cigar


@pytest.mark.parametrize("zdrop", [-1, 50])
def test_band_generic_sc_matches_jax_and_spec(zdrop):
    pairs, rng = _mk(61 + zdrop, 3, 150, 400, 0.25, 0.12, 0, True)
    wv = rng.integers(10, 80, len(pairs)).astype(np.int32)
    Q, T, ql, tl = _padded(pairs)
    flag = Flag.GENERIC_SC
    jz = jband.extz_band_batch_align(Q, T, ql, tl, 5, GMAT, 4, 2, wv,
                                     zdrop=zdrop, flag=flag, interpret=True)
    jd = jband.extd_band_batch_align(Q, T, ql, tl, 5, GMAT, *EXTD, wv,
                                     zdrop=zdrop, flag=flag, interpret=True)
    for costs, jx in ((None, jz), (EXTD, jd)):
        got = _port(pairs, wv, zdrop, flag, costs, GMAT)
        for i, (q, t) in enumerate(pairs):
            want = _spec(q, t, int(wv[i]), zdrop, flag, costs, GMAT)
            assert _tsv(got[i]) == _tsv(want) == _tsv(jx[i]), (costs, i)


def test_band_zdropped_walk():
    """A divergent tail Z-drops the pair midway: the walk starts at the
    best cell, far below the last diagonal (tests/test_band.py:306-330)."""
    rng = np.random.default_rng(77)
    t1, q1 = refcmp.random_pair(rng, 3000, divergence=0.1, indel=0.03)
    t2, _ = refcmp.random_pair(rng, 3000, divergence=0.1, indel=0.03)
    q, t = encode_dna(q1[:1500] + t2[:1500]), encode_dna(t1)
    got = _port([(q, t)], np.array([200], np.int32), 100, Flag.NONE)[0]
    want = _spec(q, t, 200, 100, Flag.NONE)
    assert want.zdropped
    assert _tsv(got) == _tsv(want)
