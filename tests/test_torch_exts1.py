"""The single-pair splice engine (kernel 14, walked by kernel 17 with
``min_intron = long_thres``) against the JAX package and the spec.

``ops/exts.exts2_device`` over kernel 14's plain version
(``exts_forward_plain``) and kernel 17's is held against the JAX
``ops/exts.exts2_device(..., interpret=True)`` on seeded spliced pairs of
30-150 bp (SPLICE_FOR / SPLICE_REV, FLANK, junction tracks with a bonus,
GENERIC_SC, APPROX, EXTZ_ONLY and RIGHT|REV_CIGAR); the plain forward's
records, stops and compact store against the spec's ``exts2`` and its
``Trace`` on pairs over several tiles of 128 positions; and
``convert.exts_params_from_jax`` against the JAX tuple.  The golden
``exts2_sse`` cases run through ``Aligner.extend``, this engine, in
``test_torch_splice_route.py``.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from chip_smoke import spliced_pair
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.ops import wavefront_exts as wfs
from ksw2_tpu.ops.exts import exts2_device as j_exts2_device
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import convert
from ksw2_tpu_torch.ops import exts as ES
from ksw2_tpu_torch.ops import extz_fwd as F
from ksw2_tpu_torch.ops.band import band_upload

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 1, 2)
COSTS = (2, 1, 32, 9)           # q, e, q2 (intron open), noncan
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
FOR, REV = Flag.SPLICE_FOR, Flag.SPLICE_REV


def _generic_mat():
    m = np.array([[1, -2, -1, -3, -1],
                  [-2, 2, -3, -1, -1],
                  [-1, -3, 1, -2, -1],
                  [-3, -1, -2, 2, -1],
                  [-1, -1, -1, -1, -1]], np.int8)
    return m.reshape(-1)


def _track(q, t, rng):
    """A junction track with a forward donor bit and an acceptor bit at
    random positions of the target."""
    j = np.zeros(len(t), np.uint8)
    a, b = sorted(rng.choice(len(t), 2, replace=False))
    j[a], j[b] = 1, 2
    return j


def _cases():
    """(query, target, zdrop, junc_bonus, flag, junc, mat) seeded spliced
    pairs of 30-150 bp covering the options the engine takes."""
    rng = np.random.default_rng(41)
    opts = [(FOR, 0, False), (FOR | Flag.SCORE_ONLY, 0, False),
            (FOR | Flag.EXTZ_ONLY, 9, True),
            (FOR | Flag.EXTZ_ONLY | Flag.RIGHT | Flag.REV_CIGAR, 9, True),
            (REV, 0, False), (FOR | Flag.SPLICE_FLANK, 0, False),
            (FOR | Flag.GENERIC_SC, 0, False), (FOR, 9, True),
            (FOR | Flag.SCORE_ONLY | APPROX, 0, False),
            (FOR | APPROX, 9, True), (REV | Flag.RIGHT, 9, True),
            (FOR | Flag.EXTZ_ONLY | Flag.SCORE_ONLY, 0, False),
            (Flag.NONE, 0, False), (FOR | Flag.REV_CIGAR, 9, True)]
    out = []
    for k, (flag, jb, junc) in enumerate(opts):
        q, t = spliced_pair(rng, int(rng.integers(30, 151)),
                            with_n=k % 4 == 1)
        mat = _generic_mat() if flag & Flag.GENERIC_SC else MAT
        out.append((q, t, (-1, 30)[k % 2], jb, flag,
                    _track(q, t, rng) if junc else None, mat))
    return out


CASES = _cases()


def _fields(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, bool(ez.zdropped), bool(ez.reach_end), list(ez.cigar))


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_exts2_device_matches_jax(idx):
    """``exts2_device`` over kernel 14's and kernel 17's plain versions
    equals the JAX single-pair splice engine: all 9 fields, no
    reach_end, and the CIGAR words with N ops."""
    q, t, z, jb, flag, junc, mat = CASES[idx]
    want, _ = j_exts2_device(q, t, 5, mat, *COSTS, zdrop=z, junc_bonus=jb,
                             flag=flag, junc=junc, interpret=True)
    got = ES.exts2_device(q, t, 5, mat, *COSTS, zdrop=z, junc_bonus=jb,
                          flag=flag, junc=junc, device="cpu")
    assert _fields(got) == _fields(want)
    assert not got.reach_end


def test_resets_as_exts2_does():
    """``q2 <= q + e``, ``m <= 1`` and degenerate scoring give the reset
    record, as ``exts2_device`` returns at once."""
    q, t, *_ = CASES[0]
    for m, mat, q2 in ((5, MAT, 3), (1, MAT, 32),
                       (5, simple_mat(5, 1, 7), 32)):
        got = ES.exts2_device(q[q < m], t[t < m], m, mat, 2, 1, q2, 9,
                              flag=FOR, device="cpu")
        want, _ = j_exts2_device(q[q < m], t[t < m], m, mat, 2, 1, q2, 9,
                                 flag=FOR, interpret=True)
        assert _fields(got) == _fields(want)
        assert got.max == 0 and got.cigar == []


@pytest.mark.parametrize("seed,tlen,zdrop,junc", [
    (0, 400, -1, False), (1, 700, 200, True), (2, 330, 20, False)])
def test_plain_forward_matches_the_spec_trace(seed, tlen, zdrop, junc):
    """Kernel 14's plain version on pairs over several tiles of 128
    positions, at ``w = max(qlen, tlen)``: its records are the spec's
    fields, its stop the rows the spec computed, and each row r of its
    compact store is the spec's row ``p[r, :en - st + 1]`` (the spec's
    band is the whole matrix) up to the stop (0 after it)."""
    rng = np.random.default_rng(seed)
    q, t = spliced_pair(rng, tlen)
    if zdrop == 20:
        q = np.concatenate([q[:120], rng.integers(0, 4, len(q) - 120)
                            .astype(np.uint8)])
    jt = _track(q, t, rng) if junc else None
    ez, trace = diagdiff.exts2(q, t, 5, MAT, *COSTS, zdrop=zdrop,
                               junc_bonus=9, flag=FOR, junc=jt,
                               keep_trace=True)
    launch, = ES.exts_prep([q], [t], [len(q)], [len(t)], 5, MAT, *COSTS,
                           zdrop, FOR, None if jt is None else [jt], 9,
                           cig=True)
    assert int(launch.lay.tbase[-1]) >= 3
    wr = max(len(q), len(t))
    assert int(launch.w[0]) == wr
    rec, p, stop = ES.exts_forward_plain(*band_upload(launch, "cpu"),
                                         launch.prm, launch.lay)
    assert rec[0].tolist() == [ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t,
                               ez.mte, ez.mte_q, ez.score, int(ez.zdropped)]
    nrow = int(stop[0])
    ndb = len(q) + len(t) - 1
    assert nrow < ndb if zdrop == 20 else nrow == ndb
    wid = F.row_widths(nrow, len(q), len(t), wr)
    want = np.concatenate([trace.p[r, :wid[r]] for r in range(nrow)])
    assert np.array_equal(p.numpy()[:wid.sum()], want)
    assert not p.numpy()[wid.sum():].any()


def test_convert_exts_params_from_jax():
    """``exts_params_from_jax`` carries the JAX tuple's values
    (long_thres / long_diff with e2 = 0) and drops the TPU layout fields;
    the port's host side builds the same tuple."""
    q = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 0, 1], np.uint8)
    t = np.array([0, 1, 2, 3, 1, 1, 2, 3, 0, 0, 1, 2, 2], np.uint8)
    jprm = wfs.ExtsParams(qlen=11, tlen=13, m=5, sc_mch=1, sc_mis=-2,
                          sc_N=-1, q=2, e=1, q2=32, long_thres=29,
                          long_diff=-1, zdrop=200, flag=int(FOR), chunk=512,
                          n_diag=23, n_rows=8, p_rows=0)
    prm = convert.exts_params_from_jax(jprm._asdict())
    assert prm == ES.exts_params(q, t, 5, MAT, 2, 1, 32, 200, int(FOR))
    assert prm._asdict() == {k: v for k, v in jprm._asdict().items()
                             if k not in ("chunk", "n_rows", "p_rows")}
