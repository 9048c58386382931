"""The port's batched route against the JAX batched engines and the
spec: direction bytes and CIGARs.

The port's forward with bytes (``ops.band.band_forward`` with the
batched kernel as its CUDA forward; on the CPU, the plain version) is
held byte for byte against the JAX engines' direction planes
(``wavefront_batch`` / ``wavefront_batch_extd`` under the Pallas
interpreter, t-coordinate layout) inside every pair's rounded band, and
its CIGARs (the scheduler's ``batch_cigar_launch``: forward, start
cells, the band walker) against ``extz_batch_align`` /
``extd_batch_align`` and the spec, exactly.  One-piece EQX CIGARs
differ from the spec's extz2, which ignores ``KSW_EZ_EQX`` as the
reference does: the batched route converts them, as
``batch_pallas.py:773-782`` does, so the spec's CIGAR goes through
``to_eqx`` first.
"""
import numpy as np
import pytest
import torch

from ksw2_tpu.core import cigar as jcigar
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.ops import batch_pallas as jbatch
from ksw2_tpu.ops import wavefront_batch as wb
from ksw2_tpu.ops.bands import pad_rows, round_up

from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import batch as BT
from ksw2_tpu_torch.ops.bands import band_bounds_rounded, first_empty_diag

from test_torch_batch import (EXTD, GMAT, MAT, SWAPPED, bands, fields,
                              padded, pairs_of, spec_ez)

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)


def port_cigars(pairs, wv, zdrop, flag, costs=None, mat=MAT, end_bonus=0):
    """The port's batched CIGAR route on the CPU: ExtzResults."""
    q, e, q2, e2 = costs or (4, 2, 0, 0)
    _, _, ql, tl = padded(pairs)
    out = []
    for ln in BD.band_prep([a for a, _ in pairs], [b for _, b in pairs], ql,
                           tl, wv, 5, mat, q, e, zdrop, flag, cig=True,
                           two=costs is not None, q2=q2, e2=e2):
        rec, res, runs = sched.batch_cigar_launch(ln, end_bonus, "cpu")
        out += sched.unpack_batch_cigars(ln, rec.numpy(), res.numpy(),
                                         runs.numpy(), mat, end_bonus)
    return out


def jax_planes(pairs, wv, zdrop, flag, costs, mat, width):
    """The JAX engine's records and (n_diag, R, 128) direction planes."""
    Q, T, ql, tl = padded(pairs, width)
    B, Lq = Q.shape
    P = (width + 127) // 128
    if costs:
        prm = jbatch._extd_batch_params(B, Lq, ql, tl, 5, mat, *costs, zdrop,
                                        flag, 32, P)[0]
        run = jbatch._cached_run_extd(prm, True, True)
    else:
        nd = max(round_up(int((ql + tl).max()) - 1, 32), 32)
        prm = wb.BatchParams(
            n_rows=pad_rows(B, P) * P, n_diag=nd, m=5, sc_mch=int(mat[0]),
            sc_mis=int(mat[1]), sc_N=-2, q=4, e=2, zdrop=zdrop,
            flag=int(flag), chunk=32, p=P,
            matt=tuple(int(v) for v in mat) if flag & Flag.GENERIC_SC
            else ())
        run = jbatch._cached_run(prm, True, True)
    Bp = prm.n_rows // P
    pad = [np.zeros((Bp,) + a.shape[1:], a.dtype) for a in (Q, T, ql, tl,
                                                             wv)]
    for a, src in zip(pad, (Q, T, ql, tl, wv)):
        a[:B] = src
    res, p = run(*pad)
    return np.asarray(res)[:B], np.asarray(p).view(np.uint8), P


# (name, pairs_of args, bands, JAX target width, flag, costs, mat)
BYTE_CASES = [
    ("extz_clip_p2", (21, 5, 150, 250), (10, 60), 256, Flag.NONE, None, MAT),
    ("extz_right_w0_p1", (22, 5, 60, 120), [0, 3, 16, 1, 30], 128,
     Flag.RIGHT, None, MAT),
    ("extz_generic_p2", (23, 5, 150, 250), (10, 60), 256, Flag.GENERIC_SC,
     None, GMAT),
    ("extd_clip_p2", (24, 5, 150, 250), (10, 60), 256, Flag.NONE, EXTD, MAT),
    ("swapped_right_p1", (25, 5, 60, 120), (5, 40), 128, Flag.RIGHT, SWAPPED,
     MAT),
]


@pytest.mark.parametrize("case", BYTE_CASES, ids=[c[0] for c in BYTE_CASES])
def test_batch_bytes_match_jax_planes(case):
    """zdrop -1: every pair runs to its first empty-band diagonal, so each
    of its rows is compared over the whole rounded band [st, en]."""
    _, mk, wspec, width, flag, costs, mat = case
    pairs, rng = pairs_of(*mk)
    wv = bands(pairs, rng, wspec)
    q, e, q2, e2 = costs or (4, 2, 0, 0)
    (ln,) = BD.band_prep([a for a, _ in pairs], [b for _, b in pairs],
                         *padded(pairs)[2:], wv, 5, mat, q, e, -1, flag,
                         cig=True, two=costs is not None, q2=q2, e2=e2)
    rec, p = BD.band_forward(*BD.band_upload(ln, "cpu"), ln.prm, ln.nd,
                             ln.ncol, cuda=BT.batch_forward_cuda)
    p = p.numpy()
    jrec, jp, P = jax_planes(pairs, wv, -1, flag, costs, mat, width)
    assert np.array_equal(rec.numpy(), jrec)
    for b, (qs, ts) in enumerate(pairs):
        ql, tl, w = len(qs), len(ts), int(wv[b])
        stop = int(first_empty_diag(ql, tl, w))
        _, _, st, en = band_bounds_rounded(stop, ql, tl, w)
        for r in range(stop):
            t = np.arange(st[r], en[r] + 1)
            want = jp[r, b * P + t // 128, t % 128]
            assert np.array_equal(p[b, r, :t.size], want), (b, r)
            assert not p[b, r, t.size:].any()
        assert not p[b, stop:].any()


def _row(ez):
    return (*fields(ez), bool(ez.reach_end), list(ez.cigar))


# (name, pairs_of args, bands, JAX target width, zdrop, flag, costs, mat)
CIGAR_CASES = [
    ("extz_clip_z100", (31, 6, 100, 250), (10, 60), 256, 100, Flag.NONE,
     None, MAT),
    ("extz_w0_unbanded_zm1", (32, 6, 60, 120), [0, -1, 1, -1, 0, 16], 128,
     -1, Flag.NONE, None, MAT),
    ("extz_right_rev_z100", (33, 6, 100, 250, 0.2, 0.1), (10, 60), 256, 100,
     Flag.RIGHT | Flag.REV_CIGAR, None, MAT),
    ("extz_eqx_unbanded_z100", (34, 6, 100, 250), None, 256, 100, Flag.EQX,
     None, MAT),
    ("extz_approx_generic_z100", (35, 6, 100, 250), (10, 60), 256, 100,
     Flag.APPROX_MAX | Flag.APPROX_DROP | Flag.GENERIC_SC, None, GMAT),
    ("extd_clip_z100", (36, 6, 100, 250), (10, 60), 256, 100, Flag.NONE,
     EXTD, MAT),
    ("extd_eqx_right_p4_zm1", (37, 5, 150, 250), (5, 40), 512, -1,
     Flag.EQX | Flag.RIGHT, EXTD, MAT),
    ("swapped_rev_z100", (38, 6, 100, 250, 0.25, 0.1), (10, 60), 256, 100,
     Flag.REV_CIGAR, SWAPPED, MAT),
]


@pytest.mark.parametrize("case", CIGAR_CASES, ids=[c[0] for c in CIGAR_CASES])
def test_batch_cigars_match_jax_and_spec(case):
    _, mk, wspec, width, zdrop, flag, costs, mat = case
    pairs, rng = pairs_of(*mk)
    wv = bands(pairs, rng, wspec)
    wv = np.where(wv < 0, [max(len(q), len(t)) for q, t in pairs],
                  wv).astype(np.int32)
    got = port_cigars(pairs, wv, zdrop, flag, costs, mat)
    Q, T, ql, tl = padded(pairs, width)
    if costs:
        jx = jbatch.extd_batch_align(Q, T, ql, tl, 5, mat, *costs, wv,
                                     zdrop=zdrop, flag=flag, interpret=True)
    else:
        jx = jbatch.extz_batch_align(Q, T, ql, tl, 5, mat, 4, 2, wv,
                                     zdrop=zdrop, flag=flag, interpret=True)
    for i, (q, t) in enumerate(pairs):
        ez = spec_ez(q, t, int(wv[i]), zdrop, flag, costs, mat)
        if flag & Flag.EQX and not costs and ez.cigar:
            ez.cigar = jcigar.to_eqx(ez.cigar, q, t)
        assert _row(got[i]) == _row(ez), (i, int(wv[i]))
        assert _row(jx[i]) == _row(ez), (i, int(wv[i]))
