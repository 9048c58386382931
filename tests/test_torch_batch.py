"""The port's batched route against the JAX batched engines and the
spec: records.

The scheduler's ``batch_records`` on CPU tensors (the plain version,
``ops.band.band_forward_plain``) is held against
``ksw2_tpu.ops.batch_pallas.extz_batch_device`` / ``extd_batch_device``
run under the Pallas interpreter and against ``spec.diagdiff.extz2`` /
``extd2``, exactly.  The cases cover clipping bands, ``w = 0``, unbanded
pairs, target widths of 128, 256 and 512 (P = 1, 2, 4 rows a pair on the
TPU), zdrop -1 and 25, APPROX with and without DROP, GENERIC_SC and
two-piece costs that swap.  tests/test_torch_batch_cigar.py does the same
for CIGARs; the CUDA kernel's own test, which needs a card, is in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import batch_pallas as jbatch
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import batch as BT

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
GMAT = np.array([[3, -2, -4, -3, 0],
                 [-3, 2, -2, -4, 0],
                 [-4, -2, 4, -1, 0],
                 [-2, -3, -1, 2, 0],
                 [0, 0, 0, 0, 0]], np.int8).reshape(-1)
EXTD = (4, 2, 13, 1)
SWAPPED = (24, 1, 4, 2)
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP


def pairs_of(seed, n, lo, hi, div=0.15, ind=0.06, with_n=False):
    """``n`` seeded ``refcmp.random_pair`` draws with targets in
    [lo, hi); the rng continues for the bands."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(lo, hi)),
                                  divergence=div, indel=ind, with_n=with_n)
        out.append((encode_dna(q), encode_dna(t)))
    return out, rng


def padded(pairs, width=None):
    """(Q, T, qlen, tlen) with T padded to ``width`` columns (the JAX
    engines put P = ceil(width / 128) rows on a pair)."""
    B = len(pairs)
    tw = width or max(len(t) for _, t in pairs)
    Q = np.zeros((B, max(len(q) for q, _ in pairs)), np.int32)
    T = np.zeros((B, tw), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)], T[i, :len(t)] = q, t
    return (Q, T, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def port_records(pairs, wv, zdrop, flag, costs=None, mat=MAT):
    """The port's batched forward on the CPU: one (9,) tuple a pair."""
    q, e, q2, e2 = costs or (4, 2, 0, 0)
    _, _, ql, tl = padded(pairs)
    out = []
    for ln in BD.band_prep([a for a, _ in pairs], [b for _, b in pairs], ql,
                           tl, wv, 5, mat, q, e, zdrop, flag,
                           two=costs is not None, q2=q2, e2=e2):
        out += [tuple(int(v) for v in r)
                for r in sched.batch_records(ln, "cpu").numpy()]
    return out


def spec_ez(q, t, w, zdrop, flag, costs=None, mat=MAT, end_bonus=0):
    if costs:
        return diagdiff.extd2(q, t, 5, mat, *costs, w=w, zdrop=zdrop,
                              end_bonus=end_bonus, flag=flag)[0]
    return diagdiff.extz2(q, t, 5, mat, 4, 2, w=w, zdrop=zdrop,
                          end_bonus=end_bonus, flag=flag)[0]


def fields(ez):
    return tuple(int(getattr(ez, k)) for k in FIELDS)


# (name, pairs_of args, bands (None: unbanded), JAX target width, zdrop,
# flag, costs, mat)
CASES = [
    ("clip_w0_1_16_p1", (1, 6, 60, 120), [0, 1, 16, 0, 1, 16], 128, 25,
     Flag.SCORE_ONLY, None, MAT),
    ("clip_p2_zm1", (2, 6, 150, 250), (10, 60), 256, -1, Flag.SCORE_ONLY,
     None, MAT),
    ("clip_p4_z25_with_n", (3, 5, 150, 250, 0.2, 0.1, True), (5, 40), 512,
     25, Flag.SCORE_ONLY, None, MAT),
    ("unbanded_approx", (4, 6, 100, 250), None, 256, -1,
     Flag.SCORE_ONLY | Flag.APPROX_MAX, None, MAT),
    ("clip_approx_drop_z25", (5, 6, 100, 250, 0.25, 0.1), (20, 80), 256, 25,
     Flag.SCORE_ONLY | APPROX, None, MAT),
    ("approx_drop_zm1", (6, 5, 100, 250), (20, 80), 256, -1,
     Flag.SCORE_ONLY | APPROX, None, MAT),
    ("generic_clip_z25", (7, 6, 100, 250), (10, 60), 256, 25,
     Flag.SCORE_ONLY | Flag.GENERIC_SC, None, GMAT),
    ("extd_clip_w0_16_z25", (8, 6, 60, 120), [0, 16, 3, 0, 40, 7], 128, 25,
     Flag.SCORE_ONLY, EXTD, MAT),
    ("extd_clip_p2_zm1", (9, 6, 150, 250), (10, 60), 256, -1,
     Flag.SCORE_ONLY, EXTD, MAT),
    ("extd_unbanded_p4_z25", (10, 5, 150, 250, 0.25, 0.1), None, 512, 25,
     Flag.SCORE_ONLY, EXTD, MAT),
    ("extd_approx_drop_z25", (11, 6, 100, 250, 0.25, 0.1), (20, 80), 256,
     25, Flag.SCORE_ONLY | APPROX, EXTD, MAT),
    ("extd_generic_zm1", (12, 6, 100, 250), (10, 60), 256, -1,
     Flag.SCORE_ONLY | Flag.GENERIC_SC, EXTD, GMAT),
    ("swapped_clip_z25", (13, 6, 100, 250), (10, 60), 256, 25,
     Flag.SCORE_ONLY, SWAPPED, MAT),
    ("swapped_approx_zm1", (14, 6, 100, 250), (10, 60), 256, -1,
     Flag.SCORE_ONLY | Flag.APPROX_MAX, SWAPPED, MAT),
]


def bands(pairs, rng, spec):
    if spec is None:
        return np.array([max(len(q), len(t)) for q, t in pairs], np.int32)
    if isinstance(spec, list):
        return np.array(spec, np.int32)
    return rng.integers(spec[0], spec[1], len(pairs)).astype(np.int32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_batch_records_match_jax_and_spec(case):
    _, mk, wspec, width, zdrop, flag, costs, mat = case
    pairs, rng = pairs_of(*mk)
    wv = bands(pairs, rng, wspec)
    got = port_records(pairs, wv, zdrop, flag, costs, mat)
    Q, T, ql, tl = padded(pairs, width)
    if costs:
        jx = jbatch.extd_batch_device(Q, T, ql, tl, 5, mat, *costs, wv,
                                      zdrop=zdrop, flag=flag, interpret=True)
    else:
        jx = jbatch.extz_batch_device(Q, T, ql, tl, 5, mat, 4, 2, wv,
                                      zdrop=zdrop, flag=flag, interpret=True)
    for i, (q, t) in enumerate(pairs):
        want = fields(spec_ez(q, t, int(wv[i]), zdrop, flag, costs, mat))
        assert got[i] == want, (i, int(wv[i]))
        assert tuple(int(jx[k][i]) for k in FIELDS) == want, (i, int(wv[i]))


def test_batch_envelope_is_the_jax_routes():
    """Scores: Lt <= 3072 and the packed Z-drop range; CIGARs: Lt <= 1536
    and no EXTZ_ONLY.  Each refusal names the engine the JAX package
    takes next (scheduler.py:278-285, 514-521, 755-767)."""
    ql, tl = [300], [400]
    S = Flag.SCORE_ONLY
    assert BT.batch_ineligible_reason(3072, ql, tl, MAT, S, 100,
                                      cigar=False) is None
    assert BT.batch_ineligible_reason(1536, ql, tl, MAT, Flag.NONE, 100,
                                      cigar=True) is None
    assert "the any-device route" in BT.batch_ineligible_reason(
        4096, ql, tl, MAT, S, 100, cigar=False)
    assert "the single-pair two-piece engine" in BT.batch_ineligible_reason(
        4096, ql, tl, MAT, S, 100, cigar=False, two=True)
    assert "the single-pair engine" in BT.batch_ineligible_reason(
        2048, ql, tl, MAT, Flag.NONE, 100, cigar=True)
    assert "the single-pair two-piece engine" in BT.batch_ineligible_reason(
        2048, ql, tl, MAT, Flag.NONE, 100, cigar=True, two=True)
    assert "EXTZ_ONLY" in BT.batch_ineligible_reason(
        512, ql, tl, MAT, Flag.EXTZ_ONLY, 100, cigar=True)
    big = simple_mat(5, 100, 4)
    for z, f, ok in ((100, S, False), (-1, S, True),
                     (100, S | Flag.APPROX_MAX, True)):
        reason = BT.batch_ineligible_reason(3072, [3000], [3000], big, f, z,
                                            cigar=False)
        assert (reason is None) == ok, (z, f)
    assert BT.zdrop_ok(3072, big, [3000], [3000], 100, S) is False


def test_batch_forward_refuses_what_the_kernel_does_not_take():
    pairs, _ = pairs_of(15, 2, 50, 90)
    (ln,) = BD.band_prep([a for a, _ in pairs], [b for _, b in pairs],
                         *padded(pairs)[2:], [0, 20], 5, MAT, 4, 2, -1,
                         Flag.SCORE_ONLY)
    args = BD.band_upload(ln, "cpu")
    with pytest.raises(ValueError, match="device"):
        BD.band_forward(*(t.to("meta") for t in args), ln.prm, ln.nd,
                        ln.ncol, cuda=BT.batch_forward_cuda)
    with pytest.raises(ValueError, match="CUDA"):
        BT.batch_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
    rec, p = BD.band_forward(*args, ln.prm, ln.nd, ln.ncol,
                             cuda=BT.batch_forward_cuda)
    assert rec.dtype == torch.int32 and rec.shape == (2, 9) and p is None
    assert BT.strip_len(3072) == 3104 and BT.strip_len(100) == 128
    # a warp's strip: int32 H and 4 (6) int8 planes, s and the target
    assert BT.warp_smem_bytes(512, ln.prm) == 544 * 10
