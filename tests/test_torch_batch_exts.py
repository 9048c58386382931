"""The port's batched exts route against the JAX batched exts engine and
the spec: records, direction bytes and CIGARs.

The port's launches (``ops.batch_exts``, the plain forward
``batch_exts_forward_plain`` on CPU tensors, and ``band_walker``'s walk
with ``min_intron = long_thres``) are held against
``ksw2_tpu.ops.batch_pallas.exts_batch_records`` / ``exts_batch_align``
and the direction planes of ``_cached_run_exts`` under the Pallas
interpreter, and against ``spec.diagdiff.exts2``, exactly.  The cases
cover zdrop -1/30/200, RIGHT, APPROX with and without DROP, GENERIC_SC,
SPLICE_REV with SPLICE_FLANK, REV_CIGAR, junction tracks with and without
``junc_bonus``, EQX (no M -> =/X pass), and the ``q2 <= q + e`` reset.
Pairs are small (B <= 8, targets < 256: P = 2 rows a pair on the TPU).
The CUDA kernel's own test, which needs a card, is in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from chip_smoke import spliced_pair
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.ops import batch_pallas as jbatch
from ksw2_tpu.ops import wavefront_batch_exts as wbs
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import batch_exts as BE
from ksw2_tpu_torch.ops.bands import band_bounds_rounded

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 1, 2)
GMAT = np.array([[2, -2, -1, -2, 0],
                 [-2, 1, -2, -1, 0],
                 [-1, -2, 2, -2, 0],
                 [-2, -1, -2, 1, 0],
                 [0, 0, 0, 0, 0]], np.int8).reshape(-1)
COSTS = (2, 1, 32, 9)           # -x splice: -O2,32 -E1,0, noncan 9
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")
WIDTH = 256                     # the JAX engine's target width (P = 2)


def splice_batch(seed, n=6, lo=40, hi=250):
    """``n`` seeded spliced pairs with targets in [lo, hi) (N bases, one
    clipped query) and their junction tracks: a donor and an acceptor
    bit of both strands near the pair's intron and one stray bit."""
    rng = np.random.default_rng(seed)
    pairs = [spliced_pair(rng, int(rng.integers(lo, hi)), with_n=True)
             for _ in range(n)]
    pairs[1] = (pairs[1][0][:30], pairs[1][1])
    juncs = []
    for _, t in pairs:
        j = np.zeros(len(t), np.uint8)
        j[rng.integers(0, len(t), 3)] = rng.integers(1, 16, 3)
        juncs.append(j)
    juncs[2] = None
    return pairs, juncs


def padded(pairs, juncs=None):
    """(Q, T, qlen, tlen, junc) with T and the tracks padded to WIDTH."""
    B = len(pairs)
    Q = np.zeros((B, max(len(q) for q, _ in pairs)), np.int32)
    T = np.zeros((B, WIDTH), np.int32)
    J = None if juncs is None else np.zeros((B, WIDTH), np.uint8)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)], T[i, :len(t)] = q, t
        if J is not None and juncs[i] is not None:
            J[i, :len(t)] = juncs[i]
    return (Q, T, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32), J)


def port_launch(pairs, juncs, zdrop, flag, junc_bonus, mat=MAT, cig=True):
    q, e, q2, noncan = COSTS
    (ln,) = BE.batch_exts_prep([a for a, _ in pairs], [b for _, b in pairs],
                               [len(a) for a, _ in pairs],
                               [len(b) for _, b in pairs], 5, mat, q, e, q2,
                               noncan, zdrop, flag, juncs, junc_bonus,
                               cig=cig)
    return ln


def port_cigars(pairs, juncs, zdrop, flag, junc_bonus, mat=MAT):
    ln = port_launch(pairs, juncs, zdrop, flag, junc_bonus, mat)
    rec, res, runs = BE.batch_exts_cigar_launch(ln, 0, "cpu")
    return BE.unpack_exts_cigars(ln, rec.numpy(), res.numpy(), runs.numpy(),
                                 mat)


def spec_ez(q, t, j, zdrop, flag, junc_bonus, mat=MAT):
    return diagdiff.exts2(q, t, 5, mat, *COSTS, zdrop=zdrop,
                          junc_bonus=junc_bonus, flag=flag, junc=j)[0]


def fields(ez):
    return tuple(int(getattr(ez, k)) for k in FIELDS)


SPL = Flag.SPLICE_FOR
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
# (name, seed, zdrop, flag, junc_bonus, tracks, mat)
CASES = [
    ("z200", 1, 200, SPL, 0, False, MAT),
    ("zm1_flank", 2, -1, SPL | Flag.SPLICE_FLANK, 0, False, MAT),
    ("right_z30", 3, 30, SPL | Flag.RIGHT, 0, False, MAT),
    ("approx_zm1", 4, -1, SPL | Flag.APPROX_MAX, 0, False, MAT),
    ("approx_drop_z30", 5, 30, SPL | APPROX, 0, False, MAT),
    ("approx_drop_zm1", 6, -1, SPL | APPROX, 0, False, MAT),
    ("generic_z200", 7, 200, SPL | Flag.GENERIC_SC, 0, False, GMAT),
    ("juncs_bonus9", 8, 200, SPL, 9, True, MAT),
    ("juncs_no_bonus", 9, 200, SPL, 0, True, MAT),
    ("bonus_no_juncs", 10, 200, SPL, 9, False, MAT),
    ("rev_flank_juncs", 11, 200,
     Flag.SPLICE_REV | Flag.SPLICE_FLANK, 5, True, MAT),
    ("revcigar_juncs", 12, -1, SPL | Flag.REV_CIGAR, 9, True, MAT),
]


# the cases also held against the JAX engine under the Pallas interpreter
# (each compiles its own kernel: the rest are held against the spec only)
JAX_CASES = ("zm1_flank", "approx_drop_z30", "juncs_bonus9",
             "rev_flank_juncs")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_exts_records_match_jax_and_spec(case):
    _, seed, zdrop, flag, jbon, tracks, mat = case
    pairs, juncs = splice_batch(seed)
    juncs = juncs if tracks else None
    flag = flag | Flag.SCORE_ONLY
    ln = port_launch(pairs, juncs, zdrop, flag, jbon, mat, cig=False)
    got = [tuple(int(v) for v in r)
           for r in BE.batch_exts_records(ln, "cpu").numpy()]
    if case[0] in JAX_CASES:
        Q, T, ql, tl, J = padded(pairs, juncs)
        (sl,) = jbatch.exts_batch_records(Q, T, ql, tl, 5, mat, *COSTS,
                                          zdrop, jbon, flag, J,
                                          interpret=True)
        assert got == [tuple(int(v) for v in r)
                       for r in np.asarray(sl["res"])]
    for k, (q, t) in enumerate(pairs):
        want = spec_ez(q, t, None if juncs is None else juncs[k], zdrop,
                       flag, jbon, mat)
        assert got[k] == fields(want), k


BYTE_CASES = [c for c in CASES if c[0] in
              ("zm1_flank", "right_z30", "generic_z200", "rev_flank_juncs")]


def jax_planes(pairs, juncs, flag, jbon, mat):
    """The JAX engine's records and (n_diag, R, 128) direction planes at
    zdrop -1, and P."""
    Q, T, ql, tl, J = padded(pairs, juncs)
    B, P = len(pairs), WIDTH // 128
    R = jbatch.pad_rows(B, P) * P
    matf, lt, ld, sc_N, donb, accb = jbatch._exts_batch_prep(
        B, T, tl, 5, mat, COSTS[0], COSTS[1], COSTS[2], COSTS[3], flag, J,
        jbon, R, P)
    nd = max(jbatch.round_up(int((ql + tl).max()) - 1, 32), 32)
    prm = wbs.BatchExtsParams(
        n_rows=R, n_diag=nd, m=5, sc_mch=int(matf[0]), sc_mis=int(matf[1]),
        sc_N=sc_N, q=COSTS[0], e=COSTS[1], q2=COSTS[2], long_thres=lt,
        long_diff=ld, zdrop=-1, flag=int(flag), chunk=32, p=P,
        matt=tuple(int(v) for v in matf) if flag & Flag.GENERIC_SC else ())
    Bp = R // P
    pad = [np.zeros((Bp,) + a.shape[1:], a.dtype) for a in (Q, T, ql, tl)]
    for a, src in zip(pad, (Q, T, ql, tl)):
        a[:B] = src
    jrec, jp = jbatch._cached_run_exts(prm, True, True)(
        pad[0], pad[1], donb, accb, pad[2], pad[3])
    return np.asarray(jrec)[:B], np.asarray(jp).view(np.uint8), P


@pytest.mark.parametrize("case", BYTE_CASES, ids=[c[0] for c in BYTE_CASES])
def test_exts_bytes_match_jax_planes_and_spec(case):
    """zdrop -1: every pair runs to its last diagonal.  Each stored row
    equals the spec's (``exts2(keep_trace=True)``, the reference's bytes)
    over the whole rounded [st, en], and the JAX planes over the cells of
    the matrix, [st0, en0]: the JAX kernel leaves stale boundary bytes in
    [st, st0) (ROADMAP Queue 3), which no walk reads."""
    _, seed, _, flag, jbon, tracks, mat = case
    pairs, juncs = splice_batch(seed)
    juncs = juncs if tracks else None
    ln = port_launch(pairs, juncs, -1, flag, jbon, mat)
    rec, p = BE.batch_exts_forward_plain(*BD.band_upload(ln, "cpu"), ln.prm,
                                         ln.nd, ln.ncol)
    p = p.numpy()
    jp = None
    if case[0] in JAX_CASES:
        jrec, jp, P = jax_planes(pairs, juncs, flag, jbon, mat)
        assert np.array_equal(rec.numpy(), jrec)
    for b, (qs_, ts_) in enumerate(pairs):
        n, m_ = len(qs_), len(ts_)
        stop = n + m_ - 1
        _, tr = diagdiff.exts2(qs_, ts_, 5, mat, *COSTS, zdrop=-1,
                               junc_bonus=jbon, flag=flag,
                               junc=None if juncs is None else juncs[b],
                               keep_trace=True)
        st0, en0, st, en = band_bounds_rounded(stop, n, m_, n + m_)
        for r in range(stop):
            assert (tr.off[r], tr.off_end[r]) == (st[r], en[r])
            k = en[r] - st[r] + 1
            assert np.array_equal(p[b, r, :k], tr.p[r, :k]), (b, r)
            assert not p[b, r, k:].any()
            if jp is not None:
                t = np.arange(st0[r], en0[r] + 1)
                want = jp[r, b * P + t // 128, t % 128]
                assert np.array_equal(p[b, r, t - st[r]], want), (b, r)
        assert not p[b, stop:].any()


def test_jax_exts_planes_keep_stale_bytes_outside_the_matrix():
    """ROADMAP Queue 3 pin: where the rounded start st stays above 0
    from one diagonal to the next, the reference (ksw2_exts2_sse.c:
    191-196) and the spec enter lane st with the init bytes; the JAX
    batched exts kernel shifts in the previous diagonal's stale t = st -
    1 instead.  Only cells of [st, st0), outside the matrix, differ; the
    port follows the reference there."""
    case = [c for c in CASES if c[0] == "zm1_flank"][0]
    _, seed, _, flag, jbon, _, mat = case
    pairs, _ = splice_batch(seed)
    _, jp, P = jax_planes(pairs, None, flag, jbon, mat)
    q, t = pairs[0]
    _, tr = diagdiff.exts2(q, t, 5, mat, *COSTS, zdrop=-1, flag=flag,
                           keep_trace=True)
    n, m_ = len(q), len(t)
    st0, en0, st, en = band_bounds_rounded(n + m_ - 1, n, m_, n + m_)
    outside = inside = 0
    for r in range(n + m_ - 1):
        tt = np.arange(st[r], en[r] + 1)
        diff = jp[r, tt // 128, tt % 128] != tr.p[r, :tt.size]
        inside += int(diff[(tt >= st0[r]) & (tt <= en0[r])].sum())
        outside += int(diff.sum())
    assert inside == 0
    assert outside > 0


CIGAR_CASES = [c for c in CASES if not c[3] & Flag.APPROX_MAX
               or c[0] == "approx_drop_z30"]


@pytest.mark.parametrize("case", CIGAR_CASES,
                         ids=[c[0] for c in CIGAR_CASES])
def test_exts_cigars_match_jax_and_spec(case):
    """CIGARs with N ops (min_intron = long_thres) against ``exts2`` and,
    for JAX_CASES, ``exts_batch_align`` under the interpreter."""
    _, seed, zdrop, flag, jbon, tracks, mat = case
    pairs, juncs = splice_batch(seed)
    juncs = juncs if tracks else None
    got = port_cigars(pairs, juncs, zdrop, flag, jbon, mat)
    rows = [fields(ez) + (list(ez.cigar),) for ez in got]
    if case[0] in JAX_CASES:
        Q, T, ql, tl, J = padded(pairs, juncs)
        jax = jbatch.exts_batch_align(Q, T, ql, tl, 5, mat, *COSTS, zdrop,
                                      jbon, flag, J, interpret=True)
        assert rows == [fields(ez) + (list(ez.cigar),) for ez in jax]
    for k, (q, t) in enumerate(pairs):
        want = spec_ez(q, t, None if juncs is None else juncs[k], zdrop,
                       flag, jbon, mat)
        assert rows[k] == fields(want) + (list(want.cigar),), k


def test_exts_route_keeps_m_ops_under_eqx():
    """EQX splice CIGARs keep their M ops: exts2 has no =/X pass."""
    pairs, juncs = splice_batch(13)
    flag = SPL | Flag.EQX
    got = sched.align_batch_splice(
        [sched.AlignJob(q, t) for q, t in pairs], 5, MAT, *COSTS,
        zdrop=200, junc_bonus=9, flag=flag, juncs=juncs, device="cpu")
    assert any(c & 0xF == 0 for ez in got for c in ez.cigar)
    for k, (q, t) in enumerate(pairs):
        want = spec_ez(q, t, juncs[k], 200, flag, 9)
        assert fields(got[k]) + (list(got[k].cigar),) == \
            fields(want) + (list(want.cigar),), k


@pytest.mark.parametrize("flag", [SPL, SPL | Flag.SCORE_ONLY])
def test_exts_route_resets_when_q2_does_not_exceed_q_plus_e(flag):
    """``q2 <= q + e``: the batched route resets every pair, as exts2
    and the JAX engine do (the strips route runs them, ROADMAP Queue 3)."""
    pairs, juncs = splice_batch(14, n=4)
    q, e, _, noncan = COSTS
    got = sched.align_batch_splice(
        [sched.AlignJob(a, b) for a, b in pairs], 5, MAT, q, e, q + e,
        noncan, zdrop=200, flag=flag, juncs=juncs, device="cpu")
    Q, T, ql, tl, J = padded(pairs, juncs)
    jax = jbatch.exts_batch_align(Q, T, ql, tl, 5, MAT, q, e, q + e, noncan,
                                  200, 0, flag, J, interpret=True)
    for k, (a, b) in enumerate(pairs):
        want = diagdiff.exts2(a, b, 5, MAT, q, e, q + e, noncan, zdrop=200,
                              flag=flag, junc=juncs[k])[0]
        assert fields(got[k]) == fields(jax[k]) == fields(want), k
        assert list(got[k].cigar) == list(want.cigar) == []
