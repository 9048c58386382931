"""Kernel 3 (the rows forward, ``csrc/rows_fwd.cu``), modelled.

The kernel gives a pair one warp: lane l owns query columns 4l .. 4l+3,
and the lanes run as a pipeline a row apart, lane l computing row i = s -
l at step s, so a pair takes tlen + (qlen - 1) // 4 steps.  From lane l -
1 a lane gets, by one shuffle each a step, H at its left edge (the
diagonal neighbour of its next row) and F entering its first column in
the current row; lane 0 takes the virtual column.  H and E stay in the
lane's registers, F runs serially over its four columns, and a cell's
score comes from its column's table of bytes.  The packed (H, merge key)
maxima of the three diagonals a lane will meet again sit in registers
that shift down a column a step; a step's cells go in one step late, and
the diagonal they finish goes into the lane's own row of shared memory,
a slot a step; at the end diagonal r is the maximum of slot r + 1 - 3l
over the lanes l.  The
merge key is i + 1 + tv m from a = min(i, qlen - 1 - j) and b =
min(tlen - 1 - i, j): m = a & 3 where a & 3 >= max(4 - b, 4 - j, 0), else
4; the en0 cells get key 0 through the base the step gives them.  The
first 32 steps and those from tlen - 3 on (EDGE steps) keep a lane's
state outside its rows and test the rows' edges; hl is the state after
the last row.

The NumPy model below runs that schedule step by step on all 32 lanes at
once.  It asserts that every cell of a pair is computed once, at step i +
j // 4, that the hand-off values a lane uses are the left lane's H and F
of the rows it needs, that no two lanes of a step write one word of D or
one bank and that the final gather reads only slots written, that the
steps the kernel runs without the edge tests have
every row (and every late row) inside [0, tlen) and at least 4 from the
last, and it holds D, Dq and hl exactly to the plain twin
``ops.rows.rows_forward_plain`` on seeded pairs of 1-128 bp (queries under
4 bp, queries of 128, one-base targets, GENERIC_SC, Z-drop -1 and 100).
The key's closed form is held to ``common.cuh:merge_key`` for every cell
of every shape up to 24 x 24.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.matrix import encode_dna, simple_mat

from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.ops import rows as R
from ksw2_tpu_torch.ops import strips as S

torch.set_num_threads(1)

MAT = simple_mat(5, 2, -4)
GEN = np.array([[3, -5, -2, -6, -1],
                [-5, 2, -6, -3, -1],
                [-2, -6, 4, -5, -1],
                [-6, -3, -5, 2, -1],
                [-1, -1, -1, -1, -1]], np.int8).reshape(-1)
SENT = -(2 ** 31) + 1
INT_MIN = -(2 ** 31)
LANES = np.arange(32)


def merge_key(i, r, qlen, tlen, tv):
    """``common.cuh:merge_key``."""
    st0 = max(0, r - qlen + 1)
    en0 = min(tlen - 1, r)
    if i == en0:
        return 0
    en1 = st0 + ((en0 - st0) & -4)
    return ((i - st0) & 3) * tv + i + 1 if i < en1 else 4 * tv + i + 1


def kernel_kc(i, j, qlen, tlen, tv, kb):
    """kb - 1 - key as csrc/rows_fwd.cu works it out for cell (i, j): the
    step's bases c1 (and c0 for lane 0's column 0) and the column's
    tail threshold."""
    kbm1 = kb - 1
    u = tlen - 1 - i
    c1 = kbm1 - (i + 1) + (i + 1 + 4 * tv if u == 0 else 0)
    c = kbm1 + 4 * tv if j == 0 else c1
    a3 = min(i, qlen - 1 - j) & 3
    mk = a3 if a3 >= max(4 - u, 4 - min(j, 4)) else 4
    return c - tv * mk


def test_key_closed_form():
    """The kernel's key equals merge_key on every live cell of every
    shape up to 24 x 24 (the vector region, the tail, the en0 cells)."""
    kb, _ = S.key_params(128)
    for qlen in range(1, 25):
        for tlen in range(1, 25):
            for i in range(tlen):
                for j in range(qlen):
                    assert kb - 1 - kernel_kc(i, j, qlen, tlen, 128, kb) == \
                        merge_key(i, i + j, qlen, tlen, 128), (qlen, tlen,
                                                               i, j)


def col_h(i, gapoe, e):
    return -(gapoe + e * np.asarray(i, np.int64))


def model_pair(q, t, Lq, prm, table, stats):
    """One pair through the lane pipeline as csrc/rows_fwd.cu runs it:
    its D, Dq and hl rows (launch width ``Lq``, ``prm.tv``)."""
    qlen, tlen, tv, m = len(q), len(t), prm.tv, prm.m
    qq, e, mat0 = prm.q, prm.e, prm.mat0
    gapoe = qq + e
    kb, _ = S.key_params(tv)
    nd = Lq + tv
    table = np.asarray(table, np.int64)
    jb = 4 * LANES
    cols = jb[:, None] + np.arange(4)[None, :]                # (32, 4)
    tj = 4 - np.minimum(cols, 4)
    Q = np.where(cols < qlen, np.pad(q, (0, 128))[np.minimum(cols, 127)], 0)
    H = col_h(cols, gapoe, e)
    E = H - gapoe
    # the reference DP's H and F, filled as the cells are computed, to
    # check the hand-off values
    Href = np.full((tlen, 128), np.iinfo(np.int64).min, np.int64)
    Fref = np.full((tlen, 129), np.iinfo(np.int64).min, np.int64)
    D = np.full(nd, SENT, np.int64)
    Dq = np.full(nd, SENT, np.int64)
    Dq[qlen - 1:qlen - 1 + tlen] = 0
    hl = np.full(Lq, SENT, np.int64)
    count = np.zeros((tlen, 128), np.int64)
    cq = qlen - 1 - jb
    cqm = np.minimum(cq, 3)
    nsteps = tlen + (qlen - 1) // 4
    hprev = col_h(jb - 1, gapoe, e)
    fout = np.zeros(32, np.int64)
    acc = np.full((32, 3), INT_MIN, np.int64)    # diagonals +1, +2, +3
    ph = np.zeros((32, 4), np.int64)
    fill = min(32, nsteps)
    # each lane's row of finished diagonals (rows_fwd.cu's slot_pitch)
    P = (tv + Lq // 4 + 4) | 1
    part = np.full((32, P), 7, np.int64)           # 7: never written
    written = np.zeros((32, P), bool)

    def store(slot, vals):
        addr = LANES * P + slot
        assert len(set(addr % 32)) == 32          # 32 banks, one a lane
        part[:, slot] = vals
        written[:, slot] = True

    def pend(s, edge):
        # step s - 1's cells, a step late, as csrc/rows_fwd.cu's pend
        nonlocal acc
        pi = s - 1 - LANES
        rowok = (pi >= 0) & (pi < tlen)
        u = tlen - 1 - pi
        if not edge:
            # the kernel skips the edge tests: they must not matter
            assert rowok.all() and (u >= 4).all()
        lim = np.where(rowok, cqm, -1)
        c1 = kb - 1 - (pi + 1) + np.where(u == 0, pi + 1 + 4 * tv, 0)
        p = np.zeros((32, 4), np.int64)
        for k in range(4):
            c = np.where(LANES == 0, kb - 1 + 4 * tv, c1) if k == 0 else c1
            a3 = np.minimum(pi, cq - k) & 3
            mk = np.where(a3 >= np.maximum(4 - u, tj[:, k]), a3, 4)
            p[:, k] = np.where(k <= lim, ph[:, k] * kb + c - tv * mk,
                               INT_MIN)
            dq = rowok & (cq == k)
            Dq[(pi + qlen - 1)[dq]] = ph[dq, k]
        done = np.maximum(acc[:, 0], p[:, 0])
        acc = np.stack([np.maximum(acc[:, 1], p[:, 1]),
                        np.maximum(acc[:, 2], p[:, 2]), p[:, 3]], 1)
        store(s, done)                     # diagonal s - 1 + 3 lane

    for s in range(nsteps):
        i = s - LANES
        # the shuffles: the left lane's edge H and F as the last step
        # left them; lane 0 takes the virtual column
        hin = np.concatenate([H[:1, 3], H[:-1, 3]])
        fin = np.concatenate([fout[:1], fout[:-1]])
        hd = hprev.copy()
        hd[0] = 0 if i[0] == 0 else col_h(i[0] - 1, gapoe, e)
        fin[0] = col_h(i[0], gapoe, e) - gapoe
        hprev = hin
        edge = not fill <= s <= tlen - 4
        pend(s, edge)
        act = (i >= 0) & (i < tlen)
        if not edge:
            assert act.all()
        sym = np.where(act, np.pad(t, (0, 160))[np.clip(i, 0, 159)], 0)
        for ln in np.nonzero(act)[0]:
            # the hand-off values are the left lane's H(i - 1, jb - 1) and
            # F(i, jb) of the reference DP
            r_ = i[ln]
            if ln > 0:
                want_hd = Href[r_ - 1, jb[ln] - 1] if r_ > 0 else \
                    col_h(jb[ln] - 1, gapoe, e)
                assert hd[ln] == want_hd
                assert fin[ln] == Fref[r_, jb[ln]]
        F, Hd = fin.copy(), hd.copy()
        h = np.zeros((32, 4), np.int64)
        for k in range(4):
            sc = table[sym * m + Q[:, k]]
            hnof = np.maximum(Hd + sc, E[:, k])
            cv = Hd + mat0
            hc = np.minimum(hnof, cv)
            h[:, k] = np.minimum(np.maximum(hnof, F), cv)
            Fn = np.maximum(F - e, hc - gapoe)
            En = np.maximum(E[:, k] - e, h[:, k] - gapoe)
            Hd = np.where(act, H[:, k], Hd)
            for ln in np.nonzero(act)[0]:
                count[i[ln], cols[ln, k]] += 1
                Href[i[ln], cols[ln, k]] = h[ln, k]
                Fref[i[ln], cols[ln, k]] = F[ln]
                Fref[i[ln], cols[ln, k] + 1] = Fn[ln]
            # the fill and drain keep a lane's state outside its rows
            H[:, k] = np.where(act, h[:, k], H[:, k])
            E[:, k] = np.where(act, En, E[:, k])
            F = Fn
        fout = F
        ph = h
    pend(nsteps, True)
    for k in range(3):
        store(nsteps + 1 + k, acc[:, k])
    for r in range(nd):
        sl = r + 1 - 3 * LANES
        ok = (sl >= 0) & (sl < nsteps + 4)
        assert written[LANES[ok], sl[ok]].all()
        D[r] = max(SENT, part[LANES[ok], sl[ok]].max(initial=INT_MIN))
    for k in range(4):
        live = cols[:, k] < qlen
        hl[cols[live, k]] = H[live, k]
    assert (count[:, :qlen] == 1).all()
    stats["pairs"] += 1
    stats["steps"] += nsteps
    return D, Dq, hl


def _short(seed, n, lo=1, hi=129):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, q = refcmp.random_pair(
            rng, int(rng.integers(lo, hi)),
            divergence=float(rng.uniform(0, 0.4)),
            indel=float(rng.uniform(0, 0.25)), with_n=bool(rng.integers(2)))
        out.append((encode_dna(q[:128]), encode_dna(t)))
    return out


def _check(pairs, mat, flag, zdrop):
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = S.strips_prep([q for q, _ in pairs], [t for _, t in pairs], ql,
                          tl, 5, mat, 4, 2, zdrop, flag)
    assert R.rows_eligible(ql, tl, np.maximum(ql, tl), flag, zdrop, 5, mat)
    qs, ts, qlt, tlt, tab = S.upload(ln, "cpu")
    D, Dq, hl, _ = R.rows_forward_plain(qs, ts, qlt, tlt, tab, ln.prm)
    stats = {"pairs": 0, "steps": 0}
    Lq = qs.shape[1]
    for b, (q, t) in enumerate(pairs):
        mD, mDq, mhl = model_pair(q, t, Lq, ln.prm, S.score_table(ln.prm),
                                  stats)
        assert np.array_equal(mD, D[b].numpy()), b
        assert np.array_equal(mDq, Dq[b].numpy()), b
        assert np.array_equal(mhl, hl[b].numpy()), b
    return stats


@pytest.mark.parametrize("seed", [0, 1])
def test_model_on_seeded_short_pairs(seed):
    """Pairs of 1-128 bp (the rows route's whole envelope) at -z100."""
    stats = _check(_short(40 + seed, 12), MAT, Flag.SCORE_ONLY, 100)
    assert stats["pairs"] == 12


@pytest.mark.parametrize("flag,mat,zdrop", [
    (Flag.SCORE_ONLY, MAT, -1),
    (Flag.SCORE_ONLY | Flag.GENERIC_SC, GEN, 30)])
def test_model_at_the_edges(flag, mat, zdrop):
    """Queries under 4 bp (one lane, part of its columns), queries of 128
    (all 32 lanes), one-base targets (one row), a 128 x 128 pair, with
    Z-drop off and on a generic matrix."""
    rng = np.random.default_rng(9)
    shapes = [(1, 1), (1, 128), (2, 7), (3, 64), (4, 5), (5, 1), (128, 1),
              (128, 128), (127, 128), (128, 40), (33, 97)]
    pairs = [(rng.integers(0, 5, a).astype(np.uint8),
              rng.integers(0, 5, b).astype(np.uint8)) for a, b in shapes]
    stats = _check(pairs, mat, flag, zdrop)
    # the longest pair's steps: tlen + 31 for a 128-column query
    assert stats["steps"] == sum(b + (a - 1) // 4 for a, b in shapes)


def test_main_path_launch_prefix():
    """The first pairs of chip_smoke's short-pair workload (seed 778), the
    rows route's main-path launch."""
    import chip_smoke

    _check(chip_smoke.short_jobs()[:16], MAT, Flag.SCORE_ONLY, 100)
