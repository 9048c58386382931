"""Kernel 18's row sweep, modelled.

``csrc/batch_local.cu`` runs a pair on one warp, lane l holding target
positions 4l .. 4l + 3, and sweeps the query rows: F down the column,
the partial H' = max(0, H(i-1, t-1) + s, F), then E along the row as a
prefix max-plus scan over H' (each lane's 4 cells with no carry in, a
5-round scan of the lanes' carries with the decay of 4 positions a lane,
each cell's fix-up by its distance), H = max(H', E) and each position's
first strict best (BH, BI).  The NumPy model below runs every pair of a
launch at once in that layout, the scan as the lanes' shuffles do it,
and holds (score, te, qe) exactly to the plain twin
``ops.batch_local.local_forward_plain`` and to the JAX package's
``local_batch_device`` in interpret mode, as ``tests/test_local.py``
runs it: gap costs q in {-2, 0, 4, 11} and e in {0, 1, 2} (both signs of
the scan's row decay), ties, queries over 128, targets under 128, empty
pairs, pairs with nothing above 0, a matrix that is not simple, the JAX
bench's anchor and local-mixed's pin.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import refcmp
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import batch_local as jbl

from ksw2_tpu_torch.ops import batch_local as BL

torch.set_num_threads(1)
MAT = simple_mat(5, 2, 4)
LANES, CELLS = 32, 4
NEG = -(10 ** 9)
FIELDS = ("score", "te", "qe")


def shfl_up(x, o):
    """``__shfl_up_sync(x, o)`` over the lane axis (1): lanes below ``o``
    keep their own value."""
    y = x.copy()
    y[:, o:] = x[:, :-o]
    return y


def model_launch(Q, T, ql, tl, prm, stats=None):
    """Every pair of a launch through the row sweep as the kernel runs it:
    (B, 3) int64 (score, te, qe).  ``stats`` counts the cells where E won
    and where the carry into a lane (not its own cells) set E."""
    stats = {} if stats is None else stats
    B = len(ql)
    P = LANES * CELLS
    ql = np.asarray(ql, np.int64)
    tl = np.asarray(tl, np.int64)
    pos = np.arange(P).reshape(LANES, CELLS)
    live = pos[None] < tl[:, None, None]              # t < tlen
    Tr = np.zeros((B, P), np.int64)
    Tr[:, :T.shape[1]] = T
    Tr = np.where(live.reshape(B, P), Tr, 0).reshape(B, LANES, CELLS)
    tN = Tr == prm.m - 1
    Tk = np.where(tN, -1, Tr)
    MS = np.where(tN, prm.sc_N, prm.sc_mis)
    a = -(prm.q + prm.e)
    c = max(-prm.q, 0) - prm.e
    dec = [(CELLS << j) * c for j in range(5)]
    lane = np.arange(LANES)[None, :]
    Hp = np.zeros((B, LANES, CELLS), np.int64)
    F = np.full((B, LANES, CELLS), NEG, np.int64)
    BH = np.zeros((B, LANES, CELLS), np.int64)
    BI = np.full((B, LANES, CELLS), -1, np.int64)
    for i in range(int(ql.max(initial=0))):
        act = (i < ql)[:, None, None]
        Qi = np.where(i < ql, Q[:, min(i, Q.shape[1] - 1)], 0)[:, None, None]
        dl = shfl_up(Hp[:, :, CELLS - 1], 1)     # H(i-1, t0 - 1)
        dl[:, 0] = 0
        S = np.where(Tk == Qi, prm.sc_mch, MS)
        S = np.where(Qi == prm.m - 1, prm.sc_N, S)
        dg = np.concatenate([dl[:, :, None], Hp[:, :, :CELLS - 1]], 2)
        Fn = np.maximum(Hp + a, F - prm.e)
        Hq = np.maximum(np.maximum(dg + S, Fn), 0)
        eL = np.zeros_like(Hq)
        eL[:, :, 1] = Hq[:, :, 0] + a
        for k in range(2, CELLS):
            eL[:, :, k] = np.maximum(Hq[:, :, k - 1] + a, eL[:, :, k - 1] + c)
        X = np.maximum(Hq[:, :, CELLS - 1] + a, eL[:, :, CELLS - 1] + c)
        X[:, 0] = np.maximum(X[:, 0], a + dec[0])
        for j in range(5):
            y = shfl_up(X, 1 << j)
            X = np.where(lane >= (1 << j), np.maximum(y + dec[j], X), X)
        Ein = shfl_up(X, 1)
        Ein[:, 0] = a
        k = np.arange(CELLS)[None, None, :]
        carried = Ein[:, :, None] + k * c
        E = np.where(k == 0, carried, np.maximum(carried, eL))
        H = np.maximum(Hq, E)
        # the scan is the row's serial recurrence
        ser = np.empty_like(E)
        Hs = H.reshape(B, P)
        prev_e, prev_h = np.full(B, NEG, np.int64), np.zeros(B, np.int64)
        for t in range(P):
            ser.reshape(B, P)[:, t] = np.maximum(prev_h - prm.q, prev_e) - \
                prm.e
            prev_e, prev_h = ser.reshape(B, P)[:, t], Hs[:, t]
        assert np.array_equal(np.where(act, ser, 0), np.where(act, E, 0))
        won = act & live & (E > Hq)
        stats["e_won"] = stats.get("e_won", 0) + int(won.sum())
        stats["carry_won"] = stats.get("carry_won", 0) + int(
            (won & ((k == 0) | (carried > eL))).sum())
        better = act & (H > BH)
        BH = np.where(better, H, BH)
        BI = np.where(better, i, BI)
        Hp = np.where(act, H, Hp)
        F = np.where(act, Fn, F)
    assert np.abs(BH).max(initial=0) < 2 ** 31
    BH, BI = BH.reshape(B, P), BI.reshape(B, P)
    out = np.zeros((B, 3), np.int64)
    for b in range(B):
        h = np.where(live.reshape(B, P)[b], BH[b], 0)
        V = int(h.max())
        if V > 0:
            te = int(np.flatnonzero(h == V)[0])
            out[b] = (V, te, BI[b, te])
        else:
            out[b] = (0, -1, -1)
    return out


def _pad(pairs, Lt=128):
    Lq = max([len(q) for q, _ in pairs] + [1])
    Q = np.zeros((len(pairs), Lq), np.int32)
    T = np.zeros((len(pairs), Lt), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    return (Q, T, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def _draws(seed, B, flank=0, tmax=128):
    """``tests/test_local.py``'s draws (targets of 8 .. ``tmax`` - 1 bp);
    ``flank`` > 0 sets each query in random flanks up to ``flank`` bp."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        t, q = refcmp.random_pair(
            rng, int(rng.integers(8, tmax)),
            divergence=float(rng.uniform(0, 0.5)),
            indel=float(rng.uniform(0, 0.25)),
            with_n=bool(rng.integers(0, 2)))
        q = encode_dna(q)
        if flank:
            pad = rng.integers(0, 4, max(0, int(rng.integers(129, flank + 1))
                                         - len(q)))
            at = int(rng.integers(0, len(pad) + 1))
            q = np.concatenate([pad[:at], q, pad[at:]])
        pairs.append((q, encode_dna(t)))
    return _pad(pairs)


def _plain(arrays, prm):
    args = [torch.from_numpy(np.ascontiguousarray(a, dt)) for a, dt in
            zip(arrays, (np.uint8, np.uint8, np.int32, np.int32))]
    return BL.local_forward_plain(*args, prm).numpy()


def _check(arrays, mat=MAT, q=4, e=2, jax=True, stats=None):
    """The model against the plain twin and, with ``jax``, the JAX
    function in interpret mode, exactly; returns the model's result."""
    prm = BL.local_params(5, mat, q, e)
    got = model_launch(*arrays, prm, stats)
    assert np.array_equal(got, _plain(arrays, prm))
    if jax:
        j = jbl.local_batch_device(*arrays, 5, mat, q, e, interpret=True)
        assert np.array_equal(got, np.stack([j[k] for k in FIELDS], 1))
    return got


@pytest.mark.parametrize("e", [0, 1, 2])
@pytest.mark.parametrize("q", [-2, 0, 4, 11])
def test_model_costs(q, e):
    """Both signs of the scan's decay c = max(-q, 0) - e (q = -2, e = 0
    grows E along a row) on seeded pairs with N bases and indels, a
    query over 128 and a target under 128 among them."""
    arrays = _draws(100 + 7 * q + e, 6, flank=200 if q == 4 else 0)
    stats = {}
    _check(arrays, q=q, e=e, stats=stats)
    assert stats["e_won"] > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_model_queries_over_128(seed):
    arrays = _draws(seed, 6, flank=400)
    assert arrays[2].min() > 128
    _check(arrays)


@pytest.mark.parametrize("tmax", [9, 40, 100])
def test_model_short_targets(tmax):
    """Targets under 128 (whole lanes and a lane split by tlen past the
    target; the scan runs over lanes with no target positions)."""
    arrays = _draws(20 + tmax, 8, tmax=tmax)
    assert arrays[3].max() < tmax
    _check(arrays)


@pytest.mark.parametrize("ql,tl", [(0, 50), (50, 0), (0, 0), (1, 1)])
def test_model_empty_pairs(ql, tl):
    rng = np.random.default_rng(ql + 2 * tl)
    arrays = _pad([(rng.integers(0, 4, ql), rng.integers(0, 4, tl)),
                   (rng.integers(0, 4, 30), rng.integers(0, 4, 30))])
    out = _check(arrays)
    if ql == 0 or tl == 0:
        assert tuple(out[0]) == (0, -1, -1)


@pytest.mark.parametrize("q,t", [(np.full(90, 4), np.arange(128) % 4),
                                 (np.zeros(70, np.int64), np.full(128, 2))],
                         ids=["all_n", "all_mismatch"])
def test_model_nothing_above_zero(q, t):
    assert [tuple(r) for r in _check(_pad([(q, t)]))] == [(0, -1, -1)]


def test_model_ties():
    """As ``test_torch_local.py::test_tied_maxima_take_the_row_major_first``:
    a target matched three times in the query, a query matched twice in
    the target, repeats; the best cell is the smallest t, then the
    smallest query position."""
    core = np.array([0, 1, 2, 3, 3, 1, 0, 2, 2, 3, 1, 0])
    gap = np.full(5, 4)
    twice = np.concatenate([core, gap, core])
    acac = np.tile([0, 1], 64)
    arrays = _pad([(np.concatenate([twice, gap, core]), core),
                   (core, twice), (acac[:60], acac[:40]),
                   (acac[:41], acac[1:128])])
    for q, e in ((4, 2), (-2, 0), (0, 1)):
        out = _check(arrays, q=q, e=e)
        if (q, e) == (4, 2):
            assert [tuple(r) for r in out[:2]] == [(24, 11, 11)] * 2


def test_model_edge_pairs_and_generic_matrix():
    """The smoke run's edge pairs (phase 5h), with the simple costs and
    with a matrix that is not simple (three entries read)."""
    arrays = chip_smoke.local_edge_jobs()
    _check(arrays)
    _check(arrays, mat=chip_smoke._generic_mat(), q=6, e=1)


def test_model_local_512_anchor():
    """The JAX bench's local row: the model gives its anchor and the
    plain twin's result."""
    arrays = chip_smoke.local_512_jobs()
    a, b, q, e = chip_smoke.LOCAL_COSTS
    prm = BL.local_params(5, simple_mat(5, a, -b), q, e)
    out = model_launch(*arrays, prm)
    assert np.array_equal(out, _plain(arrays, prm))
    assert chip_smoke.local_pin({k: out[:, i] for i, k in
                                 enumerate(FIELDS)}) == \
        list(chip_smoke.LOCAL_ANCHOR)


def test_model_local_mixed_pin():
    """local-mixed (4096 pairs, queries of 8-512 bp): the model gives
    chip_smoke.LOCAL_MIXED_PIN, which the JAX function gives
    (``test_torch_local.py::test_local_mixed_pin``)."""
    arrays = chip_smoke.local_mixed_jobs()
    a, b, q, e = chip_smoke.LOCAL_COSTS
    out = model_launch(*arrays, BL.local_params(5, simple_mat(5, a, -b),
                                                q, e))
    assert chip_smoke.local_pin({k: out[:, i] for i, k in
                                 enumerate(FIELDS)}) == \
        list(chip_smoke.LOCAL_MIXED_PIN)


def test_model_at_every_target_length():
    """One launch of a ~200 bp query against every target length 0-128 (a
    prefix of its template: each lane and cell edge, lanes past the
    target): the model gives each pair the plain twin's result, and the
    JAX function the same."""
    rng = np.random.default_rng(129)
    t, qs = refcmp.random_pair(rng, 200, 0.1, 0.03)
    q = encode_dna(qs)
    T = np.zeros((129, 128), np.uint8)
    for n in range(129):
        T[n, :n] = encode_dna(t[:n])
    Q = np.tile(q, (129, 1))
    ql = np.full(129, len(q), np.int32)
    tl = np.arange(129, dtype=np.int32)
    prm = BL.local_params(5, MAT, 4, 2)
    want = BL.local_forward_plain(
        *[torch.from_numpy(np.ascontiguousarray(a, dt)) for a, dt in
          ((Q, np.uint8), (T, np.uint8), (ql, np.int32), (tl, np.int32))],
        prm).numpy()
    assert np.array_equal(model_launch(Q, T, ql, tl, prm), want)
    assert (want[1:, 0] > 0).all()
    jax = jbl.local_batch_device(Q, T, ql, tl, 5, MAT, 4, 2, interpret=True)
    for i, k in enumerate(FIELDS):
        assert np.array_equal(np.asarray(jax[k]), want[:, i])
