"""The global alignment engines (kernels 8 and 16) and the flat walk
against the JAX package and the spec.

``ops.batch_gg2.gg2_forward_plain``, the plain version of both kernels,
is held against the JAX batched engine ``batch_pallas.gg2_batch_align(...,
interpret=True)`` (as ``tests/test_batch_pallas.py:441`` runs it) through
the port's ``gg2_batch_align``, and the port's ``gg2_device`` (kernel
16's route, with the block overrun) against the JAX ``gg2_device(...,
interpret=True)`` (as ``tests/test_kernel_interpret.py:95`` runs it),
including pairs with qlen > tlen + w; the flat store against the spec's
``gg2_sse`` Trace byte for byte, and the flat walk against the spec's
``backtrack`` on the same bytes; ``Aligner.global_align``'s fields; and
``convert``'s carry-overs.  Seeded pairs of at most ~300 bp; every
comparison is exact.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import wavefront_batch_gg2 as wbg
from ksw2_tpu.ops import wavefront_gg2 as wfg
from ksw2_tpu.ops.batch_pallas import gg2_batch_align as j_gg2_batch
from ksw2_tpu.ops.gg2 import gg2_device as j_gg2_device
from ksw2_tpu.spec import diagdiff
from ksw2_tpu.spec.backtrack import backtrack as j_backtrack

from ksw2_tpu_torch import Aligner, convert
from ksw2_tpu_torch.ops import band_walker as BW
from ksw2_tpu_torch.ops import batch_gg2 as BG
from ksw2_tpu_torch.ops import gg2 as G1
from ksw2_tpu_torch.ops.batch_extf import pack_pairs
from ksw2_tpu_torch.spec.backtrack import backtrack

torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)


def _batch(seed, B):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        tlen = int(rng.integers(8, 128))
        t, q = refcmp.random_pair(
            rng, tlen, divergence=float(rng.uniform(0, 0.4)),
            indel=float(rng.uniform(0, 0.2)),
            with_n=bool(rng.integers(0, 2)))
        pairs.append((encode_dna(q), encode_dna(t)))
    Lq = max(len(q) for q, _ in pairs)
    Q = np.zeros((B, Lq), np.int32)
    T = np.zeros((B, 128), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    return pairs, Q, T, ql, tl


@pytest.mark.parametrize("banded", [False, True])
def test_batched_matches_jax_batched_engine(banded):
    """Kernel 8's plain version and the flat walk give the JAX batched
    engine's scores and CIGARs."""
    _, Q, T, ql, tl = _batch(511 + banded, 6)
    rng = np.random.default_rng(3 + banded)
    if banded:
        wv = np.maximum(ql - tl + 2, rng.integers(12, 60, 6)).astype(np.int32)
    else:
        wv = np.maximum(ql, tl).astype(np.int32)
    want = j_gg2_batch(Q, T, ql, tl, 5, MAT, 4, 2, wv, interpret=True)
    got = BG.gg2_batch_align(Q, T, ql, tl, 5, MAT, 4, 2, wv, device="cpu")
    assert [(s, list(c)) for s, c in want] == got


_rngg = np.random.default_rng(88)
INTERP = []
for _i in range(6):
    _t, _q = refcmp.random_pair(_rngg, int(_rngg.integers(10, 90)),
                                divergence=0.3, indel=0.12,
                                with_n=bool(_rngg.integers(0, 2)))
    INTERP.append((_t, _q, int(_rngg.choice([-1, 5, 16]))))
# qlen > tlen + w: the H0 walk runs past u into v, x, y and s
INTERP.append(("ACGTTGCA" * 3, "ACGTTGCA" * 7, 2))
INTERP.append(("GATTACA" * 4, "GATTACA" * 9 + "TT", 5))


@pytest.mark.parametrize("idx", range(len(INTERP)))
def test_single_pair_matches_jax_engine(idx):
    """The port's ``gg2_device`` (kernel 16's route, its plain version
    with the block overrun) gives the JAX single-pair engine's score and
    CIGAR."""
    t, q, w = INTERP[idx]
    qs, ts = encode_dna(q), encode_dna(t)
    ws, wc, _ = j_gg2_device(qs, ts, 5, MAT, 4, 2, w=w, interpret=True)
    gs, gc, _ = G1.gg2_device(qs, ts, 5, MAT, 4, 2, w=w, device="cpu")
    assert (gs, gc) == (ws, list(wc))


def _spec_cases(seed, n, overrun=False):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(3, 301)),
                                  divergence=0.3, indel=0.12,
                                  with_n=k % 2 == 0)
        q, t = encode_dna(q), encode_dna(t)
        w = int(rng.choice([-1, 0, 1, 5, 16, 40]))
        if overrun and k % 2:
            q = np.concatenate([q, q[:len(q) // 2 + 10]])
            w = int(rng.choice([0, 1, 3, 8]))
        out.append((q, t, w))
    return out


@pytest.mark.parametrize("seed", [601, 602, 603])
def test_store_and_walk_match_spec(seed):
    """Kernel 16's plain version writes the spec's ``gg2_sse`` bytes in
    the reference's flat layout (rows of n_col, cell i at r n_col + i -
    st(r), one zero row after), its score is the spec's, and the flat
    walk gives what the spec's ``backtrack`` (the JAX package's and the
    port's copy) gives on the same bytes."""
    cases = _spec_cases(seed, 8, overrun=True)
    table = torch.from_numpy(MAT.astype(np.int32))
    for q, t, w in cases:
        wr = w if w >= 0 else max(len(q), len(t))
        args = pack_pairs([(q, t)], [wr], "cpu")
        pb, total = BG.flat_layout([len(q)], [len(t)], [wr])
        pbt = torch.from_numpy(pb)
        score, p = BG.gg2_forward_plain(*args, table, 5, 4, 2, pbt, total,
                                        True)
        ws, wc, tr = diagdiff.gg2_sse(q, t, 5, MAT, 4, 2, w=w)
        assert int(score[0]) == ws
        assert tr.n_col == int(BG.gg2_ncol(len(t), wr))
        flat = np.concatenate([tr.p.reshape(-1),
                               np.zeros(tr.n_col, np.uint8)])
        assert np.array_equal(p.numpy(), flat)
        res, runs = BW.flat_walk(p, pbt, *args[2:])
        cig = BW.flat_walk_cigars(res, runs)[0]
        kw = dict(is_rot=True)
        assert cig == list(wc)
        assert cig == j_backtrack(tr.p, tr.off, None, tr.n_col, len(t) - 1,
                                  len(q) - 1, **kw)
        assert cig == backtrack(tr.p, tr.off, None, tr.n_col, len(t) - 1,
                                len(q) - 1, **kw)


def test_pairs_match_spec_in_one_launch():
    """Many pairs, banded, unbanded and overrunning, in one launch of
    kernel 16's plain version give the spec's scores and CIGARs; the
    batched route refuses the overrunning ones."""
    cases = _spec_cases(610, 14, overrun=True)
    got = G1.gg2_pairs([(q, t) for q, t, _ in cases], 5, MAT, 4, 2,
                       [w for _, _, w in cases], device="cpu")
    for (q, t, w), (s, c) in zip(cases, got):
        ws, wc, _ = diagdiff.gg2_sse(q, t, 5, MAT, 4, 2, w=w)
        assert (s, c) == (ws, list(wc))
    q, t, w = next(c for c in cases if len(c[0]) > len(c[1]) + max(c[2], 0))
    with pytest.raises(ValueError, match="single-pair"):
        BG.gg2_batch_align(q[None], t[None], [len(q)], [len(t)], 5, MAT, 4,
                           2, [w], device="cpu")


def test_launch_groups_split_by_bytes(monkeypatch):
    """A launch's flat stores stay within the byte budget; a pair larger
    than the budget goes alone."""
    ql = np.array([100, 100, 5000, 100])
    tl = np.array([100, 100, 5000, 100])
    w = np.array([100, 100, 5000, 100])
    assert BG.launch_groups(ql, tl, w) == [(0, 4)]
    monkeypatch.setattr(BG.strips, "LAUNCH_BYTES", 10 ** 6)
    assert BG.launch_groups(ql, tl, w) == [(0, 2), (2, 3), (3, 4)]


def test_global_align_fields():
    """``Aligner.global_align`` gives the corner fields of
    ``ksw2_tpu/api.py:115-141`` over the spec's score and CIGAR."""
    t, q = refcmp.random_pair(np.random.default_rng(5), 120,
                              divergence=0.2, indel=0.1)
    qs, ts = encode_dna(q), encode_dna(t)
    ez = Aligner(device="cpu", w=30).global_align(q, t)
    ws, wc, _ = diagdiff.gg2_sse(qs, ts, 5, MAT, 4, 2, w=30)
    assert (ez.score, ez.cigar) == (ws, list(wc))
    assert (ez.max, ez.max_t, ez.max_q) == (ws, len(ts) - 1, len(qs) - 1)
    assert (ez.mqe, ez.mqe_t, ez.mte, ez.mte_q) == (ws, len(ts) - 1, ws,
                                                    len(qs) - 1)
    assert ez.reach_end and not ez.zdropped


def test_convert_carries_gg2_params():
    """``convert.launch_values_from_jax`` keeps every non-layout field of the
    JAX tuples (the batched one's matrix as the score table)."""
    jp = wfg.Gg2Params(qlen=70, tlen=64, m=5, q=4, e=2, w=20, chunk=32,
                       n_diag=133, n_rows=8, p_rows=32)
    assert convert.launch_values_from_jax(jp._asdict()) == dict(
        qlen=70, tlen=64, m=5, q=4, e=2, w=20)
    jb = wbg.BatchGg2Params(n_rows=16, n_diag=256, m=5, q=4, e=2, chunk=32,
                            p=2, matt=tuple(int(v) for v in MAT))
    got = convert.launch_values_from_jax(jb._asdict())
    assert {k: got[k] for k in ("m", "q", "e")} == dict(m=5, q=4, e=2)
    assert np.array_equal(got["mat"], MAT.astype(np.int32))
