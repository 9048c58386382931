"""The single-pair one-piece engine (kernels 12 and 17) against the JAX
package and the spec.

Kernel 12's plain version (``ops/extz_fwd.py:extz_forward_plain``) and the
host side ``ops/extz.extz2_device`` are held against the JAX
``ops/extz.extz2_device(..., interpret=True)``, the Pallas kernel that
``tests/test_kernel_interpret.py`` runs; kernel 17's plain version
(``ops/traceback_device.py:extz_walk_plain``) against the JAX
``build_traceback_call(..., interpret=True)`` on the JAX forward's bytes
and on random byte stores; the compact store against the spec's
``Trace``; the any-device route against the JAX ``batch_xla``; and the
``convert`` functions against the JAX parameter tuples.  Every
comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import batch_xla as jbx
from ksw2_tpu.ops import traceback_device as jtb
from ksw2_tpu.ops import wavefront as wf
from ksw2_tpu.ops.bands import round_up
from ksw2_tpu.ops.extz import _pad_seq
from ksw2_tpu.ops.extz import extz2_device as j_extz2_device
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import convert
from ksw2_tpu_torch.ops import batch_xla as BX
from ksw2_tpu_torch.ops import extz as EZ
from ksw2_tpu_torch.ops import extz_fwd as F
from ksw2_tpu_torch.ops import traceback_device as TB
from ksw2_tpu_torch.ops.band import make_band_params
from ksw2_tpu_torch.ops.bands import (band_bounds_rounded, first_empty_diag,
                                     n_col_bytes)

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP


def _generic_mat():
    rng = np.random.default_rng(3)
    mat = rng.integers(-4, 3, (5, 5)).astype(np.int8)
    np.fill_diagonal(mat, 2)
    return mat.reshape(-1)


def _cases():
    """(query, target, w, zdrop, end_bonus, flag, mat) seeded cases of
    10-120 bp covering the options the engine takes."""
    rng = np.random.default_rng(12)
    opts = [Flag.NONE, Flag.RIGHT, Flag.SCORE_ONLY, Flag.SCORE_ONLY | APPROX,
            Flag.SCORE_ONLY | Flag.APPROX_MAX, Flag.EXTZ_ONLY,
            Flag.EXTZ_ONLY | Flag.RIGHT, Flag.REV_CIGAR,
            Flag.GENERIC_SC, Flag.GENERIC_SC | Flag.SCORE_ONLY,
            Flag.EXTZ_ONLY | Flag.REV_CIGAR, Flag.NONE, Flag.RIGHT,
            Flag.SCORE_ONLY, Flag.EXTZ_ONLY, Flag.NONE]
    out = []
    for k, flag in enumerate(opts):
        t, q = refcmp.random_pair(rng, int(rng.integers(10, 121)),
                                  divergence=0.25, indel=0.1,
                                  with_n=k % 3 == 0)
        w = (-1, 0, 5, 16)[k % 4]
        z = (-1, 20)[(k // 4) % 2]
        eb = 10 if flag & Flag.EXTZ_ONLY else 0
        mat = _generic_mat() if flag & Flag.GENERIC_SC else MAT
        out.append((encode_dna(q), encode_dna(t), w, z, eb, flag, mat))
    return out


CASES = _cases()


def _fields(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, bool(ez.zdropped), bool(ez.reach_end), list(ez.cigar))


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_extz2_device_matches_jax(idx):
    """``extz2_device`` over kernel 12's and kernel 17's plain versions
    equals the JAX single-pair engine (its Pallas kernels interpreted):
    all 9 fields, reach_end and the CIGAR."""
    q, t, w, z, eb, flag, mat = CASES[idx]
    want, _ = j_extz2_device(q, t, 5, mat, 4, 2, w=w, zdrop=z, end_bonus=eb,
                             flag=flag, interpret=True)
    got = EZ.extz2_device(q, t, 5, mat, 4, 2, w=w, zdrop=z, end_bonus=eb,
                          flag=flag, device="cpu")
    assert _fields(got) == _fields(want)


def _jax_forward(q, t, w, zdrop, flag):
    """The JAX kernel's (params, res, bytes, full_rows) with bytes, as
    ``ksw2_tpu/ops/extz.py:extz2_device`` builds them."""
    qlen, tlen = len(q), len(t)
    w = max(qlen, tlen) if w < 0 else w
    N = max(round_up((tlen + 15) // 16 * 16, 128), 1024)
    p_rows = round_up(round_up(n_col_bytes(qlen, tlen, w) + 128, 128) // 128,
                      32)
    chunk = max(8, min(128, (4 << 20) // (p_rows * 128)))
    prm = wf.ExtzParams(qlen=qlen, tlen=tlen, m=5, sc_mch=2, sc_mis=-4,
                        sc_N=-2, q=4, e=2, w=w, zdrop=zdrop, flag=int(flag),
                        chunk=chunk, n_diag=qlen + tlen - 1, n_rows=N // 128,
                        p_rows=p_rows)
    call = jax.jit(wf.build_extz_call(prm, True, interpret=True))
    res, p = call(jnp.asarray(_pad_seq(q, max(round_up(qlen, 128), 1024))),
                  jnp.asarray(_pad_seq(t, N)))
    return prm, np.asarray(res), np.asarray(p), int(p_rows >= N // 128)


def _compact_from_jax(p, full_rows, qlen, tlen, w):
    """The JAX store (rows of p_rows x 128 bytes at ``st // 128 * 128``,
    or at 0 with full rows) laid out as the port's compact store."""
    n = int(first_empty_diag(qlen, tlen, w))
    _, _, st, en = band_bounds_rounded(n, qlen, tlen, w)
    flat = p.reshape(p.shape[0], -1).view(np.uint8)
    rows = []
    for r in range(min(n, p.shape[0])):
        so = 0 if full_rows else st[r] // 128 * 128
        rows.append(flat[r, st[r] - so:en[r] - so + 1])
    return np.concatenate(rows)


def _expand(runs, count):
    ops = []
    for word in runs[:count]:
        ops += [int(word) & 0xF] * (int(word) >> 4)
    return ops


def _walk_both(jp, pc, qlen, tlen, w, start, min_intron, upper_force):
    """Kernel 17's plain version on the compact store ``pc`` and the JAX
    walker on its own store ``jp``, from ``start``: (port, JAX) as
    (i_end, j_end, ops, escaped)."""
    tprm = jtb.TbParams(qlen=qlen, tlen=tlen, w=w, n_diag=qlen + tlen - 1,
                        p_rows=jp.shape[1], blk=8,
                        n_blocks=jp.shape[0] // 8, min_intron=min_intron,
                        upper_force=upper_force, full_rows=1)
    call = jax.jit(jtb.build_traceback_call(tprm, interpret=True))
    jres, jops = call(jnp.asarray(np.array(start, np.int32)),
                      jnp.asarray(jp))
    jres, jops = np.asarray(jres), np.asarray(jops).reshape(-1)
    i32 = torch.int32
    res, runs = TB.extz_walk_plain(
        torch.from_numpy(pc), torch.zeros(1, dtype=torch.int64),
        torch.tensor([start], dtype=i32), torch.tensor([qlen], dtype=i32),
        torch.tensor([tlen], dtype=i32), torch.tensor([w], dtype=i32),
        qlen + tlen + 2, min_intron, upper_force)
    res, runs = res.numpy()[0], runs.numpy()[0]
    port = (int(res[0]), int(res[1]), _expand(runs, res[2]), int(res[3]))
    # BAM codes of the port's runs (M 0, I 1, D 2, N 3) are the JAX ops'
    jax_ = (int(jres[0]), int(jres[1]), [int(o) for o in jops[:jres[2]]],
            int(jres[3]))
    return port, jax_


@pytest.mark.parametrize("idx", [0, 1, 5, 7, 11, 12, 14, 15])
def test_walker_matches_jax_on_the_jax_forward_bytes(idx):
    """Kernel 17's plain version walks the JAX forward's bytes, laid out
    as the compact store, as the JAX walker walks its own store: end
    cell, ops, count and escape flag, with upper_force 1 and 0 and
    min_intron 0 and 5 (extz bytes have no state 3; the random stores
    below walk N ops)."""
    q, t, w, z, _, flag, _ = CASES[idx]
    flag &= ~(Flag.GENERIC_SC | Flag.SCORE_ONLY)
    prm, res, p, full_rows = _jax_forward(q, t, w, z, flag)
    qlen, tlen, wr = len(q), len(t), prm.w
    pc = _compact_from_jax(p, full_rows, qlen, tlen, wr)
    # the JAX store re-laid at true positions for the JAX walker
    n = p.shape[0]
    jp = np.zeros((round_up(n, 8), 32, 128), np.int8)
    _, _, st, en = band_bounds_rounded(min(n, qlen + tlen - 1), qlen, tlen,
                                       wr)
    flat = p.reshape(n, -1)
    for r in range(min(n, qlen + tlen - 1)):
        so = 0 if full_rows else st[r] // 128 * 128
        jp[r].reshape(-1)[st[r]:en[r] + 1] = flat[r, st[r] - so:en[r] - so
                                                  + 1]
    zd = bool(res[wf.ZDROP])
    start = ((int(res[wf.MAXT]), int(res[wf.MAXQ])) if zd
             else (tlen - 1, qlen - 1))
    for upper_force in (1, 0):
        for min_intron in (0, 5):
            port, jax_ = _walk_both(jp, pc, qlen, tlen, wr, start,
                                    min_intron, upper_force)
            assert port[3] == jax_[3]
            if port[3]:             # escaped: the steps before it agree
                assert port[2] == jax_[2][:len(port[2])]
            else:
                assert port == jax_


@pytest.mark.parametrize("seed", range(6))
def test_walker_matches_jax_on_random_bytes(seed):
    """Random direction bytes (states 0-3 with random continuation bits)
    walked from the end cell and from an inner cell: state 3 prints N
    with min_intron > 0, forces hold at both band edges, and a walk
    above the band escapes under upper_force 0, as in the JAX walker."""
    rng = np.random.default_rng(100 + seed)
    qlen, tlen = int(rng.integers(20, 200)), int(rng.integers(20, 200))
    w = int(rng.choice([3, 10, 40, 400]))
    n = qlen + tlen - 1
    jp = np.zeros((round_up(n, 8), 32, 128), np.int8)
    raw = rng.integers(0, 4, (n, 4096)) | (rng.integers(0, 16, (n, 4096))
                                           << 3)
    jp.reshape(round_up(n, 8), -1)[:n] = raw.astype(np.int8)
    nrow = int(first_empty_diag(qlen, tlen, w))
    _, _, st, en = band_bounds_rounded(nrow, qlen, tlen, w)
    pc = np.concatenate([raw[r, st[r]:en[r] + 1] for r in range(nrow)]
                        ).astype(np.uint8)
    inner = (int(rng.integers(0, tlen)), int(rng.integers(0, qlen)))
    for start in ((tlen - 1, qlen - 1), inner):
        if sum(start) >= nrow:
            continue
        for upper_force in (1, 0):
            for min_intron in (0, 3):
                port, jax_ = _walk_both(jp, pc, qlen, tlen, w, start,
                                        min_intron, upper_force)
                assert port[3] == jax_[3]
                if port[3]:
                    assert port[2] == jax_[2][:len(port[2])]
                else:
                    assert port == jax_


@pytest.mark.parametrize("seed,tlen,w", [(0, 300, -1), (1, 1000, -1),
                                         (2, 700, 100), (3, 900, 3)])
def test_compact_store_matches_the_spec_trace(seed, tlen, w):
    """Kernel 12's plain version writes the spec's direction bytes: each
    row r of the compact store is the spec's row ``p[r, :en - st + 1]``
    (the spec's rows start at the rounded ``st``), up to the stop."""
    rng = np.random.default_rng(seed)
    t, q = refcmp.random_pair(rng, tlen, divergence=0.15, indel=0.06)
    q, t = encode_dna(q), encode_dna(t)
    _, trace = diagdiff.extz2(q, t, 5, MAT, 4, 2, w=w, zdrop=200)
    wr = max(len(q), len(t)) if w < 0 else w
    launch, = EZ.extz_prep([q], [t], [len(q)], [len(t)], [wr], 5, MAT, 4, 2,
                           200, 0, cig=True)
    args = EZ.band_upload(launch, "cpu")
    rec, p, stop = F.extz_forward_plain(*args, launch.prm, launch.lay)
    nrow = int(stop[0])
    wid = F.row_widths(nrow, len(q), len(t), wr)
    want = np.concatenate([trace.p[r, :wid[r]] for r in range(nrow)])
    assert np.array_equal(p.numpy()[:wid.sum()], want)
    assert not p.numpy()[wid.sum():].any()


def test_row_off_closed_form():
    """The store's closed-form row offsets (the kernels' ``store_row_off``)
    equal the running sum of the row widths, bands of every kind."""
    rng = np.random.default_rng(9)
    for _ in range(200):
        ql, tl = int(rng.integers(1, 400)), int(rng.integers(1, 400))
        w = int(rng.choice([0, 1, 2, 5, 16, 33, 100, 1000]))
        n = int(first_empty_diag(ql, tl, w))
        want = np.concatenate([[0], np.cumsum(F.row_widths(n, ql, tl, w))])
        assert np.array_equal(F.row_off(np.arange(n + 1), ql, tl, w), want)
        assert int(F.store_bytes(ql, tl, w)[0]) == int(want[-1])


def test_layout_tiles_and_bases():
    """A launch's layout: tiles cover each target and its 15-position
    overshoot, the bases are running sums."""
    ql, tl, w = [30, 500, 260], [700, 129, 1000], [700, 500, 20]
    lay = F.make_layout(ql, tl, w, 128, cig=True)
    assert list(np.diff(lay.tbase)) == [6, 2, 8]
    rl = [int(first_empty_diag(a, b, c)) for a, b, c in zip(ql, tl, w)]
    assert list(lay.rlim) == rl and lay.n_diag == sum(rl)
    assert list(lay.dbase) == [0, rl[0], rl[0] + rl[1]]
    assert list(lay.bbase) == [0, 5 * rl[0], 5 * rl[0] + rl[1]]
    sizes = [int(F.store_bytes(a, b, c)[0]) for a, b, c in zip(ql, tl, w)]
    assert list(lay.pbase) == [0, sizes[0], sizes[0] + sizes[1]]
    assert lay.n_bytes == sum(sizes)
    assert F.choose_tp(1, 50000) == 128 and F.choose_tp(4096, 512) == 640


@pytest.mark.parametrize("cig", [False, True])
def test_prep_splits_a_bucket_by_its_buffers(monkeypatch, cig):
    """``extz_prep`` keeps each launch's buffers (boundary history at tiles
    of ``TP_MIN``, per-diagonal records and, with CIG, the store) within
    ``LAUNCH_BYTES``, score buckets too; a pair larger than that alone
    gets a launch of its own; the split bucket's records are the whole
    bucket's."""
    from ksw2_tpu_torch.ops import strips
    rng = np.random.default_rng(21)
    pairs = [refcmp.random_pair(rng, L, divergence=0.15, indel=0.06)
             for L in (300, 500, 150, 600, 250, 400)]
    qs = [encode_dna(q) for _, q in pairs]
    ts = [encode_dna(t) for t, _ in pairs]
    ql = np.array([len(q) for q in qs], np.int32)
    tl = np.array([len(t) for t in ts], np.int32)
    w = np.array([-1, 100, 60, 100, 0, 100], np.int32)
    w = np.where(w < 0, np.maximum(ql, tl), w).astype(np.int32)
    flag = 0 if cig else int(Flag.SCORE_ONLY)
    sizes = F.launch_bytes(ql, tl, w, F.TP_MIN, cig)
    whole, = EZ.extz_prep(qs, ts, ql, tl, w, 5, MAT, 4, 2, 100, flag, cig)
    assert whole.lay.tp == F.TP_MIN
    assert whole.lay.device_bytes() == int(sizes.sum())
    budget = int(sizes[1] + sizes[2])
    assert sizes[3] > budget        # a pair alone over the budget
    monkeypatch.setattr(strips, "LAUNCH_BYTES", budget)
    split = EZ.extz_prep(qs, ts, ql, tl, w, 5, MAT, 4, 2, 100, flag, cig)
    assert [len(ln.qlen) for ln in split] == [1, 2, 1, 2]
    assert np.array_equal(np.concatenate([ln.qlen for ln in split]), ql)
    for ln in split:
        assert len(ln.qlen) == 1 or ln.lay.device_bytes() <= budget
    got = torch.cat([EZ.extz_records(ln, "cpu") for ln in split])
    assert torch.equal(got, EZ.extz_records(whole, "cpu"))


@pytest.mark.parametrize("flag", [Flag.SCORE_ONLY,
                                  Flag.SCORE_ONLY | APPROX])
def test_any_device_route_matches_jax_batch_xla(flag):
    """Item 7's route (kernel 12's score form over a bucket) equals the
    JAX ``batch_xla.extz_batch_scores`` on two pairs just over 3072 bp."""
    rng = np.random.default_rng(31)
    pairs = [refcmp.random_pair(rng, 3080 + 7 * k, divergence=0.15,
                                indel=0.06) for k in range(2)]
    qs = [encode_dna(q) for _, q in pairs]
    ts = [encode_dna(t) for t, _ in pairs]
    qlen = np.array([len(q) for q in qs], np.int32)
    tlen = np.array([len(t) for t in ts], np.int32)
    w = np.maximum(qlen, tlen)
    Lq, Lt = round_up(int(qlen.max()), 128), round_up(int(tlen.max()), 128)
    Q = np.zeros((2, Lq), np.int32)
    T = np.zeros((2, Lt), np.int32)
    for k in range(2):
        Q[k, :qlen[k]] = qs[k]
        T[k, :tlen[k]] = ts[k]
    zdrop = 100 if flag & Flag.APPROX_DROP else -1
    spec = jbx.BatchSpec(Lq=Lq, Lt=Lt, m=5, sc_mch=2, sc_mis=-4, sc_N=-2,
                         q=4, e=2, zdrop=zdrop, flag=int(flag))
    want = jbx.extz_batch_scores(spec, jnp.asarray(Q), jnp.asarray(T),
                                 jnp.asarray(qlen), jnp.asarray(tlen),
                                 jnp.asarray(w))
    got = BX.extz_batch_scores(BX.BatchSpec(*spec), Q, T, qlen, tlen, w,
                               device="cpu")
    for k in got:
        assert np.array_equal(got[k], np.asarray(want[k])), k


def test_convert_params_from_jax():
    """``extz_params_from_jax`` / ``tb_params_from_jax`` carry the JAX
    tuples' values and drop the TPU layout fields; the port's host side
    builds the same ExtzParams for the pair."""
    q, t = encode_dna("ACGTACGTAAC"), encode_dna("ACGTTCGTAACGG")
    jprm = wf.ExtzParams(qlen=11, tlen=13, m=5, sc_mch=2, sc_mis=-4,
                         sc_N=-2, q=4, e=2, w=13, zdrop=100, flag=0,
                         chunk=128, n_diag=23, n_rows=8, p_rows=32)
    prm = convert.extz_params_from_jax(jprm._asdict())
    assert prm == EZ.extz_params(q, t, 5, MAT, 4, 2, -1, 100, 0)
    assert prm._asdict() == {k: v for k, v in jprm._asdict().items()
                             if k not in ("chunk", "n_rows", "p_rows")}
    jt = jtb.TbParams(qlen=11, tlen=13, w=13, n_diag=23, p_rows=32, blk=8,
                      n_blocks=3, min_intron=0, upper_force=1, full_rows=1)
    tb = convert.tb_params_from_jax(jt._asdict())
    assert tb._asdict() == {k: v for k, v in jt._asdict().items()
                            if k not in ("p_rows", "blk", "n_blocks",
                                         "full_rows")}


def test_forward_plain_records_equal_the_band_forward():
    """The plain version is the band route's forward: its records are
    ``band_forward_plain``'s, and its stop is where each pair stopped."""
    from ksw2_tpu_torch.ops.band import band_forward_plain
    rng = np.random.default_rng(4)
    pairs = [refcmp.random_pair(rng, int(rng.integers(60, 200)),
                                divergence=0.3, indel=0.1) for _ in range(5)]
    qs = [encode_dna(q) for _, q in pairs]
    ts = [encode_dna(t) for t, _ in pairs]
    ql = [len(q) for q in qs]
    tl = [len(t) for t in ts]
    w = [max(a, b) for a, b in zip(ql, tl)]
    launch, = EZ.extz_prep(qs, ts, ql, tl, w, 5, MAT, 4, 2, 30, 0, cig=False)
    args = EZ.band_upload(launch, "cpu")
    rec, p, stop = F.extz_forward_plain(*args, launch.prm, launch.lay)
    want, _ = band_forward_plain(*args, make_band_params(5, MAT, 4, 2, 30, 0),
                                 max(a + b - 1 for a, b in zip(ql, tl)), 16)
    assert p is None and torch.equal(rec, want)
    for k in range(5):
        ez, _ = diagdiff.extz2(qs[k], ts[k], 5, MAT, 4, 2, zdrop=30,
                               flag=Flag.SCORE_ONLY)
        assert (int(stop[k]) < ql[k] + tl[k] - 1) == ez.zdropped
