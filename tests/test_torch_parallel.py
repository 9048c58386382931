"""The port's mesh (ksw2_tpu_torch/parallel/mesh.py) against its
unsharded routes, the JAX package and the spec, on the CPU.

Each sharded route runs on a mesh of ``["cpu"] * 8`` (3 shards where an
odd split is wanted), so every shard runs the kernels' plain versions,
and is held exactly (the 9 fields, CIGARs as BAM words) to the same
route on one shard and to the JAX package: its own sharded scorer on its
8-device CPU mesh for ``sharded_extz_scores``, ``spec/diagdiff.py`` for
the routes that are Pallas kernels there (as tests/test_parallel.py
does), and its scheduler for ``make_sharded_run_fn`` and
``Aligner.extend_batch(mesh=)``.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.batch.scheduler import AlignJob as JJob
from ksw2_tpu.batch.scheduler import align_batch_scores as jscores
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops.batch_xla import BatchSpec as JSpec
from ksw2_tpu.parallel import mesh as jmesh
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops.batch_xla import BatchSpec
from ksw2_tpu_torch.parallel import mesh as pm
from ksw2_tpu_torch.parallel.dryrun import dryrun_multichip, example_batch

# one intra-op thread a process: tier-1 runs several pytest workers
torch.set_num_threads(1)

CPU8 = pm.make_mesh(devices=["cpu"] * 8)
CPU3 = pm.make_mesh(devices=["cpu"] * 3)
ONE = pm.make_mesh(devices=["cpu"])
MAT = simple_mat(5, 2, 4)
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")


def ez_fields(ez):
    return tuple(int(getattr(ez, f)) for f in FIELDS)


def row(ez):
    return (*ez_fields(ez), bool(ez.reach_end), list(ez.cigar))


def seeded(seed, n, lo, hi, div=0.25, indel=0.1, width=None):
    """``n`` ``refcmp.random_pair`` draws with targets in [lo, hi), as
    (pairs, Q, T, qlen, tlen) with T padded to ``width`` columns."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(lo, hi)),
                                  divergence=div, indel=indel)
        pairs.append((encode_dna(q), encode_dna(t)))
    Q = np.zeros((n, max(len(q) for q, _ in pairs)), np.int32)
    T = np.zeros((n, width or max(len(t) for _, t in pairs)), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    qlen = np.array([len(q) for q, _ in pairs], np.int32)
    tlen = np.array([len(t) for _, t in pairs], np.int32)
    return pairs, Q, T, qlen, tlen, rng


def same_fields(a, b, keys=FIELDS):
    for k in keys:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_make_mesh_devices():
    assert CPU8.size == 8 and CPU8.axis == "data"
    assert all(d == torch.device("cpu") for d in CPU8.devices)
    assert pm.make_mesh(3, devices=["cpu"] * 8).size == 3
    with pytest.raises(ValueError):
        pm.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        pm.make_mesh(devices=["meta"])
    if torch.cuda.is_available():
        assert pm.make_mesh().devices[0].type == "cuda"
    else:
        # no card: a mesh never falls back to the CPU
        with pytest.raises(RuntimeError):
            pm.make_mesh()
        with pytest.raises(RuntimeError):
            pm.make_mesh(devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("B,zdrop", [(16, 200), (24, 40)])
def test_sharded_extz_scores_matches_jax_mesh(B, zdrop):
    """The any-device scorer sharded over 8 CPU shards == the JAX
    package's sharded scorer on its 8-device mesh, batch_max included;
    an odd batch over 3 shards (padded) == one shard."""
    Q, T, ql, tl, w = example_batch(B=B, Lq=128, Lt=128, seed=3)
    spec = BatchSpec(Lq=128, Lt=128, m=5, sc_mch=2, sc_mis=-4, sc_N=-2,
                     q=4, e=2, zdrop=zdrop, flag=int(Flag.SCORE_ONLY))
    got = pm.sharded_extz_scores(CPU8, spec, Q, T, ql, tl, w)
    want = jmesh.sharded_extz_scores(jmesh.make_mesh(8), JSpec(*spec), Q, T,
                                     ql, tl, w)
    same_fields(got, want)
    assert got["batch_max"] == int(want["batch_max"])
    odd = pm.sharded_extz_scores(CPU3, spec, Q[:B - 3], T[:B - 3],
                                 ql[:B - 3], tl[:B - 3], w[:B - 3])
    same_fields(odd, {k: np.asarray(want[k])[:B - 3] for k in FIELDS})


def spec_rows(pairs, fn, keys=FIELDS):
    return {k: np.array([getattr(fn(q, t), k) for q, t in pairs])
            for k in keys}


def test_sharded_extz_pallas_matches_spec():
    """Kernel E (the batched route) sharded == one shard == diagdiff."""
    pairs, Q, T, ql, tl, _ = seeded(3, 16, 8, 120, width=128)
    w = np.maximum(ql, tl)
    got = pm.sharded_extz_scores_pallas(CPU8, Q, T, ql, tl, w, 5, MAT, 4, 2,
                                        zdrop=50)
    same_fields(got, pm.sharded_extz_scores_pallas(
        ONE, Q, T, ql, tl, w, 5, MAT, 4, 2, zdrop=50))
    same_fields(got, spec_rows(pairs, lambda q, t: diagdiff.extz2(
        q, t, 5, MAT, 4, 2, w=-1, zdrop=50, flag=Flag.SCORE_ONLY)[0]))


def test_sharded_extd_pallas_matches_spec():
    """Kernel E2 sharded (an odd split: 13 pairs on 8 shards) ==
    diagdiff.extd2, swapping costs too."""
    pairs, Q, T, ql, tl, _ = seeded(5, 13, 8, 120, width=128)
    w = np.maximum(ql, tl)
    for q, e, q2, e2 in ((4, 2, 13, 1), (24, 1, 4, 2)):
        got = pm.sharded_extd_scores_pallas(CPU8, Q, T, ql, tl, w, 5, MAT, q,
                                            e, q2, e2, zdrop=50)
        same_fields(got, spec_rows(pairs, lambda a, b: diagdiff.extd2(
            a, b, 5, MAT, q, e, q2, e2, w=-1, zdrop=50,
            flag=Flag.SCORE_ONLY)[0]))


def test_sharded_band_matches_spec():
    """Kernel 9 sharded over 3 shards == diagdiff.extz2 at bands 10-60."""
    pairs, Q, T, ql, tl, rng = seeded(7, 13, 60, 140, div=0.15, indel=0.08)
    w = rng.integers(10, 60, len(pairs)).astype(np.int32)
    got = pm.sharded_band_scores(CPU3, Q, T, ql, tl, w, 5, MAT, 4, 2,
                                 zdrop=60)
    want = [diagdiff.extz2(q, t, 5, MAT, 4, 2, w=int(wi), zdrop=60,
                           flag=Flag.SCORE_ONLY)[0]
            for (q, t), wi in zip(pairs, w)]
    same_fields(got, {k: np.array([getattr(ez, k) for ez in want])
                      for k in FIELDS})
    with pytest.raises(ValueError):
        pm.sharded_band_scores(CPU3, Q, T, ql, tl, np.zeros_like(w), 5, MAT,
                               4, 2)


def test_sharded_exts_matches_spec():
    """Kernel 6 sharded == diagdiff.exts2, with a junction track."""
    pairs, Q, T, ql, tl, _ = seeded(11, 12, 8, 120, width=128)
    mat = simple_mat(5, 1, 2)
    fl = Flag.SCORE_ONLY | Flag.SPLICE_FOR
    juncs = [None] * len(pairs)
    juncs[3] = np.zeros(len(pairs[3][1]), np.uint8)
    juncs[3][len(pairs[3][1]) // 2] = 1
    got = pm.sharded_exts_scores_pallas(CPU8, Q, T, ql, tl, 5, mat, 2, 1, 32,
                                        9, zdrop=50, junc_bonus=9, flag=fl,
                                        junc=juncs)
    want = {k: np.array([getattr(diagdiff.exts2(
        q, t, 5, mat, 2, 1, 32, 9, zdrop=50, junc_bonus=9, flag=fl,
        junc=j)[0], k) for (q, t), j in zip(pairs, juncs)]) for k in FIELDS}
    same_fields(got, want)
    with pytest.raises(ValueError):
        pm.sharded_exts_scores_pallas(CPU8, Q, T, ql, tl, 5, mat, 2, 1, 32, 9,
                                      flag=fl | Flag.EXTZ_ONLY)


def test_sharded_extf_matches_spec():
    """Kernel 7 sharded == diagdiff.extf2 (its five fields)."""
    pairs, Q, T, ql, tl, _ = seeded(13, 16, 8, 120, width=128)
    w = np.maximum(ql, tl)
    keys = ("max", "max_t", "max_q", "score", "zdropped")
    got = pm.sharded_extf_scores_pallas(CPU8, Q, T, ql, tl, w, 2, 4, 2,
                                        xdrop=40)
    assert set(got) == set(keys)
    same_fields(got, spec_rows(pairs, lambda q, t: diagdiff.extf2(
        q, t, 2, 4, 2, xdrop=40), keys), keys)


@pytest.mark.parametrize("two", [False, True])
def test_sharded_strips_records_and_cigars(two):
    """Kernel A's records and the strips CIGAR route sharded over 8 (11
    pairs: padded) == one shard == diagdiff, one- and two-piece."""
    pairs, Q, T, ql, tl, _ = seeded(53, 11, 120, 300, div=0.2)
    kw = dict(zdrop=100, two=two, q2=13, e2=1)
    rec = pm.sharded_strips_records(CPU8, Q, T, ql, tl, 5, MAT, 4, 2, **kw)
    assert np.array_equal(rec, pm.sharded_strips_records(
        ONE, Q, T, ql, tl, 5, MAT, 4, 2, **kw))
    sh = pm.sharded_strips_cigar(CPU8, Q, T, ql, tl, 5, MAT, 4, 2, **kw)
    lo = pm.sharded_strips_cigar(ONE, Q, T, ql, tl, 5, MAT, 4, 2, **kw)
    assert [row(a) for a in sh] == [row(b) for b in lo]
    for i, (q, t) in enumerate(pairs):
        ez = (diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, zdrop=100)[0] if two
              else diagdiff.extz2(q, t, 5, MAT, 4, 2, zdrop=100)[0])
        assert row(sh[i]) == row(ez), i
        assert tuple(rec[i]) == ez_fields(ez), i


def local_fields(ezs, keys=FIELDS):
    return {k: np.array([int(getattr(ez, k)) for ez in ezs]) for k in keys}


def local_route_case(name):
    """(sharded result on CPU8, the port's unsharded route's) of one
    sharded route, on the scheduler (``Aligner.extend_batch`` on the CPU)
    or, for kernel 7, ``extf_batch_device``: chip_smoke.py's mesh phase
    holds the same pairs of functions on the card."""
    from ksw2_tpu_torch.ops.batch_extf import extf_batch_device

    pairs, Q, T, ql, tl, _ = seeded(71, 19, 30, 160, div=0.2)
    w = np.full(len(pairs), 40, np.int32)
    cpu = dict(device="cpu", zdrop=100)
    so = Flag.SCORE_ONLY
    if name == "extz_score":
        return (pm.sharded_extz_scores_pallas(CPU8, Q, T, ql, tl, w, 5, MAT,
                                              4, 2, zdrop=100),
                local_fields(Aligner(w=40, flag=so, **cpu).extend_batch(
                    pairs)))
    if name == "extd_score":
        return (pm.sharded_extd_scores_pallas(CPU8, Q, T, ql, tl, w, 5, MAT,
                                              4, 2, 13, 1, zdrop=100),
                local_fields(Aligner(q2=13, e2=1, w=40, flag=so,
                                     **cpu).extend_batch(pairs)))
    if name == "extz_align":
        return ([row(ez) for ez in pm.sharded_extz_align(
            CPU8, Q, T, ql, tl, 5, MAT, 4, 2, w=w, zdrop=100)],
                [row(ez) for ez in Aligner(w=40, **cpu).extend_batch(pairs)])
    if name == "strips_cigar":
        return ([row(ez) for ez in pm.sharded_strips_cigar(
            CPU8, Q, T, ql, tl, 5, MAT, 4, 2, zdrop=100)],
                [row(ez) for ez in Aligner(**cpu).extend_batch(pairs)])
    if name == "exts_score":
        mat = simple_mat(5, 1, 2)
        fl = so | Flag.SPLICE_FOR
        juncs = [np.zeros(len(t), np.uint8) for _, t in pairs]
        for j in juncs:
            j[len(j) // 3] = 1
        aln = Aligner(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=9,
                      junc_bonus=9, flag=fl, **cpu)
        return (pm.sharded_exts_scores_pallas(
            CPU8, Q, T, ql, tl, 5, mat, 2, 1, 32, 9, zdrop=100, junc_bonus=9,
            flag=fl, junc=juncs),
                local_fields(aln.extend_batch(pairs, juncs=juncs)))
    keys = ("max", "max_t", "max_q", "score", "zdropped")
    return (pm.sharded_extf_scores_pallas(CPU8, Q, T, ql, tl, None, 2, 4, 2,
                                          xdrop=40),
            extf_batch_device(Q, T, ql, tl, 2, 4, 2, xdrop=40,
                              device="cpu"))


@pytest.mark.parametrize("name", ["extz_score", "extd_score", "extz_align",
                                  "strips_cigar", "exts_score", "extf_score"])
def test_sharded_route_matches_local_route(name):
    """Each sharded route over 8 CPU shards (19 pairs: padded) == the
    port's unsharded route on the same pairs, whichever kernel the
    scheduler picks there: every field, CIGARs as BAM words."""
    got, want = local_route_case(name)
    if isinstance(want, dict):
        assert set(want) <= set(got)
        same_fields(got, want, tuple(want))
    else:
        assert got == want


@pytest.mark.parametrize("flag", [Flag.NONE, Flag.EXTZ_ONLY | Flag.EQX])
def test_sharded_extz_align(flag):
    """sharded_extz_align (21 pairs over 8 shards) == one shard ==
    diagdiff: the batched CIGAR route, and the single-pair engine for
    EXTZ_ONLY (M ops: one-piece extz2 ignores EQX)."""
    pairs, Q, T, ql, tl, _ = seeded(31, 21, 30, 120, div=0.2)
    kw = dict(zdrop=100, end_bonus=5, flag=flag)
    sh = pm.sharded_extz_align(CPU8, Q, T, ql, tl, 5, MAT, 4, 2, **kw)
    lo = pm.sharded_extz_align(ONE, Q, T, ql, tl, 5, MAT, 4, 2, **kw)
    assert len(sh) == len(pairs)
    assert [row(a) for a in sh] == [row(b) for b in lo]
    for i, (q, t) in enumerate(pairs):
        ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2, zdrop=100, end_bonus=5,
                               flag=flag)
        assert row(sh[i]) == row(ez), i
    with pytest.raises(ValueError):
        pm.sharded_extz_align(CPU8, Q, T, ql, tl, 5, MAT, 4, 2,
                              flag=Flag.SCORE_ONLY)


def test_degenerate_scoring_and_empty_pairs_reset():
    """-min_sc > 2 (q + e) resets every pair of every sharded route, and
    an empty pair reads as reset among others."""
    pairs, Q, T, ql, tl, _ = seeded(17, 5, 20, 60)
    bad = simple_mat(5, 2, 20)                 # 20 > 2 * (4 + 2)
    w = np.maximum(ql, tl)
    reset = sched._ez_of(pm._reset_records(1)[0])
    outs = [pm.sharded_extz_scores_pallas(CPU3, Q, T, ql, tl, w, 5, bad, 4,
                                          2),
            pm.sharded_band_scores(CPU3, Q, T, ql, tl, w, 5, bad, 4, 2),
            pm._fields(pm.sharded_strips_records(CPU3, Q, T, ql, tl, 5, bad,
                                                 4, 2))]
    for out in outs:
        for k in FIELDS:
            assert (np.asarray(out[k]) == getattr(reset, k)).all(), k
    for ez in pm.sharded_extz_align(CPU3, Q, T, ql, tl, 5, bad, 4, 2) + \
            pm.sharded_strips_cigar(CPU3, Q, T, ql, tl, 5, bad, 4, 2):
        assert row(ez) == row(reset)
    ql0 = ql.copy()
    ql0[2] = 0
    got = pm.sharded_extz_align(CPU3, Q, T, ql0, tl, 5, MAT, 4, 2)
    assert row(got[2]) == row(reset)
    assert row(got[1]) == row(diagdiff.extz2(pairs[1][0], pairs[1][1], 5,
                                             MAT, 4, 2)[0])


def score_jobs(seed=5, n=37):
    """tests/test_scaling.py's 37 jobs (an odd count: padding)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        L = int(rng.integers(40, 200))
        q = rng.integers(0, 4, size=L).astype(np.int32)
        t = np.where(rng.random(L) < 0.15, rng.integers(0, 4, size=L),
                     q).astype(np.int32)
        jobs.append((q, t))
    return jobs


def test_sharded_run_fn_through_scheduler():
    """align_batch_scores with make_sharded_run_fn == the local port
    scheduler == the JAX scheduler, on 37 jobs."""
    mat = simple_mat(5, 2, -4)
    jobs = score_jobs()
    pj = [sched.AlignJob(query=q, target=t) for q, t in jobs]
    sharded = sched.align_batch_scores(pj, 5, mat, 4, 2, zdrop=100,
                                       device="cpu",
                                       run_fn=pm.make_sharded_run_fn(CPU8))
    local = sched.align_batch_scores(pj, 5, mat, 4, 2, zdrop=100,
                                     device="cpu")
    jx = jscores([JJob(query=q, target=t) for q, t in jobs], 5, mat, 4, 2,
                 zdrop=100, flag=Flag.SCORE_ONLY)
    assert [ez_fields(a) for a in sharded] == [ez_fields(b) for b in local]
    assert [ez_fields(a) for a in sharded] == [ez_fields(b) for b in jx]


def test_sharded_run_fn_picks_strips_like_local(monkeypatch):
    """The mesh run_fn routes effectively-unbanded buckets through the
    sharded strips route, with the local scheduler's records; the rest
    (a band) through the any-device scorer."""
    rng = np.random.default_rng(77)
    jobs = []
    for _ in range(12):
        t, q = refcmp.random_pair(rng, int(rng.integers(100, 700)),
                                  divergence=0.2, indel=0.1)
        jobs.append(sched.AlignJob(encode_dna(q), encode_dna(t)))
    mat = simple_mat(5, 2, -4)
    calls = []
    orig = pm.sharded_strips_records

    def spy(*a, **k):
        calls.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(pm, "sharded_strips_records", spy)
    run_fn = pm.make_sharded_run_fn(CPU3)
    sharded = sched.align_batch_scores(jobs, 5, mat, 4, 2, zdrop=100,
                                       device="cpu", run_fn=run_fn)
    assert calls, "mesh run_fn must route eligible buckets to strips"
    local = sched.align_batch_scores(jobs, 5, mat, 4, 2, zdrop=100,
                                     device="cpu")
    assert [ez_fields(a) for a in sharded] == [ez_fields(b) for b in local]
    banded = [sched.AlignJob(j.query, j.target, w=20) for j in jobs[:4]]
    n = len(calls)
    got = sched.align_batch_scores(banded, 5, mat, 4, 2, zdrop=100,
                                   device="cpu", run_fn=run_fn)
    assert len(calls) == n
    assert [ez_fields(a) for a in got] == [ez_fields(b) for b in
                                           sched.align_batch_scores(
                                               banded, 5, mat, 4, 2,
                                               zdrop=100, device="cpu")]


def long_pairs():
    """Pairs on both sides of 1536 bp, for the CIGAR mesh path."""
    rng = np.random.default_rng(91)
    out = []
    for L in (60, 1545, 250, 1536, 90):
        t, q = refcmp.random_pair(rng, L, divergence=0.1, indel=0.03)
        out.append((q, t))
    return out


def test_extend_batch_mesh_scores_and_cigars():
    """Aligner.extend_batch(mesh=) and (run_fn=) == extend_batch()."""
    pairs = long_pairs()
    sc = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY,
                 device="cpu")
    want = [ez_fields(ez) for ez in sc.extend_batch(pairs)]
    assert [ez_fields(ez) for ez in sc.extend_batch(pairs, mesh=CPU8)] == \
        want
    assert [ez_fields(ez) for ez in sc.extend_batch(
        pairs, run_fn=pm.make_sharded_run_fn(CPU3))] == want
    cg = Aligner(a=2, b=4, q=4, e=2, zdrop=100, end_bonus=5, device="cpu")
    wv = [-1, 40, 0, 100, 751]
    want = [row(ez) for ez in cg.extend_batch(pairs, w=wv)]
    assert [row(ez) for ez in cg.extend_batch(pairs, w=wv, mesh=CPU3)] == \
        want
    assert all(ez.cigar for ez in cg.extend_batch(pairs[:1], mesh=CPU3))


def test_extend_batch_mesh_value_errors():
    """The JAX package's ValueErrors (ksw2_tpu/api.py:170-183)."""
    pairs = [("ACGTACGT", "ACGTTCGT")]
    run_fn = pm.make_sharded_run_fn(CPU3)
    sc = Aligner(flag=Flag.SCORE_ONLY, device="cpu")
    with pytest.raises(ValueError, match="either mesh or run_fn"):
        sc.extend_batch(pairs, mesh=CPU3, run_fn=run_fn)
    for aln in (Aligner(q2=13, e2=1, flag=Flag.SCORE_ONLY, device="cpu"),
                Aligner(q=2, e=1, q2=32, splice=True, flag=Flag.SCORE_ONLY,
                        device="cpu")):
        with pytest.raises(ValueError, match="one-piece configurations"):
            aln.extend_batch(pairs, mesh=CPU3)
        with pytest.raises(ValueError, match="run_fn supports"):
            aln.extend_batch(pairs, run_fn=run_fn)
    with pytest.raises(ValueError, match="run_fn supports"):
        Aligner(device="cpu").extend_batch(pairs, run_fn=run_fn)
    with pytest.raises(ValueError, match="juncs requires"):
        sc.extend_batch(pairs, mesh=CPU3, juncs=[None])


def test_dryrun_multichip_cpu():
    """The dry run's steps on 8 CPU shards (a small scaling batch)."""
    res = dryrun_multichip(8, ["cpu"], B_per_dev=2, L=32, reps=1)
    assert res["batch"] == 64 and res["batch_max"] >= 0
    assert res["t1_ms"] > 0 and res["tn_ms"] > 0 and res["efficiency"] > 0


def test_scaling_and_single_process_helpers():
    t1, tn, eff = pm.scaling_efficiency(4, B_per_dev=2, L=32, reps=1,
                                        devices=["cpu"])
    assert t1 > 0 and tn > 0 and eff > 0
    assert not pm.init_distributed("gloo", world_size=1)
    assert [pm.process_rows(16, r, 3) for r in range(3)] == \
        [(0, 6), (6, 12), (12, 16)]
    rec = np.arange(6, dtype=np.int32).reshape(3, 2)
    assert pm.gather_records(rec) is rec
