"""A dry run of the mesh, and its two-process worker.

:func:`dryrun_multichip` is the twin of ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:47-190``): on a mesh of ``n`` shards it runs the
sharded any-device scorer (with ``batch_max``), the sharded two-piece
batched scores (E2), the sharded strips records and CIGARs, checked equal
to the same routes on one shard, one pair split over the mesh by the halo
wavefront, checked against kernel 12's fields and the port's spec, and
the scaling ratio.

    python -m ksw2_tpu_torch.parallel.dryrun --n 4 [--device cuda|cpu]

The worker is the counterpart of ``tests/multihost_demo.py``: each of
``--world`` processes scores its row block of the seeded 16 x 64 batch on
a mesh of its device, all-gathers the records, all-reduces the score sum
and prints ``OK <rank> <checksum>``:

    python -m ksw2_tpu_torch.parallel.dryrun --rank R --world N \\
        --init tcp://127.0.0.1:PORT [--backend gloo|nccl] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.flags import Flag
from ..core.matrix import simple_mat
from ..ops.batch_xla import BatchSpec
from ..ops.extz import extz2_device
from ..spec.rowdp import extz as spec_extz
from .halo import halo_extz_score
from .mesh import (gather_records, init_distributed, make_mesh,
                   process_rows, scaling_efficiency,
                   sharded_extd_scores_pallas, sharded_extz_scores,
                   sharded_strips_cigar, sharded_strips_records)

MAT = simple_mat(5, 2, -4)


def example_batch(B: int = 8, Lq: int = 256, Lt: int = 256, seed: int = 0):
    """``__graft_entry__._example_batch``'s seeded batch as numpy: (Q, T,
    qlen, tlen, w), targets a copy of the queries with ~10% mutated."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, size=(B, Lq)).astype(np.int32)
    mut = rng.random(Q.shape) < 0.1
    T = np.where(mut, rng.integers(0, 4, size=Q.shape), Q).astype(np.int32)
    return (Q, T, np.full(B, Lq, np.int32), np.full(B, Lt, np.int32),
            np.full(B, max(Lq, Lt), np.int32))


def example_spec(Lq: int = 256, Lt: int = 256, zdrop: int = 200) -> BatchSpec:
    return BatchSpec(Lq=Lq, Lt=Lt, m=5, sc_mch=2, sc_mis=-4, sc_N=-2, q=4,
                     e=2, zdrop=zdrop, flag=int(Flag.SCORE_ONLY))


def _fields(ez):
    return (ez.score, ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte,
            ez.mte_q, ez.zdropped)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     B_per_dev: int = 64, L: int = 128, reps: int = 3
                     ) -> dict:
    """Every sharded step on a mesh of ``n_devices`` shards cycling over
    ``devices`` (default: the visible cards), the scaling ratio on
    ``B_per_dev`` pairs of ``L`` a shard; raises on a mismatch and
    returns the steps' numbers."""
    base = list(devices) if devices is not None else list(
        make_mesh().devices)
    mesh = make_mesh(devices=[base[i % len(base)] for i in range(n_devices)])
    one = make_mesh(devices=base[:1])
    B = 8 * n_devices
    Q, T, ql, tl, w = example_batch(B=B, Lq=128, Lt=128)
    spec = example_spec(128, 128)
    out = sharded_extz_scores(mesh, spec, Q, T, ql, tl, w)
    ref = sharded_extz_scores(one, spec, Q, T, ql, tl, w)
    if out["score"].shape != (B,) or out["batch_max"] < 0 or any(
            not np.array_equal(out[k], ref[k]) for k in ref):
        raise AssertionError("sharded scores differ from one shard's")
    # the two-piece batched scorer (kernel E2)
    outp = sharded_extd_scores_pallas(mesh, Q, T, ql, tl, w, 5, MAT, 4, 2,
                                      13, 1, zdrop=200)
    refp = sharded_extd_scores_pallas(one, Q, T, ql, tl, w, 5, MAT, 4, 2,
                                      13, 1, zdrop=200)
    if any(not np.array_equal(outp[k], refp[k]) for k in refp):
        raise AssertionError("sharded E2 scores differ from one shard's")
    # the strips route, records and CIGARs
    rec = sharded_strips_records(mesh, Q, T, ql, tl, 5, MAT, 4, 2,
                                 zdrop=200)
    if not np.array_equal(rec[:, 0], out["max"]):
        raise AssertionError("sharded strips records differ from the "
                             "any-device scorer's")
    Bc = 2 * n_devices
    cig = sharded_strips_cigar(mesh, Q[:Bc], T[:Bc], ql[:Bc], tl[:Bc], 5,
                               MAT, 4, 2, zdrop=200)
    cig1 = sharded_strips_cigar(one, Q[:Bc], T[:Bc], ql[:Bc], tl[:Bc], 5,
                                MAT, 4, 2, zdrop=200)
    if [(e.cigar, _fields(e)) for e in cig] != \
            [(e.cigar, _fields(e)) for e in cig1]:
        raise AssertionError("sharded strips CIGARs differ from one "
                             "shard's")
    # one pair split over the mesh
    rng = np.random.default_rng(1)
    hq = rng.integers(0, 4, 700).astype(np.uint8)
    ht = hq.copy()
    ht[rng.random(700) < 0.12] = rng.integers(0, 4)
    mat5 = simple_mat(5, 2, 4)
    hez = halo_extz_score(mesh, hq, ht, 5, mat5, 4, 2, w=-1,
                          block_diagonals=128)
    k12 = extz2_device(hq, ht, 5, mat5, 4, 2, w=-1, flag=Flag.SCORE_ONLY,
                       device=mesh.devices[0])
    sp = spec_extz(hq, ht, 5, mat5, 4, 2, w=-1, flag=Flag.SCORE_ONLY)
    if _fields(hez) != _fields(k12) or (hez.score, hez.max) != \
            (sp.score, sp.max):
        raise AssertionError(f"halo {_fields(hez)} against kernel 12's "
                             f"{_fields(k12)} and the spec's "
                             f"{(sp.score, sp.max)}")
    t1, tn, eff = scaling_efficiency(n_devices, B_per_dev, L, reps,
                                     devices=base)
    res = {"devices": [str(d) for d in mesh.devices], "batch": B,
           "scores": out["score"][:4].tolist(),
           "batch_max": out["batch_max"], "extd_max": outp["max"][:4].tolist(),
           "halo_score": hez.score, "t1_ms": t1 * 1e3, "tn_ms": tn * 1e3,
           "wall_ratio": t1 / tn, "efficiency": eff}
    print(f"dryrun_multichip: {res}", flush=True)
    return res


def multihost_batch():
    """``tests/multihost_demo.py``'s seeded 16 x 64 batch and spec."""
    rng = np.random.default_rng(0)
    B, L = 16, 64
    Q = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    T = np.where(rng.random((B, L)) < 0.15,
                 rng.integers(0, 4, size=(B, L)), Q).astype(np.int32)
    spec = BatchSpec(Lq=L, Lt=L, m=5, sc_mch=2, sc_mis=-4, sc_N=-2, q=4, e=2,
                     zdrop=100, flag=int(Flag.SCORE_ONLY))
    return Q, T, spec


def worker(rank: int, world: int, init: str, backend: str,
           device: str) -> int:
    """One process of the multi-process run: its row block of
    :func:`multihost_batch` on a mesh of ``device`` ("cuda", or "cpu"
    for the plain versions), the records all-gathered over ``backend``
    ("gloo" or "nccl"), the score sum all-reduced; returns the
    checksum."""
    import torch.distributed as dist

    init_distributed(backend, init, rank, world)
    try:
        Q, T, spec = multihost_batch()
        B, L = Q.shape
        i0, i1 = process_rows(B, rank, world)
        Bs = -(-B // world)
        ln = np.full(i1 - i0, L, np.int32)
        out = sharded_extz_scores(make_mesh(devices=[device]), spec,
                                  Q[i0:i1], T[i0:i1], ln, ln, ln)
        rec = np.zeros((Bs, 2), np.int32)
        rec[:i1 - i0, 0] = out["score"]
        rec[:i1 - i0, 1] = 1
        allrec = gather_records(rec)
        gathered = int(allrec[allrec[:, 1] == 1, 0].astype(np.int64).sum())
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
        total = torch.tensor([int(out["score"].astype(np.int64).sum())],
                             dtype=torch.int64, device=dev)
        if world > 1:
            dist.all_reduce(total)
        checksum = int(total.item())
        if checksum != gathered:
            raise AssertionError(f"all-reduce {checksum} != all-gather "
                                 f"{gathered}")
        print(f"OK {rank} {checksum}", flush=True)
        return checksum
    finally:
        if world > 1:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ksw2_tpu_torch.parallel.dryrun")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8)
    a = ap.parse_args(argv)
    if a.rank is not None:
        worker(a.rank, a.world, a.init, a.backend, a.device)
        return 0
    devs = None if a.device == "cuda" else [a.device]
    dryrun_multichip(a.n, devs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
