"""Scale-out: the pair batch sharded over a mesh of devices.

Port of ``ksw2_tpu/parallel/mesh.py``.  Pairs are independent, so a
batch splits into contiguous row blocks, one a device of the mesh, and
each block runs the port's own route for it: the same prep, kernels and
unpacking as the unsharded route, on its device and its own CUDA stream,
so the blocks of a mesh overlap on the card.  The records come back to
the host in row order; no collective is needed inside a process.

A :class:`Mesh` is a tuple of ``torch.device``s, repeats allowed: a mesh
of ``[cuda:0] * 4`` runs four logical shards of one card on four
streams, a mesh of ``["cpu"] * 8`` runs the kernels' plain versions
shard by shard (the counterpart of the JAX package's virtual CPU mesh),
and a mesh of ``cuda:0 .. cuda:3`` runs one shard a card.  A CUDA device
without a card raises, as ``batch.scheduler.resolve_device`` does.

Each batch is padded to a multiple of the mesh size with pairs of one
base (qlen = tlen = w = 1), as ``mesh.py:562-575`` pads; they run and
are discarded.  Empty pairs and degenerate scoring (``-min_sc > 2 (q +
e)``, the cheaper arm of two-piece costs) give reset records, as the
scheduler's routes give.  The TPU's rules (``Bs * Pp % 8``, the cached
``shard_map`` executables) are not ported.

Across processes (``mesh.py:35-38``, ``tests/multihost_demo.py``),
:func:`init_distributed` starts ``torch.distributed`` with the backend
the caller names (gloo on the CPU and for ranks that share a card, NCCL
for a card a rank), each process scores its own rows
(:func:`process_rows`) on its local mesh, and :func:`gather_records`
all-gathers them.
"""
from __future__ import annotations

import functools
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..batch.scheduler import (_to_host, batch_cigar_launch, batch_records,
                               pad_rows, resolve_device, unpack_batch_cigars)
from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from ..ops.band import W_MAX, band_prep, band_records
from ..ops.batch import LT_CIGARS, LT_SCORES, batch_ineligible_reason
from ..ops.batch_extf import LT_EXTF, extf_records
from ..ops.batch_exts import (batch_exts_ineligible_reason, batch_exts_prep,
                              batch_exts_records, batch_exts_resets)
from ..ops.batch_xla import BatchSpec, any_device_prep, spec_mat
from ..ops.extz import (extz_cigar_launch, extz_prep, extz_records,
                        unpack_extz_cigars)
from ..ops.records import FIELD_ORDER, NFIELDS, degenerate
from ..ops.strips import (canonical_costs, strips_eligible, strips_prep,
                          strips_records)
from ..ops.strips_walker import strips_cigar_launch, unpack_cigars


class Mesh(NamedTuple):
    """The devices a batch shards over, one shard each, and the axis's
    name (``jax.sharding.Mesh`` with one axis)."""
    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices=None,
              axis: str = "data") -> Mesh:
    """A mesh over ``devices`` (repeats allowed), else over the visible
    cards; the first ``n_devices`` of them (``mesh.py:41-45``).  With no
    card and no ``devices`` it raises: a mesh never falls back to the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass "
                               "devices=['cpu'] * n for the plain versions")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"a mesh of {n_devices} from {len(devs)} "
                             "device(s)")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, axis)


# --------------------------------------------------------------------------
# The shard runner


class _Batch(NamedTuple):
    """A batch as the routes' prep functions take it: per-pair symbol
    arrays and int32 lengths, padded to the mesh (``B`` real pairs, the
    empty ones among them replaced by one-base pairs and reset after)."""
    qs: list
    ts: list
    qlen: np.ndarray
    tlen: np.ndarray
    w: np.ndarray
    extra: list           # one item a pair (junction tracks), or []
    B: int
    empty: np.ndarray     # (B,) bool


_ONE = np.zeros(1, np.uint8)


def _unpad(query, target, qlen, tlen):
    """Padded ``(B, L)`` arrays cut to per-pair arrays: the JAX
    signatures' input, for :func:`_batch`."""
    query, target = np.asarray(query), np.asarray(target)
    qlen = np.asarray(qlen, np.int32).reshape(-1)
    tlen = np.asarray(tlen, np.int32).reshape(-1)
    return ([query[k, :max(int(n), 0)] for k, n in enumerate(qlen)],
            [target[k, :max(int(n), 0)] for k, n in enumerate(tlen)])


def _batch(mesh: Mesh, qs, ts, w=None, extra=None) -> _Batch:
    """Per-pair symbol arrays (as uint8) padded to a multiple of the mesh
    size with one-base pairs (qlen = tlen = w = 1, as ``mesh.py:221-232,
    562-575`` pad); ``w`` None, and negative entries, resolve to
    ``max(qlen, tlen)``."""
    qs = [np.asarray(s, np.uint8) for s in qs]
    ts = [np.asarray(s, np.uint8) for s in ts]
    qlen = np.array([len(s) for s in qs], np.int32)
    tlen = np.array([len(s) for s in ts], np.int32)
    B = len(qlen)
    wide = np.maximum(qlen, tlen)
    w = wide if w is None else np.asarray(w, np.int32).reshape(-1)
    w = np.where(w < 0, wide, w).astype(np.int32)
    empty = (qlen <= 0) | (tlen <= 0)
    n = mesh.size
    pad = -(-max(B, 1) // n) * n - B
    qs = [_ONE if empty[k] else s for k, s in enumerate(qs)] + [_ONE] * pad
    ts = [_ONE if empty[k] else s for k, s in enumerate(ts)] + [_ONE] * pad
    one = np.ones(pad, np.int32)

    def fill(a):
        return np.concatenate([np.where(empty, 1, a), one]).astype(np.int32)

    ex = [] if extra is None else [
        None if empty[k] else extra[k] for k in range(B)] + [None] * pad
    return _Batch(qs, ts, fill(qlen), fill(tlen), fill(w), ex, B, empty)


def _blocks(mesh: Mesh, b: _Batch) -> List[_Batch]:
    """The padded batch's contiguous row blocks, one a shard."""
    Bs = len(b.qs) // mesh.size
    out = []
    for k in range(mesh.size):
        s = slice(k * Bs, (k + 1) * Bs)
        out.append(_Batch(b.qs[s], b.ts[s], b.qlen[s], b.tlen[s], b.w[s],
                          b.extra[s], Bs, b.empty[:0]))
    return out


def _run(mesh: Mesh, blocks, submit) -> list:
    """``submit(block, device)`` for each shard, enqueued on the shard's
    device and a stream of its own (a list of ``(finish, device
    tensors)`` pieces; every tensor a piece uses is made, used and freed
    on that stream, so no allocation crosses streams); then every
    shard's device-to-host copies, each shard's event waited on once.
    Returns each shard's ``[finish(*host arrays) for each piece]``, a
    piece's one array where its ``finish`` is None."""
    pending = []
    for dev, blk in zip(mesh.devices, blocks):
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                pieces = submit(blk, dev)
                host, ev = _to_host([t for _, ts in pieces for t in ts],
                                    dev)
        else:
            pieces = submit(blk, dev)
            host, ev = [t for _, ts in pieces for t in ts], None
        pending.append(([(f, len(ts)) for f, ts in pieces], host, ev))
        del pieces
    out = []
    for fins, host, ev in pending:
        if ev is not None:
            ev.synchronize()
        k, res = 0, []
        for finish, n in fins:
            arrs = [t.numpy() for t in host[k:k + n]]
            res.append(arrs[0] if finish is None else finish(*arrs))
            k += n
        out.append(res)
    return out


def _reset_records(n: int) -> np.ndarray:
    out = np.empty((n, NFIELDS), np.int32)
    out[:, (0, 8)] = 0
    out[:, (1, 2, 4, 6)] = -1
    out[:, (3, 5, 7)] = NEG_INF
    return out


def _reset_ez() -> ExtzResult:
    ez = ExtzResult()
    ez.reset()
    return ez


def _guard(mat, q: int, e: int, two: bool = False, q2: int = 0,
           e2: int = 0) -> bool:
    """The reference guard on the costs a route's kernels take: the
    cheaper arm (the canonical costs) of two-piece ones."""
    qc, ec = canonical_costs(q, e, q2, e2)[:2] if two else (q, e)
    return degenerate(mat, qc, ec)


def _records(mesh: Mesh, b: _Batch, submit, reset: bool = False
             ) -> np.ndarray:
    """(B, NFIELDS) records of the batch, ``submit`` making each shard's
    record launches; all reset under ``reset``."""
    if reset or b.B == 0:
        return _reset_records(b.B)
    shards = _run(mesh, _blocks(mesh, b), submit)
    rec = np.concatenate([r for shard in shards for r in shard])[:b.B]
    rec[b.empty] = _reset_records(int(b.empty.sum()))
    return rec


def _aligns(mesh: Mesh, b: _Batch, submit, reset: bool = False
            ) -> List[ExtzResult]:
    """Per-pair ExtzResults with CIGARs, ``submit`` making each shard's
    CIGAR launches; all reset under ``reset``."""
    if reset or b.B == 0:
        return [_reset_ez() for _ in range(b.B)]
    shards = _run(mesh, _blocks(mesh, b), submit)
    out = [ez for shard in shards for ezs in shard for ez in ezs][:b.B]
    for k in np.flatnonzero(b.empty):
        out[k] = _reset_ez()
    return out


def _fields(rec: np.ndarray, keys=FIELD_ORDER) -> dict:
    return {k: rec[:, FIELD_ORDER.index(k)].copy() for k in keys}


def _score_submit(prep, run):
    """A shard's record launches: ``prep(block)``'s launches, each run by
    ``run(launch, device)``."""
    def submit(blk, dev):
        return [(None, (run(ln, dev),)) for ln in prep(blk)]
    return submit


# --------------------------------------------------------------------------
# The sharded routes


def sharded_extz_scores(mesh: Mesh, spec: BatchSpec, query, target, qlen,
                        tlen, w):
    """The any-device scorer (kernel 12 in score form, ``ops/
    batch_xla.py``) with the batch sharded over the mesh
    (``mesh.py:98``).  Returns the field dict of ``(B,)`` arrays and
    ``batch_max``, the largest ``max`` of the batch (the JAX package's
    ``pmax`` over the mesh)."""
    mat = spec_mat(spec)
    b = _batch(mesh, *_unpad(query, target, qlen, tlen), w)
    rec = _records(mesh, b, _score_submit(
        lambda blk: any_device_prep(blk.qs, blk.ts, blk.qlen, blk.tlen,
                                    blk.w, spec.m, mat, spec.q, spec.e,
                                    spec.zdrop, spec.flag), extz_records),
        _guard(mat, spec.q, spec.e))
    out = _fields(rec)
    out["batch_max"] = int(rec[:, 0].max()) if b.B else 0
    return out


def _batched_scores(mesh, query, target, qlen, tlen, w, m, mat, q, e,
                    zdrop, two=False, q2=0, e2=0):
    """Kernel E (E2 with ``two``) over the mesh: the batched route's
    launches (``band_prep`` with ``batch_forward_cuda``)."""
    flag = int(Flag.SCORE_ONLY)
    mat = np.asarray(mat, np.int8).reshape(-1)
    b = _batch(mesh, *_unpad(query, target, qlen, tlen), w)
    if b.B and int(b.tlen.max()) > LT_SCORES:
        raise ValueError(f"the batched route scores targets of {LT_SCORES} "
                         "or less")
    rec = _records(mesh, b, _score_submit(
        lambda blk: band_prep(blk.qs, blk.ts, blk.qlen, blk.tlen, blk.w, m,
                              mat, q, e, zdrop, flag, two=two, q2=q2, e2=e2),
        batch_records), _guard(mat, q, e, two, q2, e2))
    return _fields(rec)


def sharded_extz_scores_pallas(mesh: Mesh, query, target, qlen, tlen, w,
                               m, mat, q, e, zdrop=-1):
    """The batched one-piece scorer (kernel E) with the batch sharded
    over the mesh (``mesh.py:116``)."""
    return _batched_scores(mesh, query, target, qlen, tlen, w, m, mat, q, e,
                           zdrop)


def sharded_extd_scores_pallas(mesh: Mesh, query, target, qlen, tlen, w,
                               m, mat, q, e, q2, e2, zdrop=-1):
    """The batched two-piece scorer (kernel E2) with the batch sharded
    over the mesh (``mesh.py:152``); PRE-swap costs."""
    return _batched_scores(mesh, query, target, qlen, tlen, w, m, mat, q, e,
                           zdrop, True, q2, e2)


def sharded_band_scores(mesh: Mesh, query, target, qlen, tlen, w, m, mat,
                        q, e, zdrop=-1):
    """The band scorer (kernel 9) with the batch sharded over the mesh
    (``mesh.py:183``); bands ``1 <= w <= 1472``."""
    mat = np.asarray(mat, np.int8).reshape(-1)
    b = _batch(mesh, *_unpad(query, target, qlen, tlen), w)
    if b.B and (int(b.w.min()) < 1 or int(b.w.max()) > W_MAX):
        raise ValueError(f"the band route takes bands 1 <= w <= {W_MAX}")
    rec = _records(mesh, b, _score_submit(
        lambda blk: band_prep(blk.qs, blk.ts, blk.qlen, blk.tlen, blk.w, m,
                              mat, q, e, zdrop, int(Flag.SCORE_ONLY)),
        band_records), _guard(mat, q, e))
    return _fields(rec)


def sharded_exts_scores_pallas(mesh: Mesh, query, target, qlen, tlen, m, mat,
                               q, e, q2, noncan, zdrop=-1, junc_bonus=0,
                               flag=None, junc=None):
    """The batched splice scorer (kernel 6) with the batch sharded over
    the mesh (``mesh.py:239``).  ``junc`` gives a junction track (or
    None) a pair, as ``Aligner.extend_batch``'s ``juncs``."""
    fl = int(Flag.SCORE_ONLY if flag is None else flag) | int(Flag.SCORE_ONLY)
    mat = np.asarray(mat, np.int8).reshape(-1)
    b = _batch(mesh, *_unpad(query, target, qlen, tlen), extra=junc)
    if b.B:
        why = batch_exts_ineligible_reason(int(b.tlen.max()), fl)
        if why is not None:
            raise ValueError(why)
    rec = _records(mesh, b, _score_submit(
        lambda blk: batch_exts_prep(
            blk.qs, blk.ts, blk.qlen, blk.tlen, m, mat, q, e, q2, noncan,
            zdrop, fl, blk.extra or None, junc_bonus, cig=False),
        batch_exts_records), batch_exts_resets(m, mat, q, e, q2))
    return _fields(rec)


def sharded_extf_scores_pallas(mesh: Mesh, query, target, qlen, tlen, w,
                               mch, mis, e, xdrop=-1):
    """The batched linear-gap scorer (kernel 7) with the batch sharded
    over the mesh (``mesh.py:292``): max, max_t, max_q, score and
    zdropped, the fields extf2 defines."""
    b = _batch(mesh, *_unpad(query, target, qlen, tlen), w)
    if b.B and int(b.tlen.max()) > LT_EXTF:
        raise ValueError(f"the batched extf route takes targets of "
                         f"{LT_EXTF} or less")

    def submit(blk, dev):
        return [(None, (extf_records(
            pad_rows(blk.qs), pad_rows(blk.ts), blk.qlen, blk.tlen, blk.w,
            mch, mis, e, xdrop, dev),))]

    rec = _records(mesh, b, submit)
    return _fields(rec, ("max", "max_t", "max_q", "score", "zdropped"))


def sharded_strips_records(mesh: Mesh, query, target, qlen, tlen, m, mat,
                           q: int, e: int, zdrop: int = -1, flag=None,
                           two: bool = False, q2: int = 0,
                           e2: int = 0) -> np.ndarray:
    """The strips route's records (kernel A and the replay) with the
    batch sharded over the mesh (``mesh.py:335``): the engine the local
    scheduler picks for effectively-unbanded score buckets.  Returns a
    (B, NFIELDS) int32 array; callers check eligibility."""
    flag = int(Flag.SCORE_ONLY if flag is None else flag)
    mat = np.asarray(mat, np.int8).reshape(-1)
    b = _batch(mesh, *_unpad(query, target, qlen, tlen))
    return _records(mesh, b, _score_submit(
        lambda blk: strips_prep(blk.qs, blk.ts, blk.qlen, blk.tlen, m, mat,
                                q, e, zdrop, flag, two=two, q2=q2, e2=e2),
        strips_records), _guard(mat, q, e, two, q2, e2))


def sharded_strips_cigar(mesh: Mesh, query, target, qlen, tlen, m, mat,
                         q: int, e: int, zdrop: int = -1,
                         end_bonus: int = 0, flag=None, two: bool = False,
                         q2: int = 0, e2: int = 0) -> List[ExtzResult]:
    """The strips CIGAR route (kernels A and B, ``finish_runs_batch``,
    ``unpack_cigars``) with the batch sharded over the mesh
    (``mesh.py:434``): per-pair ExtzResults with CIGARs, equal to the
    local route's.  Callers check eligibility."""
    flag = Flag(int(Flag.NONE if flag is None else flag))
    mat = np.asarray(mat, np.int8).reshape(-1)
    b = _batch(mesh, *_unpad(query, target, qlen, tlen))

    def submit(blk, dev):
        out = []
        for ln in strips_prep(blk.qs, blk.ts, blk.qlen, blk.tlen, m, mat, q,
                              e, zdrop, flag, cig=True, two=two, q2=q2,
                              e2=e2):
            # the launch's params carry the POST-swap costs
            out.append((functools.partial(
                unpack_cigars, mat=mat, q=ln.prm.q, e=ln.prm.e,
                end_bonus=end_bonus, flag=flag),
                strips_cigar_launch(ln, end_bonus, dev)))
        return out

    return _aligns(mesh, b, submit, _guard(mat, q, e, two, q2, e2))


def make_sharded_run_fn(mesh: Mesh):
    """The scheduler hook ``run_fn(spec, Q, T, qlen, tlen, w)`` sharded
    over the mesh (``mesh.py:530``): the strips route
    (:func:`sharded_strips_records`) for effectively-unbanded buckets of a
    simple matrix, the any-device scorer (:func:`sharded_extz_scores`)
    otherwise.  Plug into ``align_batch_scores(..., run_fn=...)`` or
    ``Aligner.extend_batch(..., run_fn=...)``."""
    def run_fn(spec, Q, T, qlen, tlen, w):
        flag = Flag(int(spec.flag))
        # sc_N == -e pins that the spec came from a simple matrix (last
        # row / column zero), which is what spec_mat rebuilds
        if not flag & Flag.GENERIC_SC and spec.sc_N == -spec.e:
            qlen_h, tlen_h, w_h = (np.asarray(a) for a in (qlen, tlen, w))
            mat = spec_mat(spec)
            if strips_eligible(qlen_h, tlen_h, w_h, flag, spec.m, mat,
                               spec.zdrop, spec.q, spec.e):
                rec = sharded_strips_records(
                    mesh, Q, T, qlen_h, tlen_h, spec.m, mat, spec.q, spec.e,
                    zdrop=spec.zdrop, flag=flag)
                return _fields(rec)
        out = sharded_extz_scores(mesh, spec, Q, T, qlen, tlen, w)
        del out["batch_max"]
        return out

    return run_fn


def sharded_extz_align(mesh: Mesh, query, target, qlen, tlen, m, mat,
                       q: int, e: int, w=None, zdrop: int = -1,
                       end_bonus: int = 0, flag=None) -> List[ExtzResult]:
    """One-piece extension with CIGARs, the batch sharded over the mesh
    (``mesh.py:595``): per shard the batched CIGAR route (kernel E's
    ``CIG`` form and walker D, CIGARs turned to =/X under EQX) on targets
    of 1536 or less.  A batch that route refuses (EXTZ_ONLY) takes the
    single-pair engine (kernels 12 and 17), as the port's scheduler does,
    on the same devices."""
    if np.asarray(target).shape[1] > LT_CIGARS:
        raise ValueError(f"sharded CIGAR batches take targets of "
                         f"{LT_CIGARS} or less")
    return extz_align_pairs(mesh, *_unpad(query, target, qlen, tlen), m,
                            mat, q, e, w, zdrop, end_bonus, flag)


def extz_align_pairs(mesh: Mesh, qs, ts, m, mat, q: int, e: int, w=None,
                     zdrop: int = -1, end_bonus: int = 0, flag=None
                     ) -> List[ExtzResult]:
    """:func:`sharded_extz_align` on per-pair uint8 arrays (targets of
    1536 or less), the entry ``Aligner.extend_batch(mesh=)`` calls."""
    flag = Flag(int(Flag.NONE if flag is None else flag))
    if flag & Flag.SCORE_ONLY:
        raise ValueError("use sharded_extz_scores for score-only batches")
    mat = np.asarray(mat, np.int8).reshape(-1)
    b = _batch(mesh, qs, ts, w)
    batched = b.B and batch_ineligible_reason(
        int(b.tlen.max()), b.qlen, b.tlen, mat, flag, zdrop,
        cigar=True) is None

    def submit(blk, dev):
        out = []
        if batched:
            for ln in band_prep(blk.qs, blk.ts, blk.qlen, blk.tlen, blk.w, m,
                                mat, q, e, zdrop, flag, cig=True):
                out.append((functools.partial(unpack_batch_cigars, ln,
                                              mat=mat, end_bonus=end_bonus),
                            batch_cigar_launch(ln, end_bonus, dev)))
        else:
            for ln in extz_prep(blk.qs, blk.ts, blk.qlen, blk.tlen, blk.w, m,
                                mat, q, e, zdrop, flag, cig=True):
                out.append((functools.partial(unpack_extz_cigars, ln,
                                              mat=mat, end_bonus=end_bonus),
                            extz_cigar_launch(ln, end_bonus, dev)))
        return out

    return _aligns(mesh, b, submit, _guard(mat, q, e))


def _scaling_batch(B: int, L: int):
    rng = np.random.default_rng(0)
    Q = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    T = np.where(rng.random((B, L)) < 0.1,
                 rng.integers(0, 4, size=(B, L)), Q).astype(np.int32)
    return Q, T, np.full(B, L, np.int32)


def scaling_efficiency(n_devices: int, B_per_dev: int = 64, L: int = 128,
                       reps: int = 3, devices=None):
    """Pairs/s of the sharded any-device scorer at 1 and ``n_devices``
    shards (``mesh.py:686``): ``(t1, tn, t1 / (tn * n))``, the best of
    ``reps`` host-clock walls after one warm-up call each.  The shards
    cycle over ``devices`` (default: the visible cards), so on one card
    they are logical shards sharing it and the ratio is a lower bound;
    the score sums must agree."""
    base = list(devices) if devices is not None else None
    if base is None:
        base = list(make_mesh().devices)
    B = B_per_dev * n_devices
    Q, T, ql = _scaling_batch(B, L)
    spec = BatchSpec(Lq=L, Lt=L, m=5, sc_mch=2, sc_mis=-4, sc_N=-2, q=4, e=2,
                     zdrop=200, flag=int(Flag.SCORE_ONLY))

    def timed(mesh):
        out = sharded_extz_scores(mesh, spec, Q, T, ql, ql, ql)
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sharded_extz_scores(mesh, spec, Q, T, ql, ql, ql)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best, int(out["max"].sum())

    t1, sum1 = timed(make_mesh(devices=base[:1]))
    tn, sumn = timed(make_mesh(devices=[base[i % len(base)]
                                        for i in range(n_devices)]))
    if sum1 != sumn:
        raise RuntimeError(f"sharded scores differ: {sum1} != {sumn}")
    return t1, tn, t1 / (tn * n_devices)


# --------------------------------------------------------------------------
# Across processes


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Start ``torch.distributed`` for ``world_size`` processes with the
    named ``backend`` ("gloo" on the CPU and for processes that share a
    card, "nccl" for a card each) at ``init_method`` (``tcp://host:port``;
    nothing on the machine names a cluster).  A no-op for a single
    process, as ``mesh.py:35-38``; returns whether it started one."""
    if world_size is None or world_size <= 1:
        return False
    import torch.distributed as dist

    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)
    return True


def process_rows(B: int, rank: int, world: int) -> Tuple[int, int]:
    """This process's contiguous row block ``[i0, i1)`` of a batch of
    ``B`` rows over ``world`` processes (``ceil(B / world)`` rows each)."""
    Bs = -(-B // world)
    return min(rank * Bs, B), min((rank + 1) * Bs, B)


def gather_records(local: np.ndarray) -> np.ndarray:
    """Every process's ``(b, k)`` int32 rows, all-gathered in rank order
    (equal ``b`` on every process: pad with :func:`process_rows`'s block
    size).  The tensors travel on the CPU under gloo and on the current
    card under NCCL; without a process group the rows come back."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return local
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(local, np.int32)).to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


__all__ = ["Mesh", "make_mesh", "sharded_extz_scores",
           "sharded_extz_scores_pallas", "sharded_extd_scores_pallas",
           "sharded_band_scores", "sharded_exts_scores_pallas",
           "sharded_extf_scores_pallas", "sharded_strips_records",
           "sharded_strips_cigar", "make_sharded_run_fn",
           "sharded_extz_align", "extz_align_pairs", "scaling_efficiency",
           "init_distributed", "process_rows", "gather_records"]
