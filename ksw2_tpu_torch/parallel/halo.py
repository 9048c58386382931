"""One alignment split over the mesh: the target-sharded halo wavefront.

Port of ``ksw2_tpu/parallel/halo.py``.  The batch routes shard pairs;
this module shards ONE pair's DP matrix: the target axis is cut into
contiguous blocks of ``C`` positions, one a device of a
:class:`~ksw2_tpu_torch.parallel.mesh.Mesh`, and the anti-diagonal
recurrence of ``ksw_extz2_sse`` (ksw2_extz2_sse.c:150-286) runs as a
pipeline over blocks of ``K`` diagonals.  A cell (r, t) reads only
position t - 1 of diagonal r - 1 besides its own, so one position a
diagonal crosses a shard edge, left to right: shard d runs diagonal
block b once shard d - 1 has run it.  Each round a shard advances ``K``
diagonals over its positions and hands the x, v and H of its last
position, one entry a diagonal, on to the next shard: the halo package.
The pipeline fills and drains in ``D - 1`` rounds.

A round is one launch of ``csrc/halo_fwd.cu`` (:func:`halo_round`; its
plain PyTorch twin :func:`halo_round_plain` runs CPU tensors), one block
over the shard's positions, the state of each position (u, v, x, y, the
score byte, H, its best H, that H's diagonal and the query-end capture)
in global memory between rounds.  The host enqueues every round:
shard d's round on its own device and stream after an event of shard d -
1's round before it, the package handed on by ``tensor.to(device,
non_blocking=True)`` (a peer copy across cards, the same memory on one
card, where each round's package has its own slot).  The deferred max
(the SSE merge order's tie key) is then taken on the host from the
gathered planes (:func:`_finalize`, as ``halo.py:270-316``).

Scope, as in the JAX package: one-piece extz2, score-only, exact max, a
simple match / mismatch / wildcard matrix, no Z-drop (the drop test reads
the max over the whole diagonal, which would serialise the pipeline; the
batch routes shard droppable extensions).  The arithmetic is the
reference's on wrapping int8 deltas over the 16-rounded band, with its
stale bytes, its st - 1 edge override and its band bounds
(ksw2_extz2_sse.c:107-116): kernel 12's cell (``csrc/extz_fwd.cu``), not
the TPU's biased int32 lanes.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from ..ops.batch_extf import w8
from ..ops.records import degenerate
from ..ops.strips import _check_cuda, round_up
from .mesh import Mesh

NPLANES = 9                # U, V, X, Y, S, H, HM, RD, MQ
PU, PV, PX, PY, PS, PH, PHM, PRD, PMQ = range(NPLANES)
MAX_THREADS = 1024         # the kernel's block


class HaloParams(NamedTuple):
    """The pair's scalars a round reads."""
    qlen: int
    tlen: int
    w: int          # resolved (>= 0)
    q: int
    e: int
    mch: int        # mat[0]
    mis: int        # mat[1]
    sc_N: int       # the wildcard's score
    m: int


def _band(r: int, prm: HaloParams):
    """Diagonal r's band [st0, en0] (ksw2_extz2_sse.c:107-116) and its
    16-rounded bounds [st, en]."""
    st0 = max(0, r + 1 - prm.qlen, (r + 1 - prm.w) >> 1)
    en0 = min(prm.tlen - 1, r, (r + prm.w) >> 1)
    return st0, en0, st0 & ~15, en0 | 15


def _prev_ok(r: int, st: int, prm: HaloParams) -> bool:
    """Whether position st - 1 was in diagonal r - 1's rounded band; when
    it was not, the cell at st reads the reference's edge values
    (``extz_fwd.cu``'s ``prevok``)."""
    if r == 0 or st == 0:
        return False
    _, _, pst, pen = _band(r - 1, prm)
    return pst <= st - 1 <= pen


def rows_limit(qlen: int, tlen: int, w: int) -> int:
    """The first diagonal past the computed ones (``halo.py:185-186``,
    ``ops/bands.py:first_empty_diag``)."""
    ndc = qlen + tlen - 1
    return min(ndc, 2 * qlen + w - 1, 2 * tlen + w - 1, 1 if w == 0 else ndc)


def init_state(C: int, device) -> torch.Tensor:
    """A shard's (NPLANES, C) int32 state before diagonal 0: zero deltas
    and score bytes, H, its best and the query-end capture NEG_INF."""
    st = torch.zeros((NPLANES, C), dtype=torch.int32, device=device)
    st[[PH, PHM, PMQ]] = NEG_INF
    return st


def halo_round_plain(qs, ts, st, pin, pout, prm: HaloParams, t0: int,
                     r0: int, nk: int) -> None:
    """Diagonals ``r0 .. r0 + nk - 1`` of one shard, in place: ``qs`` the
    whole query (uint8), ``ts`` the shard's target positions ``t0 .. t0 +
    C - 1`` (uint8, zero past tlen), ``st`` its (NPLANES, C) int32 state,
    ``pin`` the (>= nk, 3) package in (x, v, H of position t0 - 1 after
    diagonal r - 1 at row r - r0; None on the first shard) and ``pout``
    the package out (the same of position t0 + C - 1).  Each diagonal
    updates the positions of its rounded band [st, en], and the score
    bytes up to the reference's fill end, with ``csrc/halo_fwd.cu``'s
    arithmetic."""
    C = st.shape[1]
    dev = st.device
    U, V, X, Y, S, H, HM, RD, MQ = st
    qe = prm.q + prm.e
    clamp = (prm.mch + 2 * qe) & 255
    qlen = prm.qlen
    for k in range(nk):
        r = r0 + k
        pout[k] = torch.stack((X[C - 1], V[C - 1], H[C - 1]))
        st0, en0, stb, enb = _band(r, prm)
        hi_s = st0 + ((en0 - st0) & ~15) + 15
        lo = max(stb, t0) - t0
        hi = min(enb, t0 + C - 1) - t0
        hi2 = min(max(enb, hi_s), t0 + C - 1) - t0
        if lo > hi2:
            continue
        colv = prm.q if r > 0 else 0
        prevok = _prev_ok(r, stb, prm)
        # position t - 1's old x, v, H: lo - 1's below the band, the
        # package at the shard's edge, unused at t = 0
        if lo > 0:
            b = st[[PX, PV, PH], lo - 1]
        elif pin is not None:
            b = pin[k].to(torch.int32)
        else:
            b = torch.tensor([0, 0, NEG_INF], dtype=torch.int32, device=dev)
        sl = slice(lo, hi2 + 1)
        Xm = torch.cat((b[0:1], X[lo:hi2]))
        Vm = torch.cat((b[1:2], V[lo:hi2]))
        Hm = torch.cat((b[2:3], H[lo:hi2]))
        t = torch.arange(lo + t0, hi2 + 1 + t0, device=dev, dtype=torch.int32)
        inb = t <= enb
        edge = (t == stb) & (not prevok)
        X1 = torch.where(edge, 0, Xm)
        V1 = torch.where(edge, colv if stb == 0 else 0, Vm)
        Uc = torch.where(t == r, colv, U[sl])
        Yc = torch.where(t == r, 0, Y[sl])
        qi = r - t
        Qb = torch.where(qi >= 0, qs[qi.clamp(0, qlen - 1).long()].int(), 0)
        Tb = ts[sl].int()
        sv = torch.where(Tb == Qb, prm.mch, prm.mis)
        sv = torch.where((Tb == prm.m - 1) | (Qb == prm.m - 1), prm.sc_N, sv)
        Sv = torch.where((t >= st0) & (t <= hi_s), w8(sv), S[sl])
        a = w8(X1 + V1)
        bb = w8(Yc + Uc)
        z = torch.maximum(w8(Sv + 2 * qe), a)
        z = torch.maximum(z & 255, bb & 255)
        z = w8(torch.minimum(z, torch.full_like(z, clamp)))
        un = w8(z - V1)
        vn = w8(z - Uc)
        z2 = w8(z - prm.q)
        a = w8(a - z2)
        bb = w8(bb - z2)
        Hold = H[sl].clone()
        S[sl] = Sv
        U[sl] = torch.where(inb, un, U[sl])
        V[sl] = torch.where(inb, vn, V[sl])
        X[sl] = torch.where(inb, a.clamp(min=0), X[sl])
        Y[sl] = torch.where(inb, bb.clamp(min=0), Y[sl])
        if r == 0:
            h = (vn & 255) - 2 * qe
        else:
            h = torch.where((t < en0) | (en0 == 0), Hold + (vn & 255) - qe,
                            Hm + (un & 255) - qe)
        inh = (t >= st0) & (t <= en0)
        Hn = torch.where(inh, h, Hold)
        H[sl] = Hn
        better = inh & (Hn > HM[sl])
        HM[sl] = torch.where(better, Hn, HM[sl])
        RD[sl] = torch.where(better, r, RD[sl])
        if r - st0 == qlen - 1 and lo <= st0 - t0 <= hi2:
            MQ[st0 - t0] = Hn[st0 - t0 - lo]


def halo_round_cuda(qs, ts, st, pin, pout, prm: HaloParams, t0: int,
                    r0: int, nk: int) -> None:
    """:func:`halo_round_plain` as one launch of ``csrc/halo_fwd.cu`` (one
    block of ``min(C, 1024)`` threads), enqueued on the current stream."""
    dev = st.device
    C = st.shape[1]
    _check_cuda(qs, torch.uint8, (prm.qlen,), "qs", dev)
    _check_cuda(ts, torch.uint8, (C,), "ts", dev)
    _check_cuda(st, torch.int32, (NPLANES, C), "state", dev)
    _check_cuda(pout, torch.int32, (pout.shape[0], 3), "pout", dev)
    if pout.shape[0] < nk or C % 32:
        raise ValueError(f"halo round: {nk} diagonals, a package of "
                         f"{pout.shape[0]}, {C} positions")
    if pin is not None:
        _check_cuda(pin, torch.int32, (pin.shape[0], 3), "pin", dev)
        if pin.shape[0] < nk:
            raise ValueError("halo round: the package in is too short")
    err = library().ksw2t_halo_round(
        qs.data_ptr(), ts.data_ptr(), st.data_ptr(),
        0 if pin is None else pin.data_ptr(), pout.data_ptr(), prm.qlen,
        prm.tlen, prm.w, t0, C, r0, nk, prm.q, prm.e, prm.mch, prm.mis,
        prm.sc_N, prm.m, min(C, MAX_THREADS),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "halo_fwd")
    LAUNCHES["halo_fwd"] += 1


def halo_round(qs, ts, st, pin, pout, prm: HaloParams, t0: int, r0: int,
               nk: int) -> None:
    """One round on the tensors' device: the kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    if st.is_cuda:
        return halo_round_cuda(qs, ts, st, pin, pout, prm, t0, r0, nk)
    if st.device.type != "cpu":
        raise ValueError(f"unsupported device {st.device}")
    return halo_round_plain(qs, ts, st, pin, pout, prm, t0, r0, nk)


class HaloRun(NamedTuple):
    """A pipeline's result on the host: every shard's final state and
    every package it sent."""
    states: List[np.ndarray]      # (NPLANES, C) a shard
    packages: List[np.ndarray]    # (n_blocks, K, 3) a shard


def halo_pipeline(mesh: Mesh, query, target, prm: HaloParams, K: int,
                  round_fn=halo_round) -> HaloRun:
    """Run every round of the pair over the mesh (``halo.py:165-206``):
    ``n_blocks + D - 1`` rounds, shard d's round s on block s - d.  The
    target pads to ``round_up(tlen, 128 D)`` positions, ``C`` a shard; a
    shard past the target runs and changes nothing.  ``round_fn`` is
    :func:`halo_round` (the plain twin, :func:`halo_round_plain`, on the
    same tensors to hold the kernel to it)."""
    D = mesh.size
    TV = round_up(max(prm.tlen, 1), 128 * D)
    C = TV // D
    rlim = rows_limit(prm.qlen, prm.tlen, prm.w)
    n_blocks = -(-rlim // K)
    tpad = np.zeros(TV, np.uint8)
    tpad[:prm.tlen] = np.asarray(target, np.uint8)
    qpad = np.asarray(query, np.uint8)
    shards = []
    for d, dev in enumerate(mesh.devices):
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
        with _on(dev, stream):
            shards.append((
                dev, stream, torch.from_numpy(qpad).to(dev),
                torch.from_numpy(tpad[d * C:(d + 1) * C].copy()).to(dev),
                init_state(C, dev),
                torch.zeros((n_blocks, K, 3), dtype=torch.int32,
                            device=dev)))
    events = {}
    for s in range(n_blocks + D - 1):
        for d, (dev, stream, qs, ts, st, out) in enumerate(shards):
            blk = s - d
            if not 0 <= blk < n_blocks:
                continue
            r0 = blk * K
            with _on(dev, stream):
                pin = None
                if d > 0:
                    if stream is not None:
                        stream.wait_event(events.pop((d - 1, blk)))
                    pin = shards[d - 1][5][blk].to(dev, non_blocking=True)
                round_fn(qs, ts, st, pin, out[blk], prm, d * C, r0,
                         min(K, rlim - r0))
                if stream is not None and d + 1 < D:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    events[(d, blk)] = ev
    # the gather below waits for every shard's rounds (the tensors were
    # made on the shards' streams and cross them: nothing is freed first)
    for dev, stream, *_ in shards:
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    return HaloRun([sh[4].cpu().numpy() for sh in shards],
                   [sh[5].cpu().numpy() for sh in shards])


def _on(dev, stream):
    """The shard's device and stream as the current ones (nothing on the
    CPU)."""
    stack = contextlib.ExitStack()
    if stream is not None:
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(stream))
    return stack


def halo_params(query, target, m: int, mat, q: int, e: int,
                w: int = -1) -> HaloParams:
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    qlen, tlen = len(query), len(target)
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    return HaloParams(qlen=qlen, tlen=tlen,
                      w=max(qlen, tlen) if w < 0 else int(w), q=int(q),
                      e=int(e), mch=int(mat[0]), mis=int(mat[1]), sc_N=sc_N,
                      m=int(m))


def halo_extz_score(mesh: Mesh, query: np.ndarray, target: np.ndarray,
                    m: int, mat: np.ndarray, q: int, e: int, w: int = -1,
                    flag: Flag | int = Flag.SCORE_ONLY,
                    block_diagonals: int = 256) -> ExtzResult:
    """Score ONE extension pair with its target axis sharded over
    ``mesh`` (``halo.py:209``): the exact ``ksw_extz2_sse`` score-only
    fields (max / max_t / max_q, mqe / mqe_t, mte / mte_q, score) with no
    Z-drop; ``block_diagonals`` (K) diagonals a round."""
    flag = Flag(int(flag))
    if not (flag & Flag.SCORE_ONLY):
        raise ValueError("halo engine is score-only")
    if flag & (Flag.APPROX_MAX | Flag.GENERIC_SC):
        raise ValueError("halo engine: exact max, fixed 5x5 scoring only")
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    if degenerate(mat, q, e):
        return ez
    prm = halo_params(query, target, m, mat, q, e, w)
    run = halo_pipeline(mesh, query, target, prm, int(block_diagonals))
    H, HM, RD, MQ = (np.concatenate([s[p] for s in run.states])
                     for p in (PH, PHM, PRD, PMQ))
    return _finalize(ez, H, HM, RD, MQ, qlen, tlen, prm.w)


def _finalize(ez, H, HM, RD, MQ, qlen, tlen, w):
    """The deferred max with the SSE scan's tie order, mqe, mte and the
    score, from the gathered planes (a copy of ``halo.py:270-316``)."""
    ndc = qlen + tlen - 1
    rlim = rows_limit(qlen, tlen, w)
    lanes = np.arange(len(HM), dtype=np.int64)

    V = int(HM.max())
    if V > 0:
        cand = HM == V
        rstar = int(RD[cand].min())
        st0s = max(0, rstar + 1 - qlen, (rstar + 1 - w) >> 1)
        en0s = min(tlen - 1, rstar, (rstar + w) >> 1)
        first = cand & (RD == rstar)
        en0_hit = bool(first[en0s]) if 0 <= en0s < len(first) else False
        if en0_hit or rstar == 0:
            max_t = 0 if rstar == 0 else en0s
        else:
            en1 = st0s + (en0s - st0s) // 4 * 4
            cls = (lanes - st0s) & 3
            key = np.where(lanes < en1, cls * (1 << 26) + lanes,
                           (1 << 28) + lanes)
            max_t = int(key[first].min() & ((1 << 26) - 1))
        ez.max, ez.max_t, ez.max_q = V, max_t, rstar - max_t
    else:
        ez.max, ez.max_t, ez.max_q = 0, -1, -1

    mqe = int(MQ.max())
    if mqe > NEG_INF:
        ez.mqe = mqe
        ez.mqe_t = int(lanes[MQ == mqe].min())
    corner = tlen - 1
    mte = int(HM[corner])
    if mte > NEG_INF:
        en_c = ((tlen - 1 + 16) // 16) * 16 - 1
        ez.mte = mte
        ez.mte_q = int(RD[corner]) - en_c

    fin_en0 = min(tlen - 1, ndc - 1, (ndc - 1 + w) >> 1)
    if rlim == ndc and fin_en0 == tlen - 1:
        ez.score = int(H[corner])
    ez.zdropped = rlim < ndc
    return ez


__all__ = ["HaloParams", "HaloRun", "NPLANES", "halo_params", "rows_limit",
           "init_state", "halo_round", "halo_round_plain", "halo_round_cuda",
           "halo_pipeline", "halo_extz_score"]
