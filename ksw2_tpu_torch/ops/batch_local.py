"""Batched local alignment (affine Smith-Waterman): the plain version of
kernel 18, its CUDA wrapper and the batched entry point.

Port of ``ksw2_tpu/ops/batch_local.py:local_batch_device`` with the
kernel ``_local_kernel`` (kernel 18, ``csrc/batch_local.cu``, one warp a
pair, counted as ``batch_local_fwd``).  The capability is beyond the
reference, which only declares it (``ksw2.h:92-93``); the NumPy oracle is
:mod:`ksw2_tpu_torch.spec.local`.

The recurrence is in absolute int32 over anti-diagonals ``r = i + j``
(``t`` the target position, ``r - t`` the query position):
``H(r)[t] = max(0, H(r-2)[t-1] + s, E(r)[t], F(r)[t])``,
``E(r)[t] = max(H(r-1)[t-1] - q, E(r-1)[t-1]) - e`` and
``F(r)[t] = max(H(r-1)[t] - q, F(r-1)[t]) - e``, with ``H = 0`` and
``E = F = NEG`` outside a pair's band and at ``t = -1``.  As in the JAX
kernel, ``s`` reads three entries of the matrix: ``mat[0]`` when the raw
symbols are equal, ``mat[1]`` otherwise and ``mat[m*m-1]`` when either is
``m - 1``; on a matrix that is not simple the oracle, which reads the
whole matrix, differs.  Each target position keeps its first strict
best; the result is its maximum ``V``, the smallest ``t`` that reaches
it and that cell's query position, or ``(0, -1, -1)`` when no cell
scores above 0.  Targets take at most 128 positions (the JAX contract,
``batch_local.py:200``); queries any length.  The TPU layout (rows
padded to 8 and diagonals to chunks of 128, the ``RMAX`` split of 512
pairs, the injection plane, lane rolls and butterflies) is not ported:
one launch takes a batch, and each pair runs ``qlen + tlen - 1``
diagonals.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..batch.scheduler import resolve_device
from .strips import _check_cuda

LT_LOCAL = 128            # targets a launch takes (batch_local.py:200)
NEG = -(10 ** 9)          # batch_local.py:_NEG


class LocalParams(NamedTuple):
    """The launch values of kernel 18: the alphabet size and the three
    scores it reads, and the gap costs."""
    m: int
    sc_mch: int
    sc_mis: int
    sc_N: int
    q: int
    e: int


def local_params(m: int, mat, q: int, e: int) -> LocalParams:
    """The kernel's values for the ``m * m`` matrix ``mat`` as
    ``local_batch_device`` of the JAX package reads it: ``mat[0]``,
    ``mat[1]`` and ``mat[m*m-1]``."""
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    return LocalParams(int(m), int(mat[0]), int(mat[1]), int(mat[m * m - 1]),
                       int(q), int(e))


def local_forward_plain(qs, ts, qlen, tlen, prm: LocalParams):
    """Plain version of kernel 18: the recurrence of every pair at once,
    one anti-diagonal a step, on ``qs``'s device.  ``qs`` (B, Lq) and
    ``ts`` (B, Lt) uint8, ``qlen`` and ``tlen`` (B,) int32.  Returns the
    (B, 3) int32 (score, te, qe)."""
    dev = qs.device
    B, Lq = qs.shape
    Lt = ts.shape[1]
    I = torch.int32
    if B == 0 or Lt == 0 or Lq == 0:
        out = torch.tensor([0, -1, -1], dtype=I, device=dev)
        return out.expand(B, 3).contiguous()
    t = torch.arange(Lt, device=dev, dtype=I)[None, :]
    T = ts.to(I)
    tN = T == prm.m - 1
    ql, tl = qlen.to(I)[:, None], tlen.to(I)[:, None]
    zero = torch.zeros((B, Lt), dtype=I, device=dev)
    H1, H2, BH = zero, zero, zero
    E = F = torch.full((B, Lt), NEG, dtype=I, device=dev)
    BR = torch.full((B, Lt), -1, dtype=I, device=dev)
    lead0 = torch.zeros((B, 1), dtype=I, device=dev)
    leadn = torch.full((B, 1), NEG, dtype=I, device=dev)
    for r in range(int((qlen + tlen).max()) - 1):
        qi = (r - t).clamp(0, Lq - 1).long().expand(B, Lt)
        Q = qs.gather(1, qi).to(I)
        band = (t >= (r - ql + 1).clamp(min=0)) & \
            (t <= torch.clamp(tl - 1, max=r))
        s = torch.where(T == Q, prm.sc_mch, prm.sc_mis)
        s = torch.where(tN | (Q == prm.m - 1), prm.sc_N, s)
        h1s = torch.cat([lead0, H1[:, :-1]], 1)
        h2s = torch.cat([lead0, H2[:, :-1]], 1)
        es = torch.cat([leadn, E[:, :-1]], 1)
        En = torch.maximum(h1s - prm.q, es) - prm.e
        Fn = torch.maximum(H1 - prm.q, F) - prm.e
        Hn = torch.maximum(torch.maximum(h2s + s, En), Fn).clamp(min=0)
        H2 = H1
        H1 = torch.where(band, Hn, 0)
        E = torch.where(band, En, NEG)
        F = torch.where(band, Fn, NEG)
        better = H1 > BH
        BH = torch.where(better, H1, BH)
        BR = torch.where(better, r, BR)
    V = BH.max(1).values
    cand = (BH == V[:, None]) & (V[:, None] > 0)
    te = torch.where(cand, t, Lt).min(1).values
    br = BR.gather(1, te.clamp(max=Lt - 1).long()[:, None])[:, 0]
    hit = V > 0
    return torch.stack([V, torch.where(hit, te, -1),
                        torch.where(hit, br - te, -1)], 1).to(I)


def local_forward_cuda(qs, ts, qlen, tlen, prm: LocalParams):
    """Launch kernel 18 (``csrc/batch_local.cu``, one warp a pair) on the
    current stream; the contract of :func:`local_forward_plain` for
    targets of up to 128."""
    B, Lq = qs.shape
    Lt = ts.shape[1]
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, Lt), "target", dev)
    _check_cuda(qlen, torch.int32, (B,), "qlen", dev)
    _check_cuda(tlen, torch.int32, (B,), "tlen", dev)
    if Lt > LT_LOCAL:
        raise ValueError(f"targets of {Lt}: the local kernel takes "
                         f"{LT_LOCAL} or less")
    res = torch.empty((B, 3), dtype=torch.int32, device=dev)
    if B == 0:
        return res
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_local_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            B, Lq, Lt, prm.m, prm.sc_mch, prm.sc_mis, prm.sc_N, prm.q, prm.e,
            res.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_local_fwd")
    LAUNCHES["batch_local_fwd"] += 1
    return res


def local_forward(qs, ts, qlen, tlen, prm: LocalParams):
    """The forward on the tensors' device: kernel 18 for CUDA tensors,
    the plain version for CPU tensors."""
    if qs.is_cuda:
        return local_forward_cuda(qs, ts, qlen, tlen, prm)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return local_forward_plain(qs, ts, qlen, tlen, prm)


def local_batch_device(query: np.ndarray, target: np.ndarray, qlen, tlen,
                       m: int, mat: np.ndarray, q: int, e: int,
                       device="cuda") -> Dict[str, np.ndarray]:
    """Batched local alignment: kernel 18 on a CUDA device, its plain
    version on the CPU.  ``query`` (B, Lq) and ``target`` (B, Lt <= 128)
    symbol arrays, ``qlen`` and ``tlen`` per pair.  Returns
    ``{"score", "te", "qe"}`` int32 arrays (``batch_local.py:184-233``)."""
    query = np.asarray(query)
    target = np.asarray(target)
    B, Lq = query.shape
    Bt, Lt = target.shape
    if B != Bt:
        raise ValueError(f"{B} queries but {Bt} targets")
    if Lt > LT_LOCAL:
        raise ValueError(f"targets of {Lt}: local alignment takes "
                         f"{LT_LOCAL} or less")
    qlen = np.asarray(qlen, np.int32).reshape(B)
    tlen = np.asarray(tlen, np.int32).reshape(B)
    if ((qlen < 0) | (qlen > Lq) | (tlen < 0) | (tlen > Lt)).any():
        raise ValueError("lengths must lie in [0, the arrays' widths]")
    dev = resolve_device(device)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (query.astype(np.uint8), target.astype(np.uint8), qlen, tlen)]
    res = local_forward(*args, local_params(m, mat, q, e)).cpu().numpy()
    return {k: res[:, i].copy() for i, k in enumerate(("score", "te", "qe"))}


__all__ = ["LT_LOCAL", "LocalParams", "local_params", "local_forward_plain",
           "local_forward_cuda", "local_forward", "local_batch_device"]
