"""Linear-gap extension (extf2): the plain version of kernels 7 and 15,
the batched form's CUDA wrapper and the batched entry point.

Port of ``ksw2_tpu/ops/batch_pallas.py:extf_batch_device`` with the
kernel ``wavefront_batch_extf.py:_batch_extf_kernel`` (kernel 7,
``csrc/batch_extf_fwd.cu`` in its batched form, one warp a pair, counted
as ``batch_extf_fwd``: a register form while :func:`extf_form` holds the
launch, a strip form, :func:`batch_extf_strip_cuda`, past it).  The
single-pair kernel 15 (``csrc/lg_fwd.cu``, tiles over many blocks) and
``extf2_device`` are in :mod:`ops.extf`.

Both kernels compute ``spec/diagdiff.py:extf2`` (``ksw2_extf2_sse.c``),
and :func:`extf_forward_plain`, vectorised over pairs, is the plain
version of both: the u/v deltas in wrapping int8 over the 16-rounded
band, the score bytes of raw symbol equality (N matches N, as in the
reference) filled in 16-byte blocks from st0, the O(1) approximate H0
walk with the X-drop break, and ``zdropped`` set on an X-drop and on a
band-empty stop ("not completed", ``ksw2_extf2_sse.c:49``).  A launch
takes (B, Lq) / (B, Lt) uint8 sequences and int32 qlen, tlen and w
(resolved, >= 0) and gives the (B, 9) int32 records of
:mod:`ops.records`.  ``mis`` is canonicalised to <= 0 by the entry points
(``ops/extf.py:44`` of the JAX package).  The TPU layout (P sublane rows
a pair, the query injection plane, the butterfly sums and the ``RMAX``
launch caps) is not ported.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import NEG_INF
from .bands import first_empty_diag
from .batch import WINDOW_SLACK, strip_len
from .strips import SMEM_MAX, _check_cuda

LT_EXTF = 1536            # the batched engines' targets (batch_pallas.py)
MAX_WARPS = 8             # pairs (warps) a block of kernel 7
REG_W = 1024              # the register form's window, target positions


def w8(x: torch.Tensor) -> torch.Tensor:
    """Wrap to a signed byte (C's int8 conversion)."""
    return ((x + 128) & 255) - 128


def canonical_mis(mis: int) -> int:
    """``mis`` as the engines take it: <= 0 (``ops/extf.py:44``)."""
    return int(mis) if int(mis) < 0 else -int(mis)


def pack_pairs(pairs, w, device):
    """(query, target) nt4 arrays and resolved bands -> the launch tensors
    (qs (B, Lq) uint8, ts (B, Lt) uint8, qlen, tlen, w (B,) int32) on
    ``device``."""
    B = len(pairs)
    Lq = max([len(q) for q, _ in pairs] + [1])
    Lt = max([len(t) for _, t in pairs] + [1])
    qs = np.zeros((B, Lq), np.uint8)
    ts = np.zeros((B, Lt), np.uint8)
    for k, (q, t) in enumerate(pairs):
        qs[k, :len(q)] = q
        ts[k, :len(t)] = t
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    wv = np.asarray(w, np.int32).reshape(B)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (qs, ts, ql, tl, wv))


def extf_forward_plain(qs, ts, qlen, tlen, w, mch: int, mis: int, e: int,
                       xdrop: int):
    """Plain version of kernels 7 (``csrc/batch_extf_fwd.cu``) and 15
    (``csrc/lg_fwd.cu``): the extf2 recurrence of every pair at once, one
    diagonal a step, on ``qs``'s device.  Returns the (B, 9) int32
    records."""
    dev = qs.device
    B, Lq = qs.shape
    Lt = ts.shape[1]
    TP = strip_len(Lt)
    L = torch.int64
    t = torch.arange(TP, device=dev, dtype=L)[None, :]
    ql, tl, wl = (a.to(L) for a in (qlen, tlen, w))
    T = torch.zeros((B, TP), dtype=L, device=dev)
    T[:, :Lt] = ts.to(L)
    T = torch.where(t < tl[:, None], T, 0)
    qv = qs.to(L)
    u = torch.zeros((B, TP), dtype=L, device=dev)
    v = torch.zeros_like(u)
    s = torch.zeros_like(u)
    empty = (ql <= 0) | (tl <= 0)
    ndb = ql + tl - 1
    rlim_np = first_empty_diag(qlen.cpu().numpy(), tlen.cpu().numpy(),
                               w.cpu().numpy())
    rlim = torch.from_numpy(np.asarray(rlim_np, np.int64)).to(dev)
    rlim = torch.where(empty, 0, rlim)
    zero = torch.zeros(B, dtype=L, device=dev)
    last_st, last_en = zero - 1, zero - 1
    H0, lt, mx, mt, mq = zero, zero, zero, zero - 1, zero - 1
    zd = (rlim < ndb) & ~empty
    live = torch.ones(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for r in range(int(rlim.max()) if B else 0):
        act = live & (r < rlim)
        st0 = torch.maximum(torch.clamp(r - ql + 1, min=0),
                            (r - wl + 1) >> 1)
        en0 = torch.minimum(torch.clamp(tl - 1, max=r), (r + wl) >> 1)
        st, en = st0 & ~15, en0 | 15
        hi = st0 + ((en0 - st0) & ~15) + 15
        prev = (st > 0) & (last_st <= st - 1) & (st - 1 <= last_en)
        V1 = torch.where(prev, v[rows, (st - 1).clamp(0, TP - 1)], 0)
        qi = r - t
        Q = torch.where((qi >= 0) & (qi < ql[:, None]),
                        qv.gather(1, qi.clamp(0, Lq - 1).expand(B, TP)), 0)
        fill = act[:, None] & (t >= st0[:, None]) & (t <= hi[:, None])
        s = torch.where(fill, torch.where(T == Q, mch, mis), s)
        vsh = torch.cat([zero[:, None], v[:, :-1]], 1)
        vt1 = torch.where(t == st[:, None], V1[:, None], vsh)
        ut = torch.where(t == r, 0, u)
        z = torch.maximum(w8(s + 2 * e), vt1)
        z = torch.where((ut & 255) > (z & 255), ut, z)
        band = act[:, None] & (t >= st[:, None]) & (t <= en[:, None])
        u = torch.where(band, w8(z - vt1), u)
        v = torch.where(band, w8(z - ut), v)
        # the O(1) H0 walk and the X-drop (ksw2_extf2_sse.c:80-91)
        if r == 0:
            H0 = torch.where(act, (v[:, 0] & 255) - 2 * e, H0)
            lt = torch.where(act, 0, lt)
        else:
            c1 = (lt >= st0) & (lt <= en0)
            c2 = (lt + 1 >= st0) & (lt + 1 <= en0)
            d0 = (v[rows, lt.clamp(0, TP - 1)] & 255) - e
            d1 = (u[rows, (lt + 1).clamp(0, TP - 1)] & 255) - e
            both = c1 & c2
            nH = torch.where(both, H0 + torch.maximum(d0, d1),
                             torch.where(c1, H0 + d0, H0 + d1))
            nlt = torch.where(both, torch.where(d0 > d1, lt, lt + 1),
                              torch.where(c1, lt, lt + 1))
            H0 = torch.where(act, nH, H0)
            lt = torch.where(act, nlt, lt)
            better = act & (H0 > mx)
            drop = act & ~better & (xdrop >= 0) & (mx - H0 > xdrop)
            mx = torch.where(better, H0, mx)
            mt = torch.where(better, lt, mt)
            mq = torch.where(better, r - lt, mq)
            zd = zd | drop
            live = live & ~drop
        last_st = torch.where(act, st, last_st)
        last_en = torch.where(act, en, last_en)
    neg = torch.full((B,), NEG_INF, dtype=L, device=dev)
    score = torch.where(zd | empty, neg, H0)
    rec = torch.stack([mx, mt, mq, neg, zero - 1, neg, zero - 1, score,
                       zd.to(L)], 1)
    return rec.to(torch.int32)


def extf_ncol(qlen, tlen, w):
    """The 16-rounded band a pair's diagonals can hold, plus 16 (ints or
    arrays): ``((min(qlen, tlen, w + 1) + 15) // 16 + 1) * 16``, the
    ``n_col`` of kernels E / E2's launches for the same pairs."""
    m = np.minimum(np.minimum(np.asarray(qlen, np.int64),
                              np.asarray(tlen, np.int64)),
                   np.asarray(w, np.int64) + 1)
    return ((np.maximum(m, 0) + 15) // 16 + 1) * 16


def extf_form(ncol: int) -> bool:
    """Whether kernel 7's register form holds a launch whose widest pair
    has ``extf_ncol`` ``ncol``: its window of ``REG_W`` positions (4
    slots of 256, of which a diagonal computes the ones its band meets)
    holds ``ncol + 48`` (``ops/batch.py:batch_form``'s rule).  Past it the
    launch takes the strip form."""
    return ncol + WINDOW_SLACK <= REG_W


def _check_args(qs, ts, qlen, tlen, w):
    B, Lq = qs.shape
    Lt = ts.shape[1]
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, Lt), "target", dev)
    for a, name in ((qlen, "qlen"), (tlen, "tlen"), (w, "w")):
        _check_cuda(a, torch.int32, (B,), name, dev)
    return B, Lq, Lt, dev


def batch_extf_forward_cuda(qs, ts, qlen, tlen, w, mch: int, mis: int,
                            e: int, xdrop: int, ncol: int):
    """Launch kernel 7 on the current stream in the form :func:`extf_form`
    gives the launch (the register form, else the strip form,
    :func:`batch_extf_strip_cuda`); the contract of
    :func:`extf_forward_plain` for targets of up to 1536.  ``ncol`` is the
    launch's widest :func:`extf_ncol`.  Nothing here reads the device; a
    pair whose band outgrows ``ncol`` traps in the kernel."""
    if not extf_form(ncol):
        return batch_extf_strip_cuda(qs, ts, qlen, tlen, w, mch, mis, e,
                                     xdrop)
    B, Lq, Lt, dev = _check_args(qs, ts, qlen, tlen, w)
    if Lt > LT_EXTF:
        raise ValueError(f"targets of {Lt}: the batched extf kernel takes "
                         f"{LT_EXTF} or less")
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_extf_reg_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), B, Lq, Lt, int(mch), int(mis), int(e),
            int(xdrop), int(ncol), rec.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_extf_fwd")
    LAUNCHES["batch_extf_fwd"] += 1
    return rec


def batch_extf_strip_cuda(qs, ts, qlen, tlen, w, mch: int, mis: int,
                          e: int, xdrop: int):
    """Launch kernel 7's strip form (one warp a pair, its strips in shared
    memory) on the current stream: the form of launches whose n_col the
    register window cannot hold (:func:`extf_form` False), any n_col up
    to the route's targets of 1536."""
    B, Lq, Lt, dev = _check_args(qs, ts, qlen, tlen, w)
    if Lt > LT_EXTF:
        raise ValueError(f"targets of {Lt}: the batched extf kernel takes "
                         f"{LT_EXTF} or less")
    TP = strip_len(Lt)
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_extf_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), B, Lq, Lt, int(mch), int(mis), int(e),
            int(xdrop), TP, min(MAX_WARPS, SMEM_MAX // (3 * TP)),
            rec.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_extf_fwd")
    LAUNCHES["batch_extf_fwd"] += 1
    return rec


def extf_forward(qs, ts, qlen, tlen, w, mch, mis, e, xdrop, cuda):
    """The forward on the tensors' device: ``cuda`` (kernel 7's
    :func:`batch_extf_forward_cuda` at the launch's n_col, or
    ``ops.extf.extf_single_forward_cuda`` for kernel 15) for CUDA
    tensors, the plain version for CPU tensors."""
    if qs.is_cuda:
        return cuda(qs, ts, qlen, tlen, w, mch, mis, e, xdrop)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return extf_forward_plain(qs, ts, qlen, tlen, w, mch, mis, e, xdrop)


def extf_records(query, target, qlen, tlen, w, mch: int, mis: int, e: int,
                 xdrop: int, device: torch.device) -> torch.Tensor:
    """Kernel 7's ``(B, NFIELDS)`` records on ``device`` (its plain version
    on the CPU) of padded host arrays and resolved bands, launched on the
    current stream."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
            (np.asarray(query, np.uint8), np.asarray(target, np.uint8),
             qlen, tlen, np.asarray(w, np.int32))]
    ncol = int(extf_ncol(qlen, tlen, w).max()) if len(qlen) else 16
    return extf_forward(*args, int(mch), canonical_mis(mis), int(e),
                        int(xdrop), cuda=functools.partial(
                            batch_extf_forward_cuda, ncol=ncol))


def extf_batch_device(query: np.ndarray, target: np.ndarray, qlen, tlen,
                      mch: int, mis: int, e: int, w=None, xdrop: int = -1,
                      device="cuda") -> Dict[str, np.ndarray]:
    """Batched linear-gap extension (extf2), score-only: kernel 7 on a
    CUDA device, its plain version on the CPU.  ``query`` (B, Lq) and
    ``target`` (B, Lt <= 1536) nt4 arrays; ``w`` per pair (None:
    ``max(qlen, tlen)``).  Returns max, max_t, max_q, score and zdropped
    arrays (``batch_pallas.py:1785-1845``)."""
    query = np.asarray(query)
    target = np.asarray(target)
    B, Lq = query.shape
    Lt = target.shape[1]
    if Lt > LT_EXTF:
        raise ValueError(f"targets of {Lt}: the batched extf route takes "
                         f"{LT_EXTF} or less")
    qlen = np.asarray(qlen, np.int32)
    tlen = np.asarray(tlen, np.int32)
    w = np.maximum(qlen, tlen) if w is None else np.asarray(w, np.int32)
    rec = extf_records(query, target, qlen, tlen, w, mch, mis, e, xdrop,
                       torch.device(device)).cpu().numpy()
    return {k: rec[:, i].copy() for k, i in
            (("max", 0), ("max_t", 1), ("max_q", 2), ("score", 7),
             ("zdropped", 8))}


__all__ = ["LT_EXTF", "REG_W", "w8", "canonical_mis", "pack_pairs",
           "extf_forward_plain", "extf_ncol", "extf_form",
           "batch_extf_forward_cuda", "batch_extf_strip_cuda",
           "extf_forward", "extf_records", "extf_batch_device"]
