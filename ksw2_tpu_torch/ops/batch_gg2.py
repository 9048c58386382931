"""Banded global alignment (gg2_sse): the plain version of kernels 8 and
16, the flat byte store, the batched form's CUDA wrapper and the batched
entry point.

Port of ``ksw2_tpu/ops/batch_pallas.py:gg2_batch_align`` with the kernel
``wavefront_batch_gg2.py:_batch_gg2_kernel`` (kernel 8,
``csrc/gg2_fwd.cu`` in its batched form, one warp a pair, counted as
``batch_gg2_fwd``: a register form while :func:`gg2_form` holds the
launch, a strip form, :func:`batch_gg2_strip_cuda`, past it).  The
single-pair kernel 16 (``csrc/lg_fwd.cu``, tiles over many blocks) and
``gg2_device`` are in :mod:`ops.gg2`.

Both kernels compute ``spec/diagdiff.py:gg2_sse`` (``ksw2_gg2_sse.c``),
and :func:`gg2_forward_plain`, vectorised over pairs, is the plain
version of both: u, v, x, y in wrapping int8 over the 16-rounded band,
the score bytes gathered from the matrix (the table, ``m * m`` int32; the
JAX kernels' sign-biased profile planes are the TPU's layout of it), no
unsigned clamp, every diagonal's direction bytes, and the O(1) H0 walk to
the corner.  ``overrun`` selects how the walk reads: through the
reference's one block of u, v, x, y and s at a stride of ``tlen_ * 16``
(kernel 16: exact when ``qlen > tlen + w`` runs it past u,
``wavefront_gg2.py:15-20, 88-133``), or in the strips clamped to ``TP -
1`` (kernel 8, which the route gives only pairs with ``qlen <= tlen +
w``, ``batch_pallas.py:1915-1916``).

The bytes go to the reference's flat layout (:func:`flat_layout`): pair
b's rows from ``pbase[b]``, row r ``n_col`` bytes, cell i at ``r * n_col
+ i - st(r)``, and one zero row after the last, the layout the JAX side
repacks into before its host walk (``batch_pallas.py:1966-1974``).  The
flat form of ``band_walk.cu`` (``band_walker.flat_walk``) walks it on the
card, so ``native/bindings.backtrack`` is not ported.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from .band_walker import flat_walk, flat_walk_cigars
from .batch import REG_M, WINDOW_SLACK, strip_len
from .batch_extf import _check_args, w8
from .lg_tiles import byte_groups, launch_bytes, lg_layout
from . import strips
from .strips import SMEM_MAX, _check_cuda

LT_GG2 = 1536             # the batched engines' targets (batch_pallas.py)
MAX_WARPS = 8             # pairs (warps) a block of kernel 8
REG_W = 256               # the register form's window, target positions


def gg2_ncol(tlen, w):
    """The reference's row width ``n_col_ * 16`` (ksw2_gg2_sse.c:21-24):
    ``((min(w + 1, tlen) + 15) / 16 + 1) * 16``; ints or arrays."""
    wc = np.minimum(np.asarray(w, np.int64) + 1, np.asarray(tlen, np.int64))
    return ((wc + 15) // 16 + 1) * 16


def flat_layout(qlen, tlen, w) -> Tuple[np.ndarray, int]:
    """Each pair's offset in the flat store (int64) and the store's bytes:
    ``qlen + tlen`` rows of ``n_col`` a pair (its diagonals and one zero
    row)."""
    size = ((np.asarray(qlen, np.int64) + np.asarray(tlen, np.int64))
            * gg2_ncol(tlen, w))
    size = np.maximum(size, 0)
    pbase = np.zeros(len(size), np.int64)
    if len(size):
        pbase[1:] = np.cumsum(size)[:-1]
    return pbase, int(size.sum())


def gg2_forward_plain(qs, ts, qlen, tlen, w, table, m: int, q: int, e: int,
                      pbase, total: int, overrun: bool, planes=None):
    """Plain version of kernels 8 (``overrun`` False, ``csrc/gg2_fwd.cu``)
    and 16 (``overrun`` True, ``csrc/lg_fwd.cu``): the gg2_sse recurrence
    of every pair at once, one diagonal a step, on ``qs``'s device.
    Returns the (B,) int32 corner scores and the flat byte store
    (``total`` uint8).  A list ``planes`` receives, after each diagonal,
    the (B, TP) int64 planes (u, v, x, y, s) as they then stand."""
    dev = qs.device
    B, Lq = qs.shape
    Lt = ts.shape[1]
    TP = strip_len(Lt)
    L = torch.int64
    t = torch.arange(TP, device=dev, dtype=L)[None, :]
    ql, tl, wl = (a.to(L) for a in (qlen, tlen, w))
    T = torch.zeros((B, TP), dtype=L, device=dev)
    T[:, :Lt] = ts.to(L)
    qv = qs.to(L)
    tab = table.to(L)
    u, v, x, y, s = (torch.zeros((B, TP), dtype=L, device=dev)
                     for _ in range(5))
    p = torch.zeros(total, dtype=torch.uint8, device=dev)
    pb = pbase.to(L)
    ncol = torch.from_numpy(gg2_ncol(tlen.cpu().numpy(),
                                     w.cpu().numpy())).to(dev)
    NS = (tl + 15) & ~15
    nd = ql + tl - 1
    qe = q + e
    zero = torch.zeros(B, dtype=L, device=dev)
    last_st, last_en, H0, lt = zero - 1, zero - 1, zero, zero
    rows = torch.arange(B, device=dev)

    def at(a, k):
        return a[rows, k.clamp(0, TP - 1)] & 255

    def rd(region: int, k):
        # unsigned byte k of u (0) or v (1) as the H0 walk reads it
        if not overrun:
            return at((u, v)[region], k)
        f = region * NS + k
        out = torch.where(f < 5 * NS + 16, at(s, f - 4 * NS), 0)
        for j, a in enumerate((y, x, v, u)):
            out = torch.where(f < (4 - j) * NS, at(a, f - (3 - j) * NS), out)
        return out

    for r in range(int(nd.max()) if B else 0):
        act = r < nd
        st0 = torch.maximum(torch.clamp(r - ql + 1, min=0),
                            (r - wl + 1) >> 1)
        en0 = torch.minimum(torch.clamp(tl - 1, max=r), (r + wl) >> 1)
        st, en = st0 & ~15, en0 | 15
        live = act & (st <= en)
        prev = (last_st <= st - 1) & (st - 1 <= last_en)
        X1 = torch.where((st > 0) & prev, at(x, st - 1), 0)
        V1 = torch.where(st > 0, torch.where(prev, at(v, st - 1), 0),
                         w8(torch.tensor(q if r else 0, device=dev)))
        X1, V1 = w8(X1), w8(V1)
        qi = (r - t).clamp(0, Lq - 1).expand(B, TP)
        fill = live[:, None] & (t >= st0[:, None]) & (t <= en0[:, None])
        s = torch.where(fill, tab[(T * m + qv.gather(1, qi)).clamp(
            0, m * m - 1)], s)
        xt1 = torch.where(t == st[:, None], X1[:, None],
                          torch.cat([zero[:, None], x[:, :-1]], 1))
        vt1 = torch.where(t == st[:, None], V1[:, None],
                          torch.cat([zero[:, None], v[:, :-1]], 1))
        col = t == r
        ut = torch.where(col, w8(torch.tensor(q if r else 0, device=dev)),
                         u)
        yt = torch.where(col, 0, y)
        zz = w8(s + 2 * qe)
        a = w8(xt1 + vt1)
        bb = w8(yt + ut)
        d = (a > zz).to(L)
        z = torch.maximum(zz, a)
        d = torch.where(bb > z, 2, d)
        z = torch.where((bb & 255) > (z & 255), bb, z)
        z2 = w8(z - q)
        a2, b2 = w8(a - z2), w8(bb - z2)
        d = d | torch.where(a2 > 0, 0x08, 0) | torch.where(b2 > 0, 0x10, 0)
        band = live[:, None] & (t >= st[:, None]) & (t <= en[:, None])
        u = torch.where(band, w8(z - vt1), u)
        v = torch.where(band, w8(z - ut), v)
        x = torch.where(band, torch.where(a2 > 0, a2, 0), x)
        y = torch.where(band, torch.where(b2 > 0, b2, 0), y)
        idx = pb[:, None] + r * ncol[:, None] + (t - st[:, None])
        p[idx[band]] = d[band].to(torch.uint8)
        if planes is not None:
            planes.append((u, v, x, y, s))
        # the O(1) H0 walk along the band (ksw2_gg2_sse.c:102-106)
        if r == 0:
            H0 = torch.where(act, rd(1, zero) - 2 * qe, H0)
            lt = torch.where(act, 0, lt)
        else:
            c1 = (lt >= st0) & (lt <= en0)
            nlt = torch.where(c1, lt, lt + 1)
            step = torch.where(c1, rd(1, lt), rd(0, lt + 1)) - qe
            H0 = torch.where(act, H0 + step, H0)
            lt = torch.where(act, nlt, lt)
        last_st = torch.where(act, st, last_st)
        last_en = torch.where(act, en, last_en)
    return H0.to(torch.int32), p


def _gg2_check(qs, ts, qlen, tlen, w, table, m, pbase):
    B, Lq, Lt, dev = _check_args(qs, ts, qlen, tlen, w)
    _check_cuda(table, torch.int32, (m * m,), "table", dev)
    _check_cuda(pbase, torch.int64, (B,), "pbase", dev)
    return B, Lq, Lt, dev


def gg2_form(ncol: int, m: int) -> bool:
    """Whether kernel 8's register form holds a launch whose widest row
    (:func:`gg2_ncol`) is ``ncol`` bytes and whose alphabet is ``m``: its
    window of ``REG_W`` positions holds ``ncol + 48``
    (``ops/batch.py:batch_form``'s rule) and its table of 64 entries the
    matrix (``m <= 8``).  Otherwise the launch takes the strip form."""
    return m <= REG_M and ncol + WINDOW_SLACK <= REG_W


def batch_gg2_forward_cuda(qs, ts, qlen, tlen, w, table, m: int, q: int,
                           e: int, pbase, total: int, ncol: int):
    """Launch kernel 8 on the current stream in the form :func:`gg2_form`
    gives the launch (the register form, else the strip form,
    :func:`batch_gg2_strip_cuda`); the contract of
    :func:`gg2_forward_plain` with ``overrun`` False, for targets of up
    to 1536.  ``ncol`` is the launch's widest :func:`gg2_ncol`.  Nothing
    here reads the device; in the register form a pair with ``qlen >
    tlen + w`` or a row wider than ``ncol`` traps."""
    if not gg2_form(ncol, m):
        return batch_gg2_strip_cuda(qs, ts, qlen, tlen, w, table, m, q, e,
                                    pbase, total)
    B, Lq, Lt, dev = _gg2_check(qs, ts, qlen, tlen, w, table, m, pbase)
    if Lt > LT_GG2:
        raise ValueError(f"targets of {Lt}: the batched gg2 kernel takes "
                         f"{LT_GG2} or less")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    p = torch.zeros(max(total, 1), dtype=torch.uint8, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_gg2_reg_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), table.data_ptr(), pbase.data_ptr(), B, Lq, Lt,
            int(m), int(q), int(e), int(ncol), score.data_ptr(),
            p.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_gg2_fwd")
    LAUNCHES["batch_gg2_fwd"] += 1
    return score, p[:total]


def batch_gg2_strip_cuda(qs, ts, qlen, tlen, w, table, m: int, q: int,
                         e: int, pbase, total: int):
    """Launch kernel 8's strip form (one warp a pair, its strips in shared
    memory) on the current stream: the form of launches that the register
    form cannot hold (:func:`gg2_form` False), any n_col up to the
    route's targets of 1536 and any ``m``."""
    B, Lq, Lt, dev = _gg2_check(qs, ts, qlen, tlen, w, table, m, pbase)
    if Lt > LT_GG2:
        raise ValueError(f"targets of {Lt}: the batched gg2 kernel takes "
                         f"{LT_GG2} or less")
    TP = strip_len(Lt)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    p = torch.zeros(max(total, 1), dtype=torch.uint8, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.ksw2t_batch_gg2_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), table.data_ptr(), pbase.data_ptr(), B, Lq, Lt,
            int(m), int(q), int(e), TP, min(MAX_WARPS, SMEM_MAX // (5 * TP)),
            score.data_ptr(), p.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "batch_gg2_fwd")
    LAUNCHES["batch_gg2_fwd"] += 1
    return score, p[:total]


def gg2_forward(qs, ts, qlen, tlen, w, table, m, q, e, pbase, total,
                single: bool, lay, ncol: int):
    """The forward on the tensors' device: kernel 16 (``single``, on the
    ``lg_tiles`` layout ``lay``) or 8 (at the launch's widest row
    ``ncol``) for CUDA tensors, the plain version (``overrun = single``)
    for CPU tensors."""
    if qs.is_cuda:
        if single:
            from .gg2 import gg2_single_forward_cuda
            return gg2_single_forward_cuda(qs, ts, qlen, tlen, w, table, m,
                                           q, e, pbase, total, lay)
        return batch_gg2_forward_cuda(qs, ts, qlen, tlen, w, table, m, q,
                                      e, pbase, total, ncol)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return gg2_forward_plain(qs, ts, qlen, tlen, w, table, m, q, e, pbase,
                             total, single)


def launch_groups(qlen, tlen, w, single: bool = False):
    """Consecutive index ranges whose flat stores, and for kernel 16
    (``single``) its tiles' history (``lg_tiles.launch_bytes``), each fit
    ``strips.LAUNCH_BYTES`` (a pair larger than that goes alone)."""
    size = ((np.asarray(qlen, np.int64) + np.asarray(tlen, np.int64))
            * gg2_ncol(tlen, w))
    if single:
        size = size + launch_bytes("gg2_fwd", qlen, tlen, w)
    return byte_groups(size, strips.LAUNCH_BYTES)


def gg2_run(pairs, m: int, mat, q: int, e: int, w, single: bool,
            device) -> List[Tuple[int, list]]:
    """Forward (kernel 16 or 8, or the plain version) and flat walk of
    (query, target) pairs with resolved bands ``w``, split into launches
    by their buffers' bytes (:func:`launch_groups`); returns (score,
    cigar) a pair."""
    from .batch_extf import pack_pairs

    dev = torch.device(device)
    table = torch.from_numpy(np.asarray(mat, np.int8).reshape(-1)
                             .astype(np.int32)).to(dev)
    wv = np.asarray(w, np.int64)
    ql = np.array([len(a) for a, _ in pairs], np.int64)
    tl = np.array([len(b) for _, b in pairs], np.int64)
    out = []
    for lo, hi in launch_groups(ql, tl, wv, single):
        sub = pairs[lo:hi]
        args = pack_pairs(sub, wv[lo:hi], dev)
        pbase_np, total = flat_layout(ql[lo:hi], tl[lo:hi], wv[lo:hi])
        pbase = torch.from_numpy(pbase_np).to(dev)
        lay = lg_layout("gg2_fwd", ql[lo:hi], tl[lo:hi], wv[lo:hi]) \
            if single else None
        score, p = gg2_forward(*args, table, m, q, e, pbase, total, single,
                               lay, int(gg2_ncol(tl[lo:hi], wv[lo:hi]).max()))
        _, _, qlt, tlt, wt = args
        cigs = flat_walk_cigars(*flat_walk(p, pbase, qlt, tlt, wt))
        out.extend(zip([int(x) for x in score.cpu().numpy()], cigs))
        del p
    return out


def gg2_batch_align(query: np.ndarray, target: np.ndarray, qlen, tlen,
                    m: int, mat, q: int, e: int, w=None, device="cuda"):
    """Batched banded global alignment (gg2_sse): kernel 8 and the flat
    walk on a CUDA device, their plain versions on the CPU.  Returns
    (score, cigar) a pair; the JAX function's score-only mode has no
    caller here and is not ported.  Pairs
    with ``qlen > tlen + w`` need the single-pair kernel
    (``batch_pallas.py:1915-1916``)."""
    query = np.asarray(query)
    target = np.asarray(target)
    if target.shape[1] > LT_GG2:
        raise ValueError(f"targets of {target.shape[1]}: the batched gg2 "
                         f"route takes {LT_GG2} or less")
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    w = np.maximum(qlen, tlen) if w is None else np.asarray(w, np.int64)
    if (qlen > tlen + w).any():
        raise ValueError("qlen > tlen + w pairs need the single-pair gg2")
    pairs = [(query[k, :qlen[k]], target[k, :tlen[k]])
             for k in range(len(qlen))]
    return gg2_run(pairs, m, mat, q, e, w, False, device)


__all__ = ["LT_GG2", "REG_W", "gg2_ncol", "flat_layout",
           "gg2_forward_plain", "gg2_form", "batch_gg2_forward_cuda",
           "batch_gg2_strip_cuda", "gg2_forward", "launch_groups",
           "gg2_run", "gg2_batch_align"]
