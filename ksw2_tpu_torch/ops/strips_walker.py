"""Strips CIGARs: start cells, the walker, CIGAR assembly.

Port of ``ksw2_tpu/ops/strips_walker.py`` for one-piece (3-state),
two-piece and splice (5-state) bytes.  The forward (``ops/strips.py``
with ``cig``) writes the reference's direction bytes row-major,
``d8[b, i, j]``; the walker runs ``ksw_backtrack`` (ksw2.h:129-161,
``is_rot = 0``, no band force states) from each pair's start cell and
emits BAM runs ``len << 4 | op`` in walk order with ``(i_end, j_end,
count)``; :func:`finish_runs_batch` adds the tail D (or N) and I runs,
merges adjacent runs and reverses unless REV_CIGAR.  States 3 and 4 and
their 0x20 / 0x40 continuation bits need no code of their own:
``(byte >> (state + 2)) & 1`` reads them and states 1, 3 map to D and 2,
4 to I; with ``min_intron > 0`` (the ``nop`` form: splice bytes, where
``ksw_exts2_sse`` passes ``min_intron_len = long_thres``) state 3 maps to
N.  The JAX walker's 5-state I-run suffix scan, which only cuts the
cells a serial TPU core visits, is not ported.

The walker has two implementations: ``csrc/strips_walk.cu`` for CUDA
tensors and :func:`strips_walk_plain` for CPU tensors.  Its runs buffer
holds ``Lq + tv + 2`` entries per pair, more than a walk can emit, so the
JAX route's capped fetch and overflow re-walk are gone.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import CigarOp, Flag
from ..core.result import ExtzResult
from .records import unpack_records
from .strips import (Launch, replay_records, site_rows,
                     strips_extd_ineligible_reason, strips_forward,
                     strips_ineligible_reason, upload)


def strips_cigar_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop,
                                   q, e) -> Optional[str]:
    """Why a one-piece CIGAR bucket cannot run on the strips route, or
    None.  The envelope of ``strips_walker.strips_cigar_eligible``
    without its TPU cost model: EQX is refused, as there, and the bucket
    takes the band or batched route, which converts on the host."""
    f = int(flag)
    if f & int(Flag.SCORE_ONLY):
        raise ValueError("CIGAR eligibility is checked in CIGAR mode")
    if f & int(Flag.EQX):
        return "EQX CIGARs (strips_walker.py:519-520, 544-545)"
    return strips_ineligible_reason(qlen, tlen, w, f | int(Flag.SCORE_ONLY),
                                    m, mat, zdrop, q, e)


def strips_cigar_extd_ineligible_reason(qlen, tlen, w, flag, m, mat, zdrop,
                                        q, e, q2, e2) -> Optional[str]:
    """Why a two-piece CIGAR bucket cannot run on the strips route, or
    None: ``strips_walker.strips_cigar_extd_eligible`` without its TPU
    cost model (EQX is refused; the envelope is checked on the post-swap
    costs).  Degenerate scoring is reset by the scheduler first."""
    f = int(flag)
    if f & int(Flag.SCORE_ONLY):
        raise ValueError("CIGAR eligibility is checked in CIGAR mode")
    if f & int(Flag.EQX):
        return "EQX CIGARs (strips_walker.py:519-520, 544-545)"
    return strips_extd_ineligible_reason(qlen, tlen, w,
                                         f | int(Flag.SCORE_ONLY), m, mat,
                                         zdrop, q, e, q2, e2)


def start_cells(rec, qlen, tlen, flag, end_bonus: int):
    """(B, 2) int32 walk start cells from the replayed records
    (ksw2_extz2_sse.c:292-301; spec/strips_cigar.py:148-156).  A pair
    with no start cell gets (-1, -1) and the walker emits nothing."""
    i32 = torch.int32
    mx, mt, mq = rec[:, 0], rec[:, 1], rec[:, 2]
    mqe, mqe_t, zd = rec[:, 3], rec[:, 4], rec[:, 8]
    ql = qlen.to(i32)
    tl = tlen.to(i32)
    has = (mt >= 0) & (mq >= 0)
    cand_i = torch.where(has, mt, -1)
    cand_j = torch.where(has, mq, -1)
    if int(flag) & int(Flag.EXTZ_ONLY):
        reach = (zd == 0) & (mqe + int(end_bonus) > mx)
        i0 = torch.where(reach, mqe_t, cand_i)
        j0 = torch.where(reach, ql - 1, cand_j)
    else:
        i0 = torch.where(zd == 0, tl - 1, cand_i)
        j0 = torch.where(zd == 0, ql - 1, cand_j)
    return torch.stack([i0, j0], dim=1).to(i32).contiguous()


# --------------------------------------------------------------------------
# Kernel B: the walker, its plain version and its wrapper


def state_op(state: int, min_intron: int) -> int:
    """The BAM op a backtrack state emits (ksw2.h:148-155)."""
    if state == 0:
        return int(CigarOp.MATCH)
    if state == 1 or (state == 3 and min_intron <= 0):
        return int(CigarOp.DEL)
    if state == 3:
        return int(CigarOp.N_SKIP)
    return int(CigarOp.INS)


def strips_walk_plain(d8, starts, min_intron: int = 0):
    """Plain version of ``csrc/strips_walk.cu``: ``ksw_backtrack`` pair
    by pair.  Returns ``res`` (B, 3) int32 (i_end, j_end, count) and
    ``runs`` (B, Lq + tv + 2) int32 on ``d8``'s device."""
    d = d8.cpu().numpy()
    st = starts.cpu().numpy()
    B, tv, Lq = d.shape
    res = np.zeros((B, 3), np.int32)
    runs = np.zeros((B, Lq + tv + 2), np.int32)
    for b in range(B):
        i, j = int(st[b, 0]), int(st[b, 1])
        state = k = n = 0
        op = -1
        while i >= 0 and j >= 0:
            tmp = int(d[b, i, j])
            if state == 0:
                state = tmp & 7
            elif not (tmp >> (state + 2)) & 1:
                state = 0
            if state == 0:
                state = tmp & 7
            o = state_op(state, min_intron)
            if o != int(CigarOp.INS):
                i -= 1
            if o in (int(CigarOp.MATCH), int(CigarOp.INS)):
                j -= 1
            if o == op:
                n += 1
            else:
                if n > 0:
                    runs[b, k] = (n << 4) | op
                    k += 1
                op, n = o, 1
        if n > 0:
            runs[b, k] = (n << 4) | op
            k += 1
        res[b] = (i, j, k)
    return (torch.from_numpy(res).to(d8.device),
            torch.from_numpy(runs).to(d8.device))


def strips_walk_cuda(d8, starts, min_intron: int = 0):
    """Launch ``csrc/strips_walk.cu`` on the current stream; same
    contract as :func:`strips_walk_plain` (runs past each pair's count
    are left unwritten)."""
    if not (d8.is_cuda and starts.is_cuda):
        raise ValueError("d8 and starts must be CUDA tensors")
    if d8.device != starts.device:
        raise ValueError(f"starts is on {starts.device}, d8 on {d8.device}")
    if d8.dtype != torch.uint8 or d8.dim() != 3 or not d8.is_contiguous():
        raise ValueError("d8 must be a contiguous (B, tv, Lq) uint8 tensor")
    B, tv, Lq = d8.shape
    if starts.dtype != torch.int32 or tuple(starts.shape) != (B, 2) or \
            not starts.is_contiguous():
        raise ValueError("starts must be a contiguous (B, 2) int32 tensor")
    wr = Lq + tv + 2
    res = torch.empty((B, 3), dtype=torch.int32, device=d8.device)
    runs = torch.empty((B, wr), dtype=torch.int32, device=d8.device)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(d8.device):
        err = lib.ksw2t_strips_walk(
            d8.data_ptr(), starts.data_ptr(), B, tv, Lq, wr,
            int(min_intron), res.data_ptr(), runs.data_ptr(),
            torch.cuda.current_stream(d8.device).cuda_stream)
    check(err, "strips_walk")
    LAUNCHES["strips_walk"] += 1
    return res, runs


def strips_walk(d8, starts, min_intron: int = 0):
    """The walker on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if d8.is_cuda:
        return strips_walk_cuda(d8, starts, min_intron)
    if d8.device.type != "cpu":
        raise ValueError(f"unsupported device {d8.device}")
    return strips_walk_plain(d8, starts, min_intron)


# --------------------------------------------------------------------------
# Host assembly


def finish_runs_batch(runs_mat: np.ndarray, counts: np.ndarray,
                      i_end: np.ndarray, j_end: np.ndarray,
                      min_intron: int, is_rev: bool) -> list:
    """Merge the walk-order runs, add the tail D then I, and reverse
    unless ``is_rev``, for a whole launch in one numpy pass (ksw2.h:
    150-159).  Returns a list of per-pair CIGAR lists."""
    B, W = runs_mat.shape
    M = np.zeros((B, W + 2), np.int64)
    M[:, :W] = runs_mat.astype(np.int64)
    counts = np.asarray(counts, np.int64)
    i_end = np.asarray(i_end, np.int64)
    j_end = np.asarray(j_end, np.int64)
    has_d = i_end >= 0
    has_i = j_end >= 0
    opd = np.where((min_intron > 0) & (i_end >= min_intron),
                   int(CigarOp.N_SKIP), int(CigarOp.DEL))
    taild = ((i_end + 1) << 4) | opd
    taili = ((j_end + 1) << 4) | int(CigarOp.INS)
    rows = np.arange(B)
    M[rows, counts] = np.where(has_d, taild, M[rows, counts])
    pos_i = counts + has_d
    M[rows, pos_i] = np.where(has_i, taili, M[rows, pos_i])
    cnt2 = counts + has_d + has_i
    col = np.arange(W + 2)[None, :]
    valid = col < cnt2[:, None]
    vrow, vcol = np.nonzero(valid)          # row-major order
    if vrow.size == 0:
        return [[] for _ in range(B)]
    vv = M[vrow, vcol]
    vops = vv & 0xF
    vlens = vv >> 4
    brk = np.nonzero((vops[1:] != vops[:-1])
                     | (vrow[1:] != vrow[:-1]))[0] + 1
    starts = np.concatenate([[0], brk])
    glens = np.add.reduceat(vlens, starts)
    gops = vops[starts]
    grow = vrow[starts]
    cig = (glens << 4) | gops
    row_starts = np.searchsorted(grow, np.arange(B + 1))
    out = []
    for k in range(B):
        c = cig[row_starts[k]:row_starts[k + 1]]
        if not is_rev:
            c = c[::-1]
        out.append([int(x) for x in c])
    return out


def unpack_cigars(rec: np.ndarray, res: np.ndarray, runs: np.ndarray,
                  mat, q: int, e: int, end_bonus: int, flag,
                  min_intron: int = 0) -> List[ExtzResult]:
    """One launch's host records, walker results and runs -> per-pair
    ExtzResults (``unpack_cigar_flat`` without the overflow re-walk).
    ``q``/``e`` are the launch's POST-swap costs, as in
    ``strips_walker.py:1064-1066``; splice launches pass ``min_intron =
    long_thres`` for the tail N (``strips_walker.py:1075-1081``).
    Degenerate scoring never gets here: the scheduler resets those jobs
    before routing."""
    flag = Flag(int(flag))
    is_rev = bool(flag & Flag.REV_CIGAR)
    extz_only = bool(flag & Flag.EXTZ_ONLY)
    min_sc = int(np.asarray(mat).reshape(-1)[1:].min())
    fields = unpack_records(rec, min_sc, int(q), int(e))
    zd = fields["zdropped"].astype(bool)
    reach = extz_only & ~zd & (fields["mqe"] + end_bonus > fields["max"])
    had_start = ((~zd & (not extz_only)) | reach
                 | ((fields["max_t"] >= 0) & (fields["max_q"] >= 0)))
    cigs = finish_runs_batch(
        runs, np.where(had_start, res[:, 2], 0),
        np.where(had_start, res[:, 0], -1),
        np.where(had_start, res[:, 1], -1), min_intron, is_rev)
    out = []
    for p in range(rec.shape[0]):
        ez = ExtzResult(
            max=int(fields["max"][p]), max_t=int(fields["max_t"][p]),
            max_q=int(fields["max_q"][p]), mqe=int(fields["mqe"][p]),
            mqe_t=int(fields["mqe_t"][p]), mte=int(fields["mte"][p]),
            mte_q=int(fields["mte_q"][p]), score=int(fields["score"][p]),
            zdropped=bool(zd[p]))
        if reach[p]:
            ez.reach_end = True
        if had_start[p]:
            ez.cigar = cigs[p]
        out.append(ez)
    return out


def strips_cigar_launch(launch: Launch, end_bonus: int, device):
    """Forward with bytes, replay, start cells and walker for one launch;
    returns (rec, res, runs) tensors on ``device`` (enqueued, not
    synchronised).  The byte store is freed when this returns."""
    prm = launch.prm
    if not prm.cig:
        raise ValueError("a CIGAR launch needs cig=1 params")
    qs, ts, ql, tl, table = upload(launch, device)
    D, Dq, hl, d8 = strips_forward(qs, ts, ql, tl, table, prm,
                                   site_rows(launch, device))
    rec = replay_records(prm, D, Dq, hl, ql, tl)
    starts = start_cells(rec, ql, tl, prm.flag, end_bonus)
    res, runs = strips_walk(d8, starts, walk_min_intron(prm.lt, prm.spl))
    return rec, res, runs


def walk_min_intron(lt: int, spl) -> int:
    """The walkers' ``min_intron`` for a launch's bytes: splice bytes
    (``spl``) walk state 3 as N (the JAX walker's ``nop``), even when
    ``long_thres`` is 0 (``q2 <= q + e``, which only the strips route
    runs); other bytes pass 0.  The CIGAR's tail N still tests
    ``long_thres`` itself (``unpack_cigars``)."""
    return max(int(lt), 1) if spl else 0


__all__ = ["strips_cigar_ineligible_reason",
           "strips_cigar_extd_ineligible_reason", "start_cells",
           "state_op", "strips_walk", "strips_walk_plain", "strips_walk_cuda",
           "finish_runs_batch", "unpack_cigars", "strips_cigar_launch",
           "walk_min_intron"]
