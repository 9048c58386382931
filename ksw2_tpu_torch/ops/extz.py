"""The single-pair one-piece engine: host side and bucket form.

Port of ``ksw2_tpu/ops/extz.py:extz2_device`` over kernels 12 (the
forward, ``ops/extz_fwd.py``) and 17 (the walker,
``ops/traceback_device.py``).  A launch is one pair or a bucket of them:
the degenerate-scoring and empty-input resets come first
(``extz.py:209-215``), ``w < 0`` resolves to ``max(qlen, tlen)``, the
GENERIC_SC matrix travels as the score table (``_generic_prof``'s planes
are the TPU's layout of it), the start cell follows ``make_ext_start_fn``'s
rule (ksw2_extz2_sse.c:292-301, ``reach_end`` included) through
``strips_walker.start_cells``, and ``strips_walker.unpack_cigars``
finishes the CIGARs with REV_CIGAR honoured.  A one-piece CIGAR keeps M
ops: extz2 ignores EQX.  The JAX wrapper's host fallbacks (a re-run and
host backtrack when the walk escapes, ``device_tb=False`` /
``KSW2_HOST_TB``) are not ported: with ``upper_force = 1`` the walk
cannot escape, and a set flag raises.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..core.flags import Flag
from ..core.result import ExtzResult
from .band import BandParams, band_upload, make_band_params
from . import strips as _strips
from .extz_fwd import (ExtzLayout, ExtzParams, choose_tp,
                       extz_forward, launch_bytes, make_layout)
from .records import unpack_records
from .strips import round_up
from .strips_walker import start_cells, unpack_cigars
from .traceback_device import extz_walk


class ExtzLaunch(NamedTuple):
    """One prepared launch: parameters, padded host arrays, layout."""
    prm: BandParams
    query: np.ndarray      # (B, Lq) uint8
    target: np.ndarray     # (B, Lt) uint8
    qlen: np.ndarray       # (B,) int32
    tlen: np.ndarray       # (B,) int32
    w: np.ndarray          # (B,) int32, resolved (>= 0)
    lay: ExtzLayout
    sites: tuple = ()      # splice: (B, Lt) int8 donor and acceptor rows,
    #                        which band.band_upload appends


def extz_params(query, target, m: int, mat, q: int, e: int, w: int = -1,
                zdrop: int = -1, flag: int = 0) -> ExtzParams:
    """One pair's :class:`ExtzParams` (``w < 0`` resolved), as
    ``extz2_device`` builds ``wf.ExtzParams``."""
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, np.int8).reshape(-1)
    w = max(qlen, tlen) if w < 0 else w
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    return ExtzParams(qlen=qlen, tlen=tlen, m=int(m), sc_mch=int(mat[0]),
                      sc_mis=int(mat[1]), sc_N=sc_N, q=int(q), e=int(e),
                      w=int(w), zdrop=int(zdrop), flag=int(flag),
                      n_diag=qlen + tlen - 1)


def extz_prep(query, target, qlen, tlen, w, m, mat, q, e, zdrop, flag,
              cig: bool) -> List[ExtzLaunch]:
    """Plan and pad one bucket's launches (host only, no device work).
    ``w`` is resolved (>= 0).  See :func:`single_prep`."""
    return single_prep(make_band_params(m, mat, q, e, zdrop, flag, cig),
                       query, target, qlen, tlen, w)


def single_prep(prm, query, target, qlen, tlen, w,
                sites=None) -> List[ExtzLaunch]:
    """The launches of a set of pairs (one pair, or every pair of a batch
    that the route table sends to this engine, whatever its bucket) for
    the single-pair forward with the params
    ``prm`` (any form): a launch holds as many pairs (in the given order)
    as keep its buffers (``extz_fwd.launch_bytes`` at the tile
    :func:`extz_fwd.choose_tp` picks for the whole set) within
    ``ops.strips.LAUNCH_BYTES``, and a pair whose buffers alone are larger
    gets a launch of its own.  A launch then takes the tile that
    ``choose_tp`` picks for its own pairs, where its buffers still fit.
    ``sites(i0, tpad, tlen)`` gives the donor and acceptor rows of a
    splice launch whose first pair is the set's ``i0``."""
    qlen = np.asarray(qlen, np.int32)
    tlen = np.asarray(tlen, np.int32)
    w = np.asarray(w, np.int32)
    B = len(query)
    tp = choose_tp(tlen)
    sizes = launch_bytes(qlen, tlen, w, tp, prm.cig)
    out = []
    i0 = 0
    while i0 < B:
        i1, total = i0 + 1, int(sizes[i0])
        while i1 < B and total + int(sizes[i1]) <= _strips.LAUNCH_BYTES:
            total += int(sizes[i1])
            i1 += 1
        ql, tl, wl = qlen[i0:i1], tlen[i0:i1], w[i0:i1]
        tp_l = choose_tp(tl)
        if tp_l != tp and i1 - i0 > 1 and int(launch_bytes(
                ql, tl, wl, tp_l, prm.cig).sum()) > _strips.LAUNCH_BYTES:
            tp_l = tp
        qpad = np.zeros((i1 - i0, round_up(int(ql.max()), 16)), np.uint8)
        tpad = np.zeros((i1 - i0, round_up(int(tl.max()), 16)), np.uint8)
        for k in range(i1 - i0):
            qpad[k, :ql[k]] = query[i0 + k]
            tpad[k, :tl[k]] = target[i0 + k]
        if max(int(qpad.max()), int(tpad.max())) >= prm.m:
            raise ValueError(f"sequence symbols must be < m = {prm.m}")
        out.append(ExtzLaunch(prm, qpad, tpad, ql.copy(), tl.copy(),
                              wl.copy(), make_layout(ql, tl, wl, tp_l,
                                                     prm.cig),
                              () if sites is None else sites(i0, tpad, tl)))
        i0 = i1
    return out


def extz_records(launch: ExtzLaunch, device, forward=extz_forward):
    """Forward of one score launch (``forward``: kernel 12's by default,
    ``extd.extd_forward`` or ``exts.exts_forward`` for the other forms):
    (B, 9) int32 records on ``device`` (enqueued, not synchronised)."""
    args = band_upload(launch, device)
    rec, _, _ = forward(*args, launch.prm, launch.lay)
    return rec


def extz_cigar_launch(launch: ExtzLaunch, end_bonus: int, device,
                      forward=extz_forward, min_intron: int = 0):
    """Forward with bytes (``forward``, as in :func:`extz_records`), start
    cells and walker (``min_intron > 0`` walks state 3 as N) for one
    launch; returns (rec, res, runs) tensors on ``device`` (enqueued, not
    synchronised).  The byte store is freed when this returns."""
    prm = launch.prm
    if not prm.cig:
        raise ValueError("a CIGAR launch needs cig=1 params")
    args = band_upload(launch, device)
    rec, p, _ = forward(*args, prm, launch.lay)
    _, _, ql, tl, w = args[:5]
    starts = start_cells(rec, ql, tl, prm.flag, end_bonus)
    pbase = torch.from_numpy(launch.lay.pbase)
    if ql.is_cuda:
        pbase = pbase.pin_memory().to(ql.device, non_blocking=True)
    wr = launch.query.shape[1] + launch.target.shape[1] + 2
    res, runs = extz_walk(p, pbase, starts, ql, tl, w, wr, min_intron)
    return rec, res, runs


def unpack_extz_cigars(launch: ExtzLaunch, rec: np.ndarray, res: np.ndarray,
                       runs: np.ndarray, mat, end_bonus: int,
                       min_intron: int = 0) -> List[ExtzResult]:
    """One launch's host records and walker output -> ExtzResults with
    the walk's CIGARs (M ops; N for a splice launch's ``min_intron``).  A
    walk that escaped its band cannot happen with ``upper_force = 1``; a
    set flag raises."""
    if res[:, 3].any():
        raise RuntimeError("a single-pair walk escaped its band")
    prm = launch.prm
    return unpack_cigars(rec, res[:, :3], runs, mat, prm.q, prm.e,
                         end_bonus, prm.flag, min_intron)


def _ez_of_fields(fields, k: int) -> ExtzResult:
    return ExtzResult(
        max=int(fields["max"][k]), max_t=int(fields["max_t"][k]),
        max_q=int(fields["max_q"][k]), mqe=int(fields["mqe"][k]),
        mqe_t=int(fields["mqe_t"][k]), mte=int(fields["mte"][k]),
        mte_q=int(fields["mte_q"][k]), score=int(fields["score"][k]),
        zdropped=bool(fields["zdropped"][k]))


def extz2_device(query, target, m: int, mat, q: int, e: int, w: int = -1,
                 zdrop: int = -1, end_bonus: int = 0, flag=Flag.NONE,
                 device="cuda") -> ExtzResult:
    """One pair on the single-pair engine (``extz.py:extz2_device``):
    the ``ksw_extz_t`` fields and, unless SCORE_ONLY, the M-op CIGAR.
    ``device`` runs the kernels ("cuda") or their plain versions
    ("cpu")."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    query, target = np.asarray(query), np.asarray(target)
    qlen, tlen = len(query), len(target)
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    if -int(mat[1:].min()) > 2 * (q + e):
        return ez
    w = max(qlen, tlen) if w < 0 else w
    cig = not flag & Flag.SCORE_ONLY
    launch, = extz_prep([query], [target], [qlen], [tlen], [w], m, mat, q,
                        e, zdrop, int(flag), cig)
    dev = torch.device(device)
    if not cig:
        rec = extz_records(launch, dev).cpu().numpy()
        return _ez_of_fields(unpack_records(rec, int(mat[1:].min()), q, e),
                             0)
    rec, res, runs = (t.cpu().numpy() for t in
                      extz_cigar_launch(launch, end_bonus, dev))
    return unpack_extz_cigars(launch, rec, res, runs, mat, end_bonus)[0]


__all__ = ["ExtzLaunch", "extz_params", "extz_prep", "single_prep",
           "extz_records",
           "extz_cigar_launch", "unpack_extz_cigars", "extz2_device"]
