"""Kernel 12: the single-pair extz forward, its store layout, plain version
and wrapper.

Port of ``ksw2_tpu/ops/wavefront.py``'s ``ExtzParams``, ``_static_stop``
(``bands.first_empty_diag``), ``_merge_key``, ``_extz_kernel_body`` and
``build_extz_call``, with the
row-windowed ``_extz_phase_body`` / ``window_phases`` folded in: they exist
for the TPU's static shapes.  It computes what ``spec/diagdiff.py:extz2``
specifies for one pair and any band ``w >= 0``: the anti-diagonal
Suzuki-Kasahara DP of ``ksw2_extz2_sse.c`` over the 16-rounded band, the
9-field record of ``ops/records.py`` (exact max with the SSE 4-lane tie
order and ``ksw_apply_zdrop``, or the O(1) H0 walk under APPROX_MAX, the
mqe / mte captures, the score, the first-empty-band stop) and, with
``cig``, the reference's direction byte of every cell of the rounded band.

The bytes go to a compact store: diagonal r's bytes ``[st(r), en(r)]`` at
``off(r) = sum over r' < r of (en(r') - st(r') + 1)`` after the pair's
base ``pbase``; every row is a multiple of 16 bytes wide.  :func:`row_off`
gives ``off`` in closed form, so neither the kernel nor the walker keeps
an offset array.  A launch holds many pairs (a bucket, or one pair) laid
out by :func:`make_layout`.

The forward has two implementations: ``csrc/extz_fwd.cu`` for CUDA
tensors (many blocks a pair, one warp a tile of ``tp`` target positions
whose state lives in its lanes' registers, and an in-order replay of the
per-diagonal records after it) and :func:`extz_forward_plain` for CPU
tensors, which is the band route's ``band.band_forward_plain`` with its
output laid out as this store.  A tile hands its last position's state
on to the next tile through a per-diagonal boundary history, one release
every 32 diagonals, so each tile runs one such group behind the one
before it.  :func:`choose_tp` picks the tile: 32 positions for a few
long pairs (a tile's diagonal is a chain of dependent steps, so narrow
tiles spread a pair over more SMs), 64 once a launch has more than 16
tiles of 32 a SM.  The same source in its
two-piece and splice forms is kernels 13 and 14
(:func:`single_forward_cuda`; their plain versions and host sides are
``ops/extd.py`` and ``ops/exts.py``), with this layout and store: the
tile edge they hand on carries x2 beside x and v in the same word, so
:func:`launch_bytes` holds for every form.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.flags import Flag
from .band import BandParams, band_forward_plain
from .bands import first_empty_diag, n_col_bytes
from .strips import _check_cuda, n_sms

TILES = (32, 64)           # the kernel's tile widths (target positions)
TP_MIN, TP_MAX = TILES
NARROW_PER_SM = 16         # tiles of TP_MIN a launch may put on each SM


class ExtzParams(NamedTuple):
    """One pair's configuration: ``wavefront.ExtzParams`` without the TPU
    layout (``chunk``, ``n_rows``, ``p_rows``)."""
    qlen: int
    tlen: int
    m: int
    sc_mch: int
    sc_mis: int
    sc_N: int
    q: int
    e: int
    w: int          # resolved (>= 0)
    zdrop: int
    flag: int
    n_diag: int


def row_widths(n: int, qlen: int, tlen: int, w: int) -> np.ndarray:
    """The store's row widths ``en(r) - st(r) + 1`` of diagonals
    ``0 .. n - 1`` (int64): the 16-rounded band, multiples of 16."""
    r = np.arange(n, dtype=np.int64)
    st0 = np.maximum(0, np.maximum(r - qlen + 1, (r - w + 1) >> 1))
    en0 = np.minimum(tlen - 1, np.minimum(r, (r + w) >> 1))
    return 16 * (en0 // 16 - st0 // 16 + 1)


def row_off(r, qlen, tlen, w) -> np.ndarray:
    """``off(r)``, the bytes of rows ``0 .. r - 1``, in closed form, for
    ints or arrays: ``16 * sum (en0 // 16 - st0 // 16 + 1)`` counts, for
    each multiple x = 16 j, the rows whose ``en0`` (``st0``) has reached
    it, from the first row where it does (``max(x, 2x - w)`` while
    ``x < tlen``; ``min(x + qlen - 1, 2x + w - 1)``).  ``csrc/common.cuh:
    store_row_off`` computes the same sums."""
    r, qlen, tlen, w = (np.atleast_1d(np.asarray(a, np.int64))
                        for a in (r, qlen, tlen, w))
    r, qlen, tlen, w = np.broadcast_arrays(r, qlen, tlen, w)
    x = 16 * np.arange(1, int(r.max(initial=0)) // 16 + 2,
                       dtype=np.int64)[None, :]
    f_en = np.maximum(x, 2 * x - w[:, None])
    s_en = np.where(x <= tlen[:, None] - 1,
                    np.maximum(r[:, None] - f_en, 0), 0).sum(1)
    f_st = np.minimum(x + qlen[:, None] - 1, 2 * x + w[:, None] - 1)
    s_st = np.maximum(r[:, None] - f_st, 0).sum(1)
    return 16 * (r + s_en - s_st)


def store_bytes(qlen, tlen, w) -> np.ndarray:
    """Each pair's store, the bytes of its rows up to the first empty
    diagonal."""
    return row_off(first_empty_diag(qlen, tlen, w), qlen, tlen, w)


def choose_tp(tlen) -> int:
    """A launch's tile for its pairs' targets ``tlen``: ``TP_MIN`` while
    its tiles number at most ``NARROW_PER_SM`` a SM (a few long pairs:
    a tile's diagonal is a chain of dependent chunk steps, so the
    narrowest tiles spread a pair over the most SMs and run the shortest
    chain), else ``TP_MAX``, which halves the tile-diagonals, and so the
    hand-off work, of a launch that fills the card."""
    tiles = int((-(-(np.asarray(tlen, np.int64) + 15) // TP_MIN)).sum())
    return TP_MIN if tiles <= NARROW_PER_SM * n_sms() else TP_MAX


def launch_bytes(qlen, tlen, w, tp: int, cig: bool) -> np.ndarray:
    """Each pair's device buffers in a launch of tiles of ``tp``
    positions (int64): its boundary history (8 bytes for each of
    ``tiles - 1`` edges of ``rlim`` entries), its per-diagonal records
    (16 bytes a diagonal, at most) and, with ``cig``, its store.  The
    history only shrinks as ``tp`` grows."""
    qlen, tlen, w = (np.asarray(a, np.int64) for a in (qlen, tlen, w))
    rlim = first_empty_diag(qlen, tlen, w).astype(np.int64)
    tiles = -(-(tlen + 15) // tp)
    store = store_bytes(qlen, tlen, w) if cig else 0
    return 8 * (tiles - 1) * rlim + 16 * rlim + store


class ExtzLayout(NamedTuple):
    """Where a launch's pairs live in the kernel's buffers (host arrays):
    pair b has ``rlim[b]`` diagonals (its first empty one), tiles
    ``tbase[b] .. tbase[b + 1] - 1``, per-diagonal records from
    ``dbase[b]``, boundary history from ``bbase[b]`` (``tiles - 1`` edges
    of ``rlim`` entries) and store bytes from ``pbase[b]``."""
    tp: int
    rlim: np.ndarray
    tbase: np.ndarray
    dbase: np.ndarray
    bbase: np.ndarray
    pbase: np.ndarray
    n_diag: int
    n_bnd: int
    n_bytes: int

    def device_bytes(self) -> int:
        """The launch's buffers, as :func:`launch_bytes` counts them."""
        return 8 * self.n_bnd + 16 * self.n_diag + self.n_bytes


def _excl(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a, out=out[1:])
    return out


def make_layout(qlen, tlen, w, tp: int, cig: bool) -> ExtzLayout:
    """The launch's layout for tiles of ``tp`` positions (one of
    ``TILES``); the store only with ``cig``."""
    if tp not in TILES:
        raise ValueError(f"tile of {tp} positions: want one of {TILES}")
    qlen, tlen, w = (np.asarray(a, np.int64) for a in (qlen, tlen, w))
    rlim = first_empty_diag(qlen, tlen, w).astype(np.int64)
    tiles = -(-(tlen + 15) // tp)
    tb = _excl(tiles)
    db = _excl(rlim)
    bb = _excl((tiles - 1) * rlim)
    pb = _excl(row_off(rlim, qlen, tlen, w) if cig
               else np.zeros_like(rlim))
    return ExtzLayout(tp, rlim, tb.astype(np.int32), db[:-1], bb[:-1],
                      pb[:-1], int(db[-1]), int(bb[-1]), int(pb[-1]))


def compact_store(p_band: torch.Tensor, qlen, tlen, w,
                  lay: ExtzLayout) -> torch.Tensor:
    """The band store ``p[b, r, t - st(r)]`` (``band.band_forward_plain``)
    laid out as this store: each pair's rows ``r < rlim`` cut to their
    widths and concatenated."""
    out = torch.zeros(lay.n_bytes, dtype=torch.uint8, device=p_band.device)
    ncol = p_band.shape[2]
    for b in range(p_band.shape[0]):
        n = int(lay.rlim[b])
        wid = torch.from_numpy(row_widths(n, int(qlen[b]), int(tlen[b]),
                                          int(w[b]))).to(p_band.device)
        mask = torch.arange(ncol, device=p_band.device)[None, :] < \
            wid[:, None]
        rows = p_band[b, :n][mask]
        out[int(lay.pbase[b]):int(lay.pbase[b]) + rows.numel()] = rows
    return out


def extz_forward_plain(qs, ts, qlen, tlen, w, table, prm: BandParams,
                       lay: ExtzLayout):
    """Plain PyTorch version of ``csrc/extz_fwd.cu``: the band route's
    per-diagonal forward (any ``w >= 0``) with its bytes laid out as the
    compact store.  Returns ``rec`` (B, 9) int32 in ``FIELD_ORDER``,
    ``p`` (``lay.n_bytes``,) uint8 with ``cig`` (rows past a pair's stop
    are 0) and ``stop`` (B,) int32, the rows each pair computed (its
    Z-drop diagonal + 1, else ``rlim``)."""
    ql, tl, wl = (a.cpu().numpy() for a in (qlen, tlen, w))
    nd = int((ql.astype(np.int64) + tl - 1).max())
    ncol = max(n_col_bytes(int(a), int(b), int(c))
               for a, b, c in zip(ql, tl, wl)) if prm.cig else 16
    rec, pb, stop = band_forward_plain(qs, ts, qlen, tlen, w, table, prm,
                                       nd, ncol, with_stop=True)
    p = compact_store(pb, ql, tl, wl, lay) if prm.cig else None
    return rec, p, stop


def _meta(lay: ExtzLayout, dev):
    """The layout's tile and base arrays on ``dev`` (pinned, async)."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        lay.tbase, lay.dbase, lay.bbase, lay.pbase)]
    return [t.pin_memory().to(dev, non_blocking=True) for t in host]


# the kernel's forms (csrc/extz_fwd.cu's MODE_*), each with its counter
MODES = {"extz_fwd": 0, "extd_fwd": 1, "exts_fwd": 2}


def single_forward_cuda(kind: str, qs, ts, qlen, tlen, w, table, prm, lay,
                        sites=()):
    """Launch ``csrc/extz_fwd.cu`` (the forward, then the replay) in the
    form ``kind`` ("extz_fwd", "extd_fwd" or "exts_fwd", the counter it
    adds to) on the current stream.  ``prm`` is a ``band.BandParams``
    (one-piece; two-piece with ``two``) or a ``batch_exts.ExtsParams``
    (splice, with ``sites`` the (B, Lt) int8 donor and acceptor rows).
    Same contract as :func:`extz_forward_plain`, except that the kernel
    writes every row below ``rlim``, past a pair's stop too.  Nothing here
    reads the device.  A launch whose buffers (history, per-diagonal
    records, store) do not fit in the card's memory raises with their
    size."""
    mode = MODES[kind]
    B, Lq = qs.shape
    Lt = ts.shape[1]
    _check_cuda(qs, torch.uint8, (B, Lq), "query")
    dev = qs.device
    _check_cuda(ts, torch.uint8, (B, Lt), "target", dev)
    for t, name in ((qlen, "qlen"), (tlen, "tlen"), (w, "w")):
        _check_cuda(t, torch.int32, (B,), name, dev)
    _check_cuda(table, torch.int32, (prm.m * prm.m,), "table", dev)
    if mode == 2:
        if len(sites) != 2:
            raise ValueError("the splice form needs the donor and acceptor "
                             "rows")
        for t, name in zip(sites, ("donor rows", "acceptor rows")):
            _check_cuda(t, torch.int8, (B, Lt), name, dev)
        q2, e2, qe_pre = prm.q2, 0, prm.q + prm.e
    else:
        if bool(prm.two) != (mode == 1):
            raise ValueError(f"{kind} takes {'two' if mode else 'one'}-piece "
                             "params")
        q2, e2, qe_pre = prm.q2, prm.e2, prm.qe_pre
    if len(lay.rlim) != B:
        raise ValueError(f"layout of {len(lay.rlim)} pairs for {B}")
    f = prm.flag
    approx = bool(f & int(Flag.APPROX_MAX))
    i64 = torch.int64
    tbase, dbase, bbase, pbase = _meta(lay, dev)
    n_tiles = int(lay.tbase[-1])
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    progress = torch.full((n_tiles,), -1, dtype=torch.int32, device=dev)
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    stop = torch.empty((B,), dtype=torch.int32, device=dev)
    nd = max(lay.n_diag, 1)
    W = D = hse = p = None
    try:
        bnd = torch.empty((max(lay.n_bnd, 1), 2), dtype=torch.int32,
                          device=dev)
        if approx:
            W = torch.full((nd,), -1, dtype=i64, device=dev)
        else:
            D = torch.full((nd,), torch.iinfo(i64).min, dtype=i64,
                           device=dev)
            hse = torch.empty((nd, 2), dtype=torch.int32, device=dev)
        if prm.cig:
            p = torch.empty(max(lay.n_bytes, 16), dtype=torch.uint8,
                            device=dev)
    except torch.OutOfMemoryError as err:
        raise RuntimeError(
            f"this launch's buffers take {lay.device_bytes()} bytes "
            f"({lay.n_bytes} of direction bytes), more than {dev} "
            f"holds") from err

    def ptr(t):
        return None if t is None else t.data_ptr()

    don, acc = sites if mode == 2 else (None, None)
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_extz_fwd(
            mode, qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), w.data_ptr(), table.data_ptr(), ptr(don),
            ptr(acc), tbase.data_ptr(), dbase.data_ptr(), bbase.data_ptr(),
            pbase.data_ptr(), B, Lq, Lt, prm.m, prm.q, prm.e, q2, e2, qe_pre,
            prm.lt, prm.ld, prm.sc_mch, prm.sc_mis, prm.sc_N, prm.zdrop,
            int(bool(f & int(Flag.RIGHT))),
            int(bool(f & int(Flag.GENERIC_SC))), int(approx),
            int(bool(f & int(Flag.APPROX_DROP))), prm.cig, lay.tp, n_tiles,
            ticket.data_ptr(), progress.data_ptr(), bnd.data_ptr(), ptr(D),
            ptr(hse), ptr(W), rec.data_ptr(), stop.data_ptr(), ptr(p),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, kind)
    LAUNCHES[kind] += 1
    return rec, p, stop


def extz_forward_cuda(qs, ts, qlen, tlen, w, table, prm: BandParams,
                      lay: ExtzLayout):
    """Kernel 12: :func:`single_forward_cuda` in its one-piece form."""
    return single_forward_cuda("extz_fwd", qs, ts, qlen, tlen, w, table, prm,
                               lay)


def extz_forward(qs, ts, qlen, tlen, w, table, prm: BandParams,
                 lay: ExtzLayout):
    """The forward on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if qs.is_cuda:
        return extz_forward_cuda(qs, ts, qlen, tlen, w, table, prm, lay)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return extz_forward_plain(qs, ts, qlen, tlen, w, table, prm, lay)


__all__ = ["TILES", "TP_MIN", "TP_MAX", "ExtzParams", "row_widths",
           "row_off", "store_bytes", "n_sms", "choose_tp",
           "launch_bytes", "ExtzLayout", "make_layout", "compact_store",
           "extz_forward_plain", "MODES",
           "single_forward_cuda", "extz_forward_cuda", "extz_forward"]
