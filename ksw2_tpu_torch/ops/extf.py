"""The single-pair linear-gap extension: kernel 15's wrapper and
``extf2_device``.

Port of ``ksw2_tpu/ops/extf.py:extf2_device`` with the kernel
``wavefront_extf.py:_extf_kernel_body``: ``csrc/lg_fwd.cu`` in its
``MODE_EXTF`` form (counted as ``extf_fwd``), which spreads each pair
over many blocks in tiles of target positions (``ops/lg_tiles.py``) and
runs the H0 walk and its X-drop inside the forward; its plain version
is kernel 7's, ``ops.batch_extf.extf_forward_plain``.  The host side
follows ``extf2_device``: the reset ez for an empty sequence, ``mis``
canonicalised to <= 0 and ``w < 0`` as ``max(qlen, tlen)``.  Score only
(``ksw2_extf2_sse.c:12-15``).  A launch takes any number of pairs:
:func:`extf_pairs` runs the pairs the batched route refuses in as few
launches as ``strips.LAUNCH_BYTES`` of buffers allow.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from ..core.result import ExtzResult
from . import strips
from .bands import resolve_bands
from .batch_extf import _check_args, canonical_mis, extf_forward, pack_pairs
from .lg_tiles import (byte_groups, ctl_ptrs, launch_bytes, lg_buffers,
                       lg_layout, meta)


def extf_single_forward_cuda(qs, ts, qlen, tlen, w, mch: int, mis: int,
                             e: int, xdrop: int, lay=None):
    """Launch kernel 15 (``csrc/lg_fwd.cu``, tiles over many blocks) on
    the current stream; the contract of
    :func:`ops.batch_extf.extf_forward_plain` for targets of any length.
    ``lay`` is the launch's ``lg_tiles.LgLayout`` (by default
    ``lg_layout`` at ``extz_fwd.choose_tp``'s tile, from the lengths read
    back).  A launch whose buffers do not fit in the card's memory raises
    with their size."""
    B, Lq, Lt, dev = _check_args(qs, ts, qlen, tlen, w)
    if lay is None:
        lay = lg_layout("extf_fwd", qlen.cpu().numpy(), tlen.cpu().numpy(),
                        w.cpu().numpy())
    if lay.kind != "extf_fwd" or len(lay.n) != B:
        raise ValueError(f"a {lay.kind} layout of {len(lay.n)} pairs for "
                         f"{B} extf pairs")
    tbase, dbase, bbase = meta(lay, dev)
    rec = torch.empty((B, 9), dtype=torch.int32, device=dev)
    try:
        buf = lg_buffers(lay, dev)
    except torch.OutOfMemoryError as err:
        raise RuntimeError(f"this launch's buffers take "
                           f"{lay.device_bytes()} bytes, more than {dev} "
                           f"holds") from err
    ctl = ctl_ptrs(lay, buf["ctl"])
    lib = library()
    # the C entry launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.ksw2t_extf_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), tbase.data_ptr(), dbase.data_ptr(),
            bbase.data_ptr(), B, Lq, Lt, int(mch), int(mis), int(e),
            int(xdrop), lay.tp, lay.tiles, ctl["ticket"], ctl["progress"],
            buf["bnd"].data_ptr(), ctl["wlt"], buf["wst"].data_ptr(),
            ctl["stop"], rec.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "extf_fwd")
    LAUNCHES["extf_fwd"] += 1
    return rec


def _ez(rec_row) -> ExtzResult:
    ez = ExtzResult()
    ez.reset()
    ez.max, ez.max_t, ez.max_q = (int(rec_row[0]), int(rec_row[1]),
                                  int(rec_row[2]))
    ez.score = int(rec_row[7])
    ez.zdropped = bool(rec_row[8])
    return ez


def extf_pairs(pairs: Sequence, mch: int, mis: int, e: int, w,
               xdrop: int = -1, device="cuda") -> List[ExtzResult]:
    """extf2 of every (query, target) pair on kernel 15 (its plain version
    on the CPU), in as few launches as the byte budget allows; ``w`` a band
    per pair, < 0 unbanded."""
    if not pairs:
        return []
    pairs = list(pairs)
    wv = np.asarray(resolve_bands(pairs, w), np.int64)
    ql = np.array([len(q) for q, _ in pairs], np.int64)
    tl = np.array([len(t) for _, t in pairs], np.int64)
    out = []
    for lo, hi in byte_groups(launch_bytes("extf_fwd", ql, tl, wv),
                              strips.LAUNCH_BYTES):
        args = pack_pairs(pairs[lo:hi], wv[lo:hi], torch.device(device))
        lay = lg_layout("extf_fwd", ql[lo:hi], tl[lo:hi], wv[lo:hi])
        rec = extf_forward(*args, int(mch), canonical_mis(mis), int(e),
                           int(xdrop), cuda=functools.partial(
                               extf_single_forward_cuda, lay=lay))
        out.extend(_ez(r) for r in rec.cpu().numpy())
    return out


def extf2_device(query: np.ndarray, target: np.ndarray, mch: int, mis: int,
                 e: int, w: int = -1, xdrop: int = -1,
                 device="cuda") -> ExtzResult:
    """Run the extf forward for one pair; returns the ez record (score,
    max, max_t, max_q, zdropped)."""
    if len(query) <= 0 or len(target) <= 0:
        ez = ExtzResult()
        ez.reset()
        return ez
    return extf_pairs([(np.asarray(query), np.asarray(target))], mch, mis,
                      e, [w], xdrop, device)[0]


__all__ = ["extf_single_forward_cuda", "extf_pairs", "extf2_device"]
