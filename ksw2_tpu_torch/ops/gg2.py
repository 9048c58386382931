"""The single-pair banded global alignment: kernel 16's wrapper, its H0
walk in closed form and ``gg2_device``.

Port of ``ksw2_tpu/ops/gg2.py:gg2_device`` with the kernel
``wavefront_gg2.py:_gg2_kernel_body``: ``csrc/lg_fwd.cu`` in its
``MODE_GG2`` form (counted as ``gg2_fwd``), which spreads each pair over
many blocks in tiles of target positions (``ops/lg_tiles.py``); its plain
version is kernel 8's, ``ops.batch_gg2.gg2_forward_plain`` with
``overrun``.  gg2's H0 walk follows the band's geometry alone, so the
byte it reads on each diagonal is known before the forward
(:func:`gg2_walk_reads`), also where ``qlen > tlen + w`` runs it off u
into the reference's contiguous u, v, x, y, s block
(``wavefront_gg2.py:15-20``); the tile that owns a read's position takes
it.  It writes the same flat store as kernel 8, walked on the card by
``band_walk.cu``'s flat form from the corner, so the JAX host wrapper's
escape and replay (``gg2.py:114-138``) and kernel 17's escape flag are
not needed.  ``w < 0`` is ``max(qlen, tlen)``.  A launch takes any
number of pairs (:func:`gg2_pairs`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import LAUNCHES, check, library
from .bands import band_bounds, resolve_bands
from .batch_gg2 import _gg2_check, gg2_run
from .lg_tiles import ctl_ptrs, lg_buffers, lg_layout, meta


def gg2_walk_reads(qlen: int, tlen: int, w: int) -> np.ndarray:
    """The block index (u at 0, v at ``NS``, then x, y and s; ``NS`` the
    target rounded up to 16) of the byte gg2's H0 walk reads on each of
    the ``qlen + tlen - 1`` diagonals, in closed form (``csrc/lg_fwd.cu:
    gg2_read``).  The walk (``ksw2_gg2_sse.c:102-106``) reads v[lt] while
    lt lies in [st0, en0] and u[lt + 1] otherwise, stepping on: lt is
    st0(r) while the band meets the target, so it reads v[st0] where st0
    stays and u[st0] where it moves on; once the band has run off the
    target end (``r >= 2 tlen + w - 1``, only when ``qlen > tlen + w``) it
    reads u[lt + 1] with lt = r - tlen - w a diagonal; with an empty
    query every band is empty and it reads u[r].  Past u the index runs on
    into the block; past ``5 NS + 16`` the byte is 0."""
    nd = qlen + tlen - 1
    if nd <= 0 or tlen <= 0:
        return np.zeros(0, np.int64)
    NS = (tlen + 15) // 16 * 16
    r = np.arange(nd, dtype=np.int64)
    if qlen <= 0:
        f = r.copy()
    else:
        st0, _ = band_bounds(nd, qlen, tlen, w)
        st0 = np.asarray(st0, np.int64)
        st0p = np.concatenate([[0], st0[:-1]])
        f = np.where(st0 == st0p, NS + st0p, st0)
        run = r >= 2 * tlen + w - 1
        f[run] = r[run] - tlen - w + 1
    f[0] = NS
    return f


def gg2_single_forward_cuda(qs, ts, qlen, tlen, w, table, m: int, q: int,
                            e: int, pbase, total: int, lay=None):
    """Launch kernel 16 (``csrc/lg_fwd.cu``, tiles over many blocks) on
    the current stream; the contract of ``batch_gg2.gg2_forward_plain``
    with ``overrun`` True, for targets of any length.  ``lay`` is the
    launch's ``lg_tiles.LgLayout`` (by default ``lg_layout`` at
    ``extz_fwd.choose_tp``'s tile, from the lengths read back).  A launch whose buffers do not fit in
    the card's memory raises with their size."""
    B, Lq, Lt, dev = _gg2_check(qs, ts, qlen, tlen, w, table, m, pbase)
    if lay is None:
        lay = lg_layout("gg2_fwd", qlen.cpu().numpy(), tlen.cpu().numpy(),
                        w.cpu().numpy())
    if lay.kind != "gg2_fwd" or len(lay.n) != B:
        raise ValueError(f"a {lay.kind} layout of {len(lay.n)} pairs for "
                         f"{B} gg2 pairs")
    tbase, _, bbase = meta(lay, dev)
    score = torch.zeros(B, dtype=torch.int32, device=dev)
    try:
        buf = lg_buffers(lay, dev)
        p = torch.zeros(max(total, 16), dtype=torch.uint8, device=dev)
    except torch.OutOfMemoryError as err:
        raise RuntimeError(f"this launch's buffers take "
                           f"{lay.device_bytes() + total} bytes ({total} of "
                           f"direction bytes), more than {dev} holds") \
            from err
    ctl = ctl_ptrs(lay, buf["ctl"])
    lib = library()
    with torch.cuda.device(dev):
        err = lib.ksw2t_gg2_fwd(
            qs.data_ptr(), ts.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            w.data_ptr(), table.data_ptr(), tbase.data_ptr(),
            bbase.data_ptr(), pbase.data_ptr(), B, Lq, Lt, int(m), int(q),
            int(e), lay.tp, lay.tiles, ctl["ticket"], ctl["progress"],
            buf["bnd"].data_ptr(), score.data_ptr(), p.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gg2_fwd")
    LAUNCHES["gg2_fwd"] += 1
    return score, p[:total]


def gg2_pairs(pairs: Sequence, m: int, mat, q: int, e: int, w,
              device="cuda") -> List[Tuple[int, list]]:
    """gg2_sse of every (query, target) pair on kernel 16 and the flat
    walk (their plain versions on the CPU), in as few launches as the
    byte budget allows; ``w`` a band per pair, < 0 unbanded.  Returns
    (score, cigar) a pair."""
    if not pairs:
        return []
    return gg2_run(list(pairs), m, mat, q, e, resolve_bands(pairs, w), True,
                   device)


def gg2_device(query: np.ndarray, target: np.ndarray, m: int, mat, q: int,
               e: int, w: int = -1, device="cuda"
               ) -> Tuple[int, List[int], Optional[object]]:
    """Run the gg2 forward and walk for one pair; returns (score, cigar,
    None), the JAX function's triple without its host ``Trace``."""
    score, cig = gg2_pairs([(np.asarray(query), np.asarray(target))], m,
                           mat, q, e, [w], device)[0]
    return score, cig, None


__all__ = ["gg2_walk_reads", "gg2_single_forward_cuda", "gg2_pairs",
           "gg2_device"]
