"""The tiles of kernels 15 and 16 (``csrc/lg_fwd.cu``): the launch layout,
its buffers and the split of a batch into launches.

Kernel 15 (the single-pair linear-gap forward, ``ops/extf.py``) and
kernel 16 (the single-pair global forward, ``ops/gg2.py``) spread each
pair over blocks as kernel 12 does (``ops/extz_fwd.py``): its target axis
in tiles of ``tp`` positions (32 or 64, ``extz_fwd.choose_tp``), one warp
a tile, the tile's state in registers, and its last position's state
handed on to the next tile through a per-diagonal history.  A pair runs
``n`` diagonals: its first empty one (``rlim``, extf) or all ``qlen +
tlen - 1`` (gg2); a tile runs the diagonals of :func:`tile_range` (the
device's ``common.cuh:tile_first`` / ``tile_last``), which cover every
position its band ``[st, en]`` and extf's score fill (up to 15 past
``en0``) touch.  The history holds a byte a diagonal for extf (v) and two
for gg2 (x, v); extf also keeps a walk record a diagonal (its lt, 4
bytes, and (H0, max, max_t, max_q), 16 bytes) through which the next
tile takes the H0 walk over, and a stop word a pair.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .bands import first_empty_diag
from .extz_fwd import TILES, choose_tp

KINDS = ("extf_fwd", "gg2_fwd")
ENTRY_BYTES = {"extf_fwd": 1, "gg2_fwd": 2}   # a history entry
WALK_BYTES = 4 + 16                           # extf: lt, (H0, max, t, q)


def n_diags(kind: str, qlen, tlen, w) -> np.ndarray:
    """The diagonals each pair runs (int64): extf's first empty one, 0 for
    an empty sequence (the kernel writes the reset record); gg2's ``qlen +
    tlen - 1``, 0 for an empty target (no cell is computed)."""
    qlen, tlen, w = (np.asarray(a, np.int64) for a in (qlen, tlen, w))
    if kind == "extf_fwd":
        n = np.where((qlen > 0) & (tlen > 0),
                     first_empty_diag(qlen, tlen, w), 0)
    elif kind == "gg2_fwd":
        n = np.where(tlen > 0, qlen + tlen - 1, 0)
    else:
        raise ValueError(f"{kind}: want one of {KINDS}")
    return np.maximum(np.asarray(n, np.int64), 0)


def n_tiles(tlen, tp: int) -> np.ndarray:
    """Tiles a pair (int64): its positions up to ``tlen + 14``, where the
    rounded band and extf's score fill end."""
    return -(-(np.asarray(tlen, np.int64) + 15) // tp)


def tile_range(t0, tp: int, qlen, w, n) -> Tuple[np.ndarray, np.ndarray]:
    """The first and last diagonal of the tile starting at ``t0``
    (``common.cuh:tile_first`` / ``tile_last``): from where ``en0`` may be
    within 15 of ``t0`` to where ``st0`` passes the tile, below ``n``."""
    t0, qlen, w, n = (np.asarray(a, np.int64) for a in (t0, qlen, w, n))
    x = t0 - 15
    first = np.where(t0 == 0, 0, np.maximum(x, 2 * x - w))
    X = t0 + tp - 1
    last = np.minimum(np.minimum(n - 1, X + qlen - 1), 2 * X + w)
    return first, last


class LgLayout(NamedTuple):
    """Where a launch's pairs live in the kernel's buffers (host arrays):
    pair b runs ``n[b]`` diagonals, takes tiles ``tbase[b] .. tbase[b + 1]
    - 1``, its walk records (extf) from ``dbase[b]`` and its history from
    ``bbase[b]`` (``tiles - 1`` edges of ``n`` entries)."""
    kind: str
    tp: int
    n: np.ndarray
    tbase: np.ndarray
    dbase: np.ndarray
    bbase: np.ndarray
    n_diag: int
    n_bnd: int

    @property
    def tiles(self) -> int:
        return int(self.tbase[-1])

    def device_bytes(self) -> int:
        """The bytes of :func:`lg_buffers` (an empty buffer takes one
        entry, so that it has an address)."""
        out = 4 * ctl_offsets(self)["end"] + \
            ENTRY_BYTES[self.kind] * max(self.n_bnd, 1)
        if self.kind == "extf_fwd":
            out += 16 * max(self.n_diag, 1)
        return out


def _excl(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a, out=out[1:])
    return out


def lg_layout(kind: str, qlen, tlen, w, tp: int = None) -> LgLayout:
    """The launch's layout for tiles of ``tp`` positions (one of
    ``extz_fwd.TILES``; by default ``extz_fwd.choose_tp``'s)."""
    tp = choose_tp(tlen) if tp is None else int(tp)
    if tp not in TILES:
        raise ValueError(f"tile of {tp} positions: want one of {TILES}")
    n = n_diags(kind, qlen, tlen, w)
    tiles = n_tiles(tlen, tp)
    tb = _excl(tiles)
    db = _excl(n if kind == "extf_fwd" else np.zeros_like(n))
    bb = _excl((tiles - 1) * n)
    return LgLayout(kind, tp, n, tb.astype(np.int32), db[:-1], bb[:-1],
                    int(db[-1]), int(bb[-1]))


def ctl_offsets(lay: LgLayout) -> Dict[str, int]:
    """Where each control word lies in :func:`lg_buffers`'s ``ctl`` (in
    int32s): the ticket, extf's stop words (one a pair), each tile's
    progress and extf's walk lt (one a diagonal)."""
    B = len(lay.n) if lay.kind == "extf_fwd" else 0
    nd = max(lay.n_diag, 1) if lay.kind == "extf_fwd" else 0
    progress = 1 + B
    wlt = progress + lay.tiles
    return {"ticket": 0, "stop": 1, "progress": progress, "wlt": wlt,
            "end": wlt + nd}


def lg_buffers(lay: LgLayout, dev) -> Dict[str, torch.Tensor]:
    """The kernel's work buffers on ``dev``, initialised as it wants them
    with two fills: ``ctl``, int32, holds the ticket (0), extf's stop
    words (0), each tile's progress (-1) and extf's walk lt (-1)
    (:func:`ctl_offsets`); ``bnd`` the history and, extf, ``wst`` the walk
    records (H0, max, max_t, max_q)."""
    off = ctl_offsets(lay)
    ctl = torch.full((off["end"],), -1, dtype=torch.int32, device=dev)
    ctl[:off["progress"]].zero_()
    extf = lay.kind == "extf_fwd"
    entry = torch.uint8 if extf else torch.int16
    out = {"ctl": ctl,
           "bnd": torch.empty(max(lay.n_bnd, 1), dtype=entry, device=dev)}
    if extf:
        out["wst"] = torch.empty((max(lay.n_diag, 1), 4), dtype=torch.int32,
                                 device=dev)
    return out


def ctl_ptrs(lay: LgLayout, ctl: torch.Tensor) -> Dict[str, int]:
    """The addresses of :func:`ctl_offsets`'s words in ``ctl``."""
    base = ctl.data_ptr()
    return {k: base + 4 * v for k, v in ctl_offsets(lay).items()}


def meta(lay: LgLayout, dev):
    """The layout's tile and base arrays on ``dev`` (pinned, async):
    tbase, dbase, bbase."""
    host = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (lay.tbase, lay.dbase, lay.bbase)]
    return [t.pin_memory().to(dev, non_blocking=True) for t in host]


def launch_bytes(kind: str, qlen, tlen, w) -> np.ndarray:
    """Each pair's device buffers (int64) at the narrower tile, which has
    the most edges: its history and extf's walk records."""
    n = n_diags(kind, qlen, tlen, w)
    edges = n_tiles(tlen, TILES[0]) - 1
    out = ENTRY_BYTES[kind] * edges * n
    if kind == "extf_fwd":
        out = out + WALK_BYTES * n
    return out


def byte_groups(size, limit: int) -> List[Tuple[int, int]]:
    """Consecutive index ranges whose ``size`` sums stay within ``limit``
    (a pair larger than that goes alone)."""
    out, lo, acc = [], 0, 0
    size = np.asarray(size, np.int64)
    for k, sz in enumerate(size):
        if k > lo and acc + sz > limit:
            out.append((lo, k))
            lo, acc = k, 0
        acc += int(sz)
    if len(size):
        out.append((lo, len(size)))
    return out


__all__ = ["KINDS", "ENTRY_BYTES", "WALK_BYTES", "n_diags", "n_tiles",
           "tile_range", "LgLayout", "lg_layout", "ctl_offsets",
           "lg_buffers", "ctl_ptrs", "meta", "launch_bytes", "byte_groups"]
