"""The windowed walk of kernels 17, D and B (``csrc/walk.cuh``), modelled.

The walkers give one warp a pair and read each step's byte from a window
of ``R`` rows of the store staged in shared memory: anchored at a cell
(i0, r0), row r0 - d holds the 16-byte chunks of [i0 - d, i0] that lie in
the row's stored bytes, in a slot of ceil(d / 16) + 1 chunks; once the walk
is ``HALF`` rows into its window (and the window does not reach row 0) the
window anchored at the current cell is staged into the other buffer, and
the walk switches to it when it leaves the first.  Reads the window cannot
hold go to the store directly (the flat form's overruns past a row and
past the store).  Kernel B's row-major store (``d8[i][j]``, the strips
forward's) holds the same triangle transposed: store row i0 - k at j in
[j0 - (R - 1 - k), j0], in the slot of anti-diagonal row R - 1 - k.  The
NumPy model below has the kernel's staging geometry,
restage rule and direct reads; it asserts that every read from a window
finds a staged byte and lies in the triangle, and it walks the stores of
the port's plain forwards (compact one-piece, two-piece and splice stores,
rotated band and batched bytes, splice bytes with ``min_intron``, gg2's
flat store with overruns, the strips forward's one-piece, two-piece and
splice bytes) and random stores deep enough to cross hundreds of
windows, exactly as the plain walkers (``extz_walk_plain``,
``band_walk_plain``, ``flat_walk_plain``, ``strips_walk_plain``) walk
them, and on a few small pairs as the JAX strips walker does.  Compact,
rotated and row-major stores make no direct read; the overrunning flat
walks do.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as CS
from ksw2_tpu.ops import strips_walker as jsw
from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.core.matrix import encode_dna, simple_mat
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import band_walker as BW
from ksw2_tpu_torch.ops import batch_exts as BE
from ksw2_tpu_torch.ops import batch_gg2 as BG
from ksw2_tpu_torch.ops import extd as ED
from ksw2_tpu_torch.ops import exts as ES
from ksw2_tpu_torch.ops import extz_fwd as F
from ksw2_tpu_torch.ops import strips as S
from ksw2_tpu_torch.ops import strips_walker as W
from ksw2_tpu_torch.ops import traceback_device as TB
from ksw2_tpu_torch.ops.bands import first_empty_diag
from ksw2_tpu_torch.ops.batch_extf import pack_pairs

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

WALK_CUH = Path(__file__).resolve().parents[1] / "ksw2_tpu_torch" / "csrc" \
    / "walk.cuh"


def _const(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", WALK_CUH.read_text())
    return m.group(1)


R = int(_const("R"))
HALF = R // 2
LOOK = int(_const("LOOK"))
REACH = int(_const("REACH"))


def slot_base(d):
    """walk.cuh's ``slot_base``: bytes of the slots of rows 0 .. d - 1."""
    if d <= 0:
        return 0
    q, rem = (d - 1) >> 4, (d - 1) & 15
    return 16 * (d + 8 * q * (q + 1) + rem * (q + 1))


WIN = slot_base(R)


def slot_row(k):
    """walk.cuh's ``slot_row``: the row-major store row i0 - k's slot, the
    slot of anti-diagonal row R - 1 - k."""
    return WIN - slot_base(R - k)


def band_st_en(r, qlen, tlen, w):
    st0 = max(0, r - qlen + 1, (r - w + 1) >> 1)
    en0 = min(tlen - 1, r, (r + w) >> 1)
    return st0 & ~15, en0 | 15


class Store:
    """One pair's store as a walker sees it: ``form`` compact (kernel 17),
    rotated or flat (kernel D) or row-major (kernel B: ``nd`` = tv rows
    of ``ncol`` = Lq bytes, no band), its bytes ``p`` from ``base``, the
    rows it holds and (rotated, flat, row-major) their width."""

    def __init__(self, form, p, base, qlen, tlen, w, ncol=0, nd=0):
        self.form, self.p, self.base = form, p, int(base)
        self.qlen, self.tlen, self.w = int(qlen), int(tlen), int(w)
        assert self.base % 16 == 0
        if form == "rowmajor":
            self.rows, self.ncol = int(nd), int(ncol)
            assert self.ncol % 16 == 0
            self.end = self.base + nd * ncol
        elif form == "compact":
            self.rows = int(first_empty_diag(qlen, tlen, w))
            self.ncol = 0
            self.end = self.base + int(F.row_off(self.rows, qlen, tlen, w)[0])
        elif form == "rotated":
            self.rows, self.ncol = int(nd), int(ncol)
            self.end = self.base + nd * ncol
        else:
            self.ncol = int(BG.gg2_ncol(tlen, w))
            self.rows = self.qlen + self.tlen
            self.end = self.base + self.rows * self.ncol
        self.size = self.rows * self.ncol

    def band(self, r):
        return band_st_en(r, self.qlen, self.tlen, self.w)

    def width(self, r):
        st, en = self.band(r)
        return en - st + 1

    def row_hi(self, r, st, en):
        if self.form == "compact":
            return en if r < self.rows else -1
        if self.form == "rotated":
            return min(en, st + self.ncol - 1) if r < self.rows else -1
        return st + self.ncol - 1

    def is_direct(self, r, i, st):
        if self.form == "compact":
            return r >= self.rows
        if self.form == "rotated":
            return r >= self.rows or i - st >= self.ncol
        return i - st >= self.ncol


class Window:
    """A staged window: the anchor, the slots (-1 where nothing was
    staged) and, compact, the rows' offsets below the anchor's."""

    def __init__(self, s: Store, i0, r0, off0, stats):
        self.i0, self.r0, self.off0 = i0, r0, off0
        self.buf = np.full(WIN, -1, np.int16)
        self.rel = np.zeros(R, np.int64)
        stats["windows"] += 1
        if s.form == "rowmajor":
            self._stage_rows(s, stats)
            return
        carry = 0
        for d in range(R):
            r = r0 - d
            if s.form == "compact":
                self.rel[d] = carry
                carry += s.width(r - 1) if r >= 1 else 0
                roff = off0 - self.rel[d]
            else:
                roff = r * s.ncol
            if r < 0:
                continue
            st, en = s.band(r)
            lo, hi = max(i0 - d, st), min(i0, s.row_hi(r, st, en))
            if lo > hi:
                continue
            sb = slot_base(d) - ((i0 - d) & ~15)
            for c in range(lo >> 4, (hi >> 4) + 1):
                src = s.base + roff - st + 16 * c
                dst = sb + 16 * c
                # a whole aligned chunk of the pair's store, of this row,
                # into this row's slot
                assert src % 16 == 0 and s.base <= src and src + 16 <= s.end
                assert st <= 16 * c and 16 * c + 16 <= st + (
                    s.width(r) if s.form == "compact" else s.ncol)
                assert slot_base(d) <= dst and dst + 16 <= slot_base(d + 1)
                self.buf[dst:dst + 16] = s.p[src:src + 16]
                stats["chunks"] += 1
        assert carry < 2 ** 31       # the kernel keeps rel in an int

    def _stage_rows(self, s: Store, stats):
        """The row-major window: store row i0 - k's chunks of [max(j0 -
        (R - 1 - k), 0), j0] into the slot at ``slot_row(k)``."""
        j0 = self.r0 - self.i0
        assert 0 <= j0 < s.ncol and 0 <= self.i0 < s.rows
        for k in range(R):
            i, jlo = self.i0 - k, j0 - (R - 1 - k)
            if i < 0:
                continue
            sb = slot_row(k) - (jlo & ~15)
            for c in range(max(jlo, 0) >> 4, (j0 >> 4) + 1):
                src = s.base + i * s.ncol + 16 * c
                dst = sb + 16 * c
                # a whole aligned chunk of this store row, into its slot
                assert src % 16 == 0 and 16 * c + 16 <= s.ncol
                assert src + 16 <= s.end
                assert slot_row(k) <= dst and dst + 16 <= slot_row(k + 1)
                self.buf[dst:dst + 16] = s.p[src:src + 16]
                stats["chunks"] += 1


def cell_code(s: Store, win, i, r, upper_force):
    """What a step does at cell (i, r) of window ``win`` (walk.cuh's
    ``cell_code``): "E" or "F" (a force), "esc" (compact with upper_force
    0 above the band), "direct" (a byte the window does not hold) or
    "read"; the row-major store holds every cell fewer than R
    anti-diagonals from the window's anchor."""
    if s.form == "rowmajor":
        return "direct" if win.r0 - r >= R else "read"
    st, en = s.band(r)
    if s.form != "flat" and i > en:
        return "esc" if s.form == "compact" and not upper_force else "E"
    if i < st:
        return "F"
    return "direct" if s.is_direct(r, i, st) else "read"


def model_walk(s: Store, i, j, min_intron=0, upper_force=1):
    """walk.cuh's ``walk_pair`` on one pair: ((i_end, j_end, escaped),
    runs, stats).  The walk goes in blocks of up to LOOK steps; at a
    block's start it switches to the window in flight once its reads
    could reach past the current one (REACH rows), and issues the next
    window once it is HALF rows into the current one; a block stops
    before a cell that escapes or reads the store directly, which then
    takes a step of its own."""
    stats = {"windows": 0, "chunks": 0, "reads": 0, "direct": 0,
             "past": 0, "steps": 0, "blocks": 0}
    runs, state, n, op, esc = [], 0, 0, -1, 0
    big = 1 << 62

    def read(win, i, r, code):
        d = win.r0 - r
        if s.form == "rowmajor":
            return read_rows(win, i, r - i, d, code)
        assert 0 <= d < R and win.i0 - d <= i <= win.i0
        st = s.band(r)[0]
        stats["reads"] += 1
        if code == "direct":
            stats["direct"] += 1
            if s.form == "compact":
                k = win.off0 - int(win.rel[d]) + i - st
                return int(s.p[s.base + k])
            if s.form == "rotated":
                return int(s.p[s.base + r * s.ncol + i - st])
            k = r * s.ncol + i - st
            stats["past"] += k >= s.size
            return int(s.p[s.base + k]) if k < s.size else 0
        v = int(win.buf[slot_base(d) + i - ((win.i0 - d) & ~15)])
        assert v >= 0, f"unstaged byte at r={r} i={i}"
        return v

    def read_rows(win, i, j, d, code):
        stats["reads"] += 1
        if code == "direct":
            stats["direct"] += 1
            return int(s.p[s.base + i * s.ncol + j])
        k, j0 = win.i0 - i, win.r0 - win.i0
        # the transposed triangle: row k of the window at j in [j0 - d +
        # k, j0], inside the row's slot
        assert 0 <= d < R and 0 <= k <= d and j0 - d + k <= j <= j0
        v = int(win.buf[slot_row(k) + j - ((j0 - (R - 1 - k)) & ~15)])
        assert v >= 0, f"unstaged byte at i={i} j={j}"
        return v

    if i >= 0 and j >= 0:
        r0 = i + j
        off0 = int(F.row_off(r0, s.qlen, s.tlen, s.w)[0]) \
            if s.form == "compact" else 0
        win, nxt = Window(s, i, r0, off0, stats), None
        dact = HALF if win.r0 >= R else big
        while True:
            d = win.r0 - (i + j)
            if d >= dact:
                if nxt is not None:
                    win, nxt = nxt, None
                    d = win.r0 - (i + j)
                if d >= HALF and win.r0 >= R:
                    nxt = Window(s, i, i + j, win.off0 - int(win.rel[d]),
                                 stats)
                dact = R - REACH if nxt is not None else \
                    HALF if win.r0 >= R else big
            stats["blocks"] += 1
            for k in range(LOOK):
                code = cell_code(s, win, i, i + j, upper_force)
                if code in ("esc", "direct") and k > 0:
                    break           # the next block's own step
                if code == "esc":
                    esc = 1
                    break
                tmp = read(win, i, i + j, code) if code in ("read",
                                                            "direct") \
                    else 0
                if state == 0:
                    state = tmp & 7
                elif not (tmp >> (state + 2)) & 1:
                    state = 0
                if state == 0:
                    state = tmp & 7
                if code in ("E", "F"):
                    state = 1 if code == "E" else 2
                o = W.state_op(state, min_intron if s.form != "flat" else 0)
                if o != 1:
                    i -= 1
                if o in (0, 1):
                    j -= 1
                stats["steps"] += 1
                if o == op:
                    n += 1
                else:
                    if n > 0:
                        runs.append((n << 4) | op)
                    op, n = o, 1
                if i < 0 or j < 0 or code == "direct":
                    break
            if esc or i < 0 or j < 0:
                break
    if n > 0:
        runs.append((n << 4) | op)
    return (i, j, esc), runs, stats


def _check(stores, starts, res, runs, min_intron=0, upper_force=1):
    """Each pair's model walk against a plain walker's (res, runs);
    returns the summed stats."""
    tot = {}
    for b, s in enumerate(stores):
        (i, j, esc), rl, st = model_walk(s, int(starts[b][0]),
                                         int(starts[b][1]), min_intron,
                                         upper_force)
        k = int(res[b, 2])
        assert (i, j, len(rl)) == (int(res[b, 0]), int(res[b, 1]), k), b
        if res.shape[1] == 4:
            assert esc == int(res[b, 3]), b
        assert rl == [int(x) for x in runs[b, :k]], b
        for key, v in st.items():
            tot[key] = tot.get(key, 0) + v
    return tot


# ---------------------------------------------------------------- stores


def _pairs(seed, lens, div=0.15, indel=0.06, with_n=False):
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        t, q = CS.random_pair(rng, L, divergence=div, indel=indel,
                              with_n=with_n)
        out.append((encode_dna(q), encode_dna(t)))
    return out


def _compact(ln, kind, eb, upper_force=1, min_intron=None):
    """Kernels 12-14's plain forward on launch ``ln``, then the model
    against ``extz_walk_plain`` on its compact store."""
    args = BD.band_upload(ln, "cpu")
    fwd = {"extz": F.extz_forward_plain, "extd": ED.extd_forward_plain,
           "exts": ES.exts_forward_plain}[kind]
    rec, p, _ = fwd(*args, ln.prm, ln.lay)
    _, _, ql, tl, w = args[:5]
    starts = W.start_cells(rec, ql, tl, ln.prm.flag, eb)
    mi = (ln.prm.lt if kind == "exts" else 0) if min_intron is None \
        else min_intron
    wr = ln.query.shape[1] + ln.target.shape[1] + 2
    pb = torch.from_numpy(ln.lay.pbase)
    res, runs = TB.extz_walk_plain(p, pb, starts, ql, tl, w, wr, mi,
                                   upper_force)
    pn = p.numpy()
    stores = [Store("compact", pn, ln.lay.pbase[b], ql[b], tl[b], w[b])
              for b in range(len(ql))]
    return _check(stores, starts.numpy(), res.numpy(), runs.numpy(), mi,
                  upper_force)


def _rotated(ln, eb=0, plain=BD.band_forward_plain, min_intron=0):
    """The band (or batched, or batched exts) plain forward on ``ln``, then
    the model against ``band_walk_plain`` on its rotated bytes."""
    args = BD.band_upload(ln, "cpu")
    rec, p = plain(*args, ln.prm, ln.nd, ln.ncol)
    _, _, ql, tl, w = args[:5]
    starts = W.start_cells(rec, ql, tl, ln.prm.flag, eb)
    res, runs = BW.band_walk_plain(p, starts, ql, tl, w, min_intron)
    pn = p.numpy().reshape(-1)
    B, nd, ncol = p.shape
    stores = [Store("rotated", pn, b * nd * ncol, ql[b], tl[b], w[b], ncol,
                    nd) for b in range(B)]
    return _check(stores, starts.numpy(), res.numpy(), runs.numpy(),
                  min_intron)


def _flat(pairs, ws):
    """Kernel 16's plain forward (the reference's overrun) on ``pairs``,
    then the model against ``flat_walk_plain`` on its flat store."""
    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32))
    wr = [w if w >= 0 else max(len(q), len(t)) for (q, t), w in
          zip(pairs, ws)]
    args = pack_pairs(pairs, wr, "cpu")
    ql, tl, wt = args[2:]
    pb, total = BG.flat_layout(ql.numpy(), tl.numpy(), wt.numpy())
    _, p = BG.gg2_forward_plain(*args, table, 5, 4, 2, torch.from_numpy(pb),
                                total, True)
    res, runs = BW.flat_walk_plain(p, torch.from_numpy(pb), ql, tl, wt)
    pn = p.numpy()
    stores = [Store("flat", pn, pb[b], ql[b], tl[b], wt[b])
              for b in range(len(pairs))]
    starts = np.stack([tl.numpy() - 1, ql.numpy() - 1], 1)
    return _check(stores, starts, res.numpy(), runs.numpy())


def _random_bytes(rng, n, states=3):
    """Direction bytes: mostly state 0 (M), continuation bits at random."""
    st = rng.choice(states, n, p=[0.6] + [0.4 / (states - 1)] * (states - 1))
    return (st | (rng.integers(0, 16, n) << 3)).astype(np.uint8)


def _random_compact(rng, qlen, tlen, w, starts, min_intron=0,
                    upper_force=1, states=3):
    rows = int(first_empty_diag(qlen, tlen, w))
    size = int(F.row_off(rows, qlen, tlen, w)[0])
    p = torch.from_numpy(_random_bytes(rng, size + 32, states))
    one = lambda v: torch.tensor([v], dtype=torch.int32)   # noqa: E731
    tot = {}
    for st_ in starts:
        sts = torch.tensor([st_], dtype=torch.int32)
        res, runs = TB.extz_walk_plain(p, torch.zeros(1, dtype=torch.int64),
                                       sts, one(qlen), one(tlen), one(w),
                                       qlen + tlen + 2, min_intron,
                                       upper_force)
        s = Store("compact", p.numpy(), 0, qlen, tlen, w)
        for k, v in _check([s], [st_], res.numpy(), runs.numpy(),
                           min_intron, upper_force).items():
            tot[k] = tot.get(k, 0) + v
    return tot


def _random_rotated(rng, qlen, tlen, w, starts, min_intron=0):
    nd = qlen + tlen - 1
    ncol = max(band_st_en(r, qlen, tlen, w)[1] - band_st_en(r, qlen, tlen,
                                                            w)[0] + 1
               for r in range(nd))
    p = torch.from_numpy(_random_bytes(rng, len(starts) * nd * ncol)
                         .reshape(len(starts), nd, ncol))
    B = len(starts)
    full = lambda v: torch.full((B,), v, dtype=torch.int32)   # noqa: E731
    sts = torch.tensor(starts, dtype=torch.int32)
    res, runs = BW.band_walk_plain(p, sts, full(qlen), full(tlen), full(w),
                                   min_intron)
    pn = p.numpy().reshape(-1)
    stores = [Store("rotated", pn, b * nd * ncol, qlen, tlen, w, ncol, nd)
              for b in range(B)]
    return _check(stores, starts, res.numpy(), runs.numpy(), min_intron)


def _random_flat(rng, dims):
    ql = np.array([q for q, _, _ in dims], np.int32)
    tl = np.array([t for _, t, _ in dims], np.int32)
    wt = np.array([w for _, _, w in dims], np.int32)
    pb, total = BG.flat_layout(ql, tl, wt)
    p = _random_bytes(rng, total)
    ncol = BG.gg2_ncol(tl, wt)
    for b in range(len(dims)):     # the zero row after each pair's rows
        end = int(pb[b] + (ql[b] + tl[b]) * ncol[b])
        p[end - int(ncol[b]):end] = 0
    pt = torch.from_numpy(p)
    res, runs = BW.flat_walk_plain(pt, torch.from_numpy(pb),
                                   *(torch.from_numpy(a) for a in (ql, tl,
                                                                   wt)))
    stores = [Store("flat", p, pb[b], ql[b], tl[b], wt[b])
              for b in range(len(dims))]
    return _check(stores, np.stack([tl - 1, ql - 1], 1), res.numpy(),
                  runs.numpy())


def _rowmajor(ln, eb=0):
    """Kernel A's plain forward on strips launch ``ln``, then the model
    against ``strips_walk_plain`` on its row-major bytes; returns the
    stats, the records and the walker's (res, runs)."""
    args = S.upload(ln, "cpu")
    _, Dq, hl, d8 = D4 = S.strips_forward(*args, ln.prm,
                                          S.site_rows(ln, "cpu"))
    _, _, ql, tl, _ = args
    rec = S.replay_records(ln.prm, D4[0], Dq, hl, ql, tl)
    starts = W.start_cells(rec, ql, tl, ln.prm.flag, eb)
    mi = W.walk_min_intron(ln.prm.lt, ln.prm.spl)
    res, runs = W.strips_walk_plain(d8, starts, mi)
    B, tv, Lq = d8.shape
    pn = d8.numpy().reshape(-1)
    stores = [Store("rowmajor", pn, b * tv * Lq, 0, 0, 0, Lq, tv)
              for b in range(B)]
    st = _check(stores, starts.numpy(), res.numpy(), runs.numpy(), mi)
    return st, rec.numpy(), res.numpy(), runs.numpy()


def _random_rowmajor(rng, tv, Lq, starts, min_intron=0, states=3):
    """Random row-major bytes (one (tv, Lq) store a start), walked by the
    model and by ``strips_walk_plain``."""
    B = len(starts)
    d8 = torch.from_numpy(_random_bytes(rng, B * tv * Lq, states)
                          .reshape(B, tv, Lq))
    sts = torch.tensor(starts, dtype=torch.int32)
    res, runs = W.strips_walk_plain(d8, sts, min_intron)
    pn = d8.numpy().reshape(-1)
    stores = [Store("rowmajor", pn, b * tv * Lq, 0, 0, 0, Lq, tv)
              for b in range(B)]
    return _check(stores, starts, res.numpy(), runs.numpy(), min_intron)


# ----------------------------------------------------------------- tests


def test_window_constants_and_slots():
    """The window's slots hold every chunk a row can need: row d of a
    window anchored at any i0 spans (i0 >> 4) - ((i0 - d) >> 4) + 1
    chunks, at most its slot's ceil(d / 16) + 1; the slots of the R rows
    are WIN bytes, and a pair's two windows with their row tables (16
    bytes a row, R + 8 rows), offsets and request fit 48 KB of static
    shared memory, at least 8 blocks to an SM's 228 KB (1 KB a block
    reserved)."""
    assert R % 32 == 0 and R >= 64
    # a block's lanes guess its first LOOK - 1 movements (3 ** 3 = 27 of
    # 32 lanes); its reads reach LOOK - 1 M steps below its first cell,
    # inside the table's 8 rows of padding
    assert 3 ** (LOOK - 1) <= 32 and REACH == 2 * (LOOK - 1) <= 8
    assert REACH < HALF
    for d in range(R + 1):
        assert slot_base(d) == 16 * sum(-(-k // 16) + 1 for k in range(d))
    for d in range(R):
        size = slot_base(d + 1) - slot_base(d)
        for i0 in range(d, d + 64):
            assert 16 * ((i0 >> 4) - ((i0 - d) >> 4) + 1) <= size
    # and the stager's request (the anchor, 16 bytes, and its buffer) and
    # next_states' 32 masks
    smem = -(-(2 * WIN + 2 * 16 * (R + 8) + 2 * 4 * R + 16 + 4 + 4 * 32)
             // 16) * 16
    assert smem <= 48 * 1024 and 8 * (smem + 1024) <= 228 * 1024
    # the row-major store's slots: row k's is anti-diagonal row R - 1 -
    # k's, and holds the chunks of [j0 - (R - 1 - k), j0] at any j0
    assert slot_row(0) == 0 and slot_row(R) == WIN
    for k in range(R):
        size = slot_row(k + 1) - slot_row(k)
        assert size == slot_base(R - k) - slot_base(R - 1 - k)
        for j0 in range(R, R + 64):
            assert 16 * ((j0 >> 4) - ((j0 - (R - 1 - k)) >> 4) + 1) <= size
    src = " ".join(WALK_CUH.read_text().replace("//", " ").split())
    assert f"slot_base(R); {WIN:,} bytes" in src
    assert f"two warps in {smem:,} bytes" in src


EXTZ_FORMS = {
    # name: (flag, zdrop, bands per pair, end_bonus)
    "cig_z100": (Flag.NONE, 100, [1, 16, 751, -1], 0),
    "cig_zm1": (Flag.NONE, -1, [-1, 0, 5, 40], 0),
    "right_generic": (Flag.RIGHT | Flag.GENERIC_SC, -1, [-1, 1, 60, 7], 0),
    "approxdrop_z100": (Flag.APPROX_MAX | Flag.APPROX_DROP, 100,
                        [16, -1, 300, 2], 0),
    "extz_only_eb": (Flag.EXTZ_ONLY, 100, [-1, 16, 200, -1], CS.END_BONUS),
}


@pytest.mark.parametrize("form", sorted(EXTZ_FORMS))
def test_compact_one_piece(form):
    """Kernel 17 on kernel 12's stores (unbanded, w = 0, 1, small), in
    the main path's mode and with upper_force 0 (escapes) and min_intron
    5: exact, with no direct read."""
    flag, zdrop, ws, eb = EXTZ_FORMS[form]
    pairs = _pairs(7 + len(form), (300, 520, 610, 270), with_n=True)
    ln = CS.extz_launch(pairs, ws, flag, zdrop)
    for uf, mi in ((1, 0), (0, 0), (1, 5)):
        st = _compact(ln, "extz", eb, uf, mi)
        assert st["direct"] == 0 and st["reads"] > 0


@pytest.mark.parametrize("costs", ["extd", "swapped"])
def test_compact_two_piece(costs):
    """Kernel 17 on kernel 13's stores: exact, no direct read."""
    pairs = _pairs(31, (400, 700, 90, 350))
    c = CS.EXTD if costs == "extd" else CS.SWAPPED
    ln = CS.extd_launch(pairs, [-1, 30, 1, 120], Flag.NONE, 100, c)
    st = _compact(ln, "extd", 0)
    assert st["direct"] == 0 and st["windows"] > 4 * len(pairs)


@pytest.mark.parametrize("flag", [Flag.NONE, Flag.RIGHT])
def test_compact_splice(flag):
    """Kernel 17 on kernel 14's stores with min_intron = long_thres (N
    runs): exact, no direct read."""
    rng = np.random.default_rng(41)
    pairs = [CS.spliced_pair(rng, L) for L in (600, 900, 450)]
    ln = CS.exts_launch(pairs, flag, 200)
    st = _compact(ln, "exts", 0)
    assert st["direct"] == 0 and st["windows"] > len(pairs)


def test_compact_one_base_pairs():
    """Pairs of one base, and one-base queries or targets, at w = 0 and
    1: the walk is a step or two inside its first window."""
    pairs = [(np.array([1], np.uint8), np.array([1], np.uint8)),
             (np.array([2], np.uint8), np.array([0, 2, 3], np.uint8)),
             (np.array([3, 0, 1, 2], np.uint8), np.array([3], np.uint8)),
             (np.array([0], np.uint8), np.array([0], np.uint8))]
    for ws in ([0, 1, 0, 1], [1, 0, 1, -1]):
        ln = CS.extz_launch(pairs, ws, Flag.NONE, -1)
        st = _compact(ln, "extz", 0)
        assert st["direct"] == 0 and st["windows"] <= len(pairs)


def _last_cell(r, qlen, tlen, w):
    """The band's last cell (en0, r - en0) on diagonal r."""
    i = min(tlen - 1, (r + w) // 2, r)
    assert 0 <= r - i < qlen
    return i, r - i


@pytest.mark.parametrize("w", [1, 3, 24, -1])
def test_compact_deep_random(w):
    """Random bytes over a long compact store: walks that cross hundreds of
    windows (rows that change width across a window, the F and E forces at
    both band edges), from the last stored row and from inner cells around
    window edges, three- and four-state bytes with min_intron, and
    upper_force 0.  (w = 0 stores one row: the real stores cover it.)"""
    rng = np.random.default_rng(100 + w)
    qlen, tlen = (9000, 8990) if w >= 0 else (700, 650)
    wr = max(qlen, tlen) if w < 0 else w
    rows = int(first_empty_diag(qlen, tlen, wr))
    starts = [_last_cell(rows - 1, qlen, tlen, wr)]
    starts += [_last_cell(r0, qlen, tlen, wr)
               for r0 in (R - 2, R - 1, R, R + 1, 2 * R - 1, 3 * R + HALF)]
    st = _random_compact(rng, qlen, tlen, wr, starts)
    assert st["direct"] == 0
    if w >= 0:
        assert st["windows"] >= 150
    st = _random_compact(rng, qlen, tlen, wr, starts[1:], min_intron=5,
                         states=4)
    assert st["direct"] == 0
    _random_compact(rng, qlen, tlen, wr, starts[:3], upper_force=0)


BAND_FORMS = {
    "cig_z400": (Flag.NONE, 400, None),
    "extd_right": (Flag.RIGHT, -1, CS.EXTD),
    "approxdrop": (Flag.APPROX_MAX | Flag.APPROX_DROP, 100, None),
    "generic_eqx": (Flag.GENERIC_SC | Flag.EQX, 100, CS.EXTD),
}


@pytest.mark.parametrize("form", sorted(BAND_FORMS))
def test_rotated_band_bytes(form):
    """Kernel D on the band forward's rotated bytes (long pairs in a
    clipping band): exact, no direct read."""
    flag, zdrop, costs = BAND_FORMS[form]
    pairs = _pairs(61, (900, 1300, 700))
    ln = CS.band_launch(pairs, [40, 100, 16], flag, zdrop, costs,
                        CS._generic_mat() if flag & Flag.GENERIC_SC
                        else None)
    st = _rotated(ln)
    assert st["direct"] == 0 and st["windows"] > 5 * len(pairs)


@pytest.mark.parametrize("costs", [None, "extd"])
def test_rotated_batched_bytes(costs):
    """Kernel D on the batched route's bytes: w = 0, 1, small and
    unbanded on short pairs, one query clipped."""
    pairs = _pairs(62, (60, 150, 300, 500, 240), div=0.2, indel=0.08,
                   with_n=True)
    pairs[2] = (pairs[2][0][:120], pairs[2][1])
    ln = CS.band_launch(pairs, [0, 1, 16, 100, 600], Flag.NONE, 100,
                        CS.EXTD if costs else None)
    st = _rotated(ln)
    assert st["direct"] == 0


def test_rotated_min_intron():
    """Kernel D on kernel 6's splice bytes with min_intron (N runs)."""
    rng = np.random.default_rng(63)
    pairs = [CS.spliced_pair(rng, L) for L in (512, 700, 300)]
    q, e, q2, noncan = CS.SPLICE
    (ln,) = BE.batch_exts_prep([a for a, _ in pairs], [t for _, t in pairs],
                               np.array([len(a) for a, _ in pairs], np.int32),
                               np.array([len(t) for _, t in pairs], np.int32),
                               5, simple_mat(5, 1, 2), q, e, q2, noncan, 200,
                               Flag.NONE)
    mi = W.walk_min_intron(ln.prm.lt, True)
    st = _rotated(ln, plain=BE.batch_exts_forward_plain, min_intron=mi)
    assert st["direct"] == 0 and st["steps"] > 0


@pytest.mark.parametrize("w", [0, 1, 5, 40])
def test_rotated_deep_random(w):
    """Random rotated bytes: walks across many windows, inner starts at
    window edges, min_intron."""
    rng = np.random.default_rng(200 + w)
    qlen, tlen = 3000, 3020
    starts = [(tlen - 1, qlen - 1)]
    starts += [_last_cell(r0, qlen, tlen, w) for r0 in (R - 1, R, 2 * R + 1)]
    st = _rotated_starts(rng, qlen, tlen, w, starts)
    assert st["direct"] == 0 and st["windows"] >= 40


def _rotated_starts(rng, qlen, tlen, w, starts):
    tot = _random_rotated(rng, qlen, tlen, w, starts)
    more = _random_rotated(rng, qlen, tlen, w, starts[:2], min_intron=4)
    return {k: tot[k] + more[k] for k in tot}


@pytest.mark.parametrize("seed", [601, 602, 603])
def test_flat_overruns(seed):
    """Kernel D's flat form on kernel 16's flat store (the reference's
    overrun): targets longer than qlen + w, whose walks leave the band
    upward and read on into the next rows' bytes and past the store, and
    banded pairs (queries longer than tlen + w among them) and unbanded
    ones; only the overruns' reads are direct, and the unbanded pairs'
    rows hold every cell."""
    rng = np.random.default_rng(seed)
    over, banded, unbanded = [], [], []
    for k in range(9):
        t, q = CS.random_pair(rng, int(rng.integers(3, 301)),
                              divergence=0.3, indel=0.12)
        q, t = encode_dna(q), encode_dna(t)
        if k % 3 == 0:
            t = np.concatenate([t, t[:len(t) // 2 + 40]])
            over.append(((q, t), int(rng.choice([0, 1, 3, 8]))))
        elif k % 3 == 1:
            if k % 2:
                q = np.concatenate([q, q[:len(q) // 2 + 10]])
            banded.append(((q, t), int(rng.choice([0, 1, 5, 16, 40]))))
        else:
            unbanded.append(((q, t), -1))
    st = _flat(*zip(*over))
    assert st["direct"] > 0 and st["reads"] > st["direct"]
    _flat(*zip(*banded))
    st = _flat(*zip(*unbanded))
    assert st["direct"] == 0 and st["reads"] > 0


def test_flat_deep_random():
    """Random flat stores: walks across many windows, narrow bands that
    the walk leaves upward into the next rows (direct reads), one-base
    pairs and w = 0."""
    rng = np.random.default_rng(77)
    st = _random_flat(rng, [(2000, 2100, 30), (1500, 1500, 1), (1, 1, 0),
                            (3, 1, 0), (700, 400, 8), (400, 900, 0)])
    assert st["direct"] > 0 and st["windows"] >= 40
    # from the corner no read falls past the store: i - st(r) <= qlen - 1 -
    # j + 15, while the store holds (qlen + tlen - r) n_col >= (qlen - j +
    # 1) 32 bytes from the row's start
    assert st["past"] == 0


STRIPS_FORMS = {
    # name: (flag, zdrop, two-piece costs, splice)
    "extz_z100": (Flag.NONE, 100, None, False),
    "extz_right_zm1": (Flag.RIGHT, -1, None, False),
    "extd_z100": (Flag.NONE, 100, CS.EXTD, False),
    "extd_right_swapped": (Flag.RIGHT, 40, CS.SWAPPED, False),
    "spl_z200": (Flag.SPLICE_FOR, 200, None, True),
    "spl_right_z30": (Flag.SPLICE_FOR | Flag.RIGHT, 30, None, True),
}


def _strips_launch(name, pairs):
    flag, zdrop, costs, spl = STRIPS_FORMS[name]
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    if spl:
        q, e, q2, noncan = CS.SPLICE
        (ln,) = S.strips_exts_prep(qs, ts, ql, tl, 5, simple_mat(5, 1, 2), q,
                                   e, q2, noncan, zdrop, flag, cig=True)
    else:
        q, e, q2, e2 = CS.EXTD if costs is None else costs
        (ln,) = S.strips_prep(qs, ts, ql, tl, 5, simple_mat(5, 2, -4),
                              *((4, 2) if costs is None else (q, e)),
                              zdrop, flag, cig=True, two=costs is not None,
                              q2=q2, e2=e2)
    return ln


@pytest.mark.parametrize("form", sorted(STRIPS_FORMS))
def test_rowmajor_strips_bytes(form):
    """Kernel B on the strips forward's row-major bytes (one-piece,
    two-piece and splice bytes with min_intron > 0, RIGHT, Z-drops): every
    read in the window it holds, no direct read, exactly the plain
    walker's runs; pairs long enough to cross dozens of windows."""
    rng = np.random.default_rng(300 + len(form))
    if STRIPS_FORMS[form][3]:
        pairs = [CS.spliced_pair(rng, L) for L in (900, 600, 1300)]
    else:
        pairs = _pairs(71 + len(form), (700, 1200, 90, 400), with_n=True)
    st, _, _, _ = _rowmajor(_strips_launch(form, pairs))
    assert st["direct"] == 0 and st["windows"] > 10 * len(pairs)


@pytest.mark.parametrize("form", ["extz_z100", "extz_right_zm1",
                                  "extd_z100", "spl_z200"])
def test_rowmajor_matches_jax_walker(form):
    """The walk of kernel B's model (equal to the plain walker's, as the
    test above asserts) turned into CIGARs equals the JAX strips walker's
    route on a few small pairs, run under the Pallas interpreter."""
    flag, zdrop, costs, spl = STRIPS_FORMS[form]
    rng = np.random.default_rng(400 + len(form))
    if spl:
        pairs = [CS.spliced_pair(rng, L) for L in (160, 230)]
    else:
        pairs = _pairs(81 + len(form), (150, 260, 40))
    ln = _strips_launch(form, pairs)
    st, rec, res, runs = _rowmajor(ln)
    assert st["direct"] == 0
    prm = ln.prm
    mat = simple_mat(5, 1, 2) if spl else simple_mat(5, 2, -4)
    got = W.unpack_cigars(rec, res, runs, mat, prm.q, prm.e, 0, flag,
                          prm.lt if spl else 0)
    B = len(pairs)
    Q = np.zeros((B, max(len(a) for a, _ in pairs)), np.int32)
    T = np.zeros((B, max(len(b) for _, b in pairs)), np.int32)
    for k, (a, b) in enumerate(pairs):
        Q[k, :len(a)], T[k, :len(b)] = a, b
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    if spl:
        want = jsw.strips_exts_cigar_batch(Q, T, ql, tl, 5, mat, *CS.SPLICE,
                                           zdrop=zdrop, flag=flag,
                                           interpret=True)
    else:
        q, e, q2, e2 = costs or (4, 2, 0, 0)
        want = jsw.strips_cigar_align(Q, T, ql, tl, 5, mat, q, e,
                                      zdrop=zdrop, flag=flag, interpret=True,
                                      two=costs is not None, q2=q2, e2=e2)
    for g, w in zip(got, want):
        assert (g.max, g.score, g.zdropped) == (w.max, w.score, w.zdropped)
        assert list(g.cigar) == list(w.cigar)


@pytest.mark.parametrize("states,mi", [(3, 0), (5, 4)])
def test_rowmajor_deep_random(states, mi):
    """Random row-major bytes: walks across dozens of windows from the
    corner and from inner cells at the window's edges (i + j = R - 2 ..
    R + 1, 2R - 1), three- and five-state bytes with min_intron; rows of
    Lq % 32 == 0 bytes longer than the query."""
    rng = np.random.default_rng(500 + states)
    tv, Lq = 1500, 1216
    starts = [(tv - 1, 1200), (tv - 1, Lq - 1)]
    starts += [(min(r0, tv - 1) - 3, r0 - min(r0, tv - 1) + 3)
               for r0 in (R - 2, R - 1, R, R + 1, 2 * R - 1)]
    st = _random_rowmajor(rng, tv, Lq, starts, mi, states)
    assert st["direct"] == 0 and st["windows"] >= 40
