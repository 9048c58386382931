// The register window shared by the batched one-warp-a-pair forwards:
// kernels E / E2 and kernel 6's register form (batch_fwd.cu), kernel 8's
// (gg2_fwd.cu) and kernel 7's (batch_extf_fwd.cu).
//
// A warp holds a pair's anti-diagonal state over a window of W target
// positions based at window_base(st) = (st - 1) & ~31.  The int8 planes
// sit in the top byte of an int32 (v << 24), so int32 adds wrap as the
// reference's epi8 adds do and int32 compares are its signed byte compares
// (unsigned compares its epu8 ones).  A cell reads t - 1's old state from
// its own lane's registers, so the warp makes one shuffle a plane a
// diagonal.  When st - 1 passes base + 32 the window slides up 32
// positions by shuffles; the positions that enter at the top are fresh
// (the reference's initial bytes), their target symbols prefetched a
// group of 32 diagonals ahead.  The query symbols move up one position a
// diagonal (the query advances along the anti-diagonal), a new one
// entering at the window's bottom from 64 symbols staged a group
// (query_in).  A group's per-diagonal results, one a lane, are replayed in
// order at its end by a 5-round scan (first_max_scan).
//
// E / E2 and kernel 6 lay the window out as CPL positions a lane, lane l
// holding base + CPL l .. + CPL - 1, and keep their own inline staging and
// replay (the same code called through query_in and first_max_scan
// compiles to other SASS).  Kernels 8 and 7 keep it in units of 8
// positions (the unit window, below), which with one slot is E's layout
// at CPL 8, and run one group loop, unit_sweep, each with its own cells
// and walk.
//
// ops/batch.py:batch_form, ops/batch_gg2.py:gg2_form and
// ops/batch_extf.py:extf_form give a launch the register form while
// n_col + 48 <= W: then the window holds every position a diagonal reads
// or writes (st - 1 up to the score fill's end, en0 + 15 at most), and the
// reference's stale bytes there persist as they do in its SSE rows.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ksw2t {

// An int8 value in the top byte of an int32 (v << 24); sums and
// differences in that form wrap as the reference's epi8 ones do (taken in
// unsigned arithmetic, where wrapping is defined).
__device__ __forceinline__ int top(int v) { return (int)((unsigned)v << 24); }
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// The byte of (hi:lo) that sel's low nibble picks in the low byte (a
// nibble below 8 selects without sign replication; the other bytes are
// the other nibbles' picks).
__device__ __forceinline__ int prmt(int lo, int hi, unsigned sel) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

// ops/batch.py:window_base: the register window's first position
__device__ __forceinline__ int window_base(int st) {
  return st > 0 ? (st - 1) & ~31 : 0;
}

// A lane's CPL symbols a nibble each: 32 bits at CPL 8, 64 at CPL 16
template <int CPL>
using Nibs = std::conditional_t<(CPL > 8), unsigned long long, unsigned>;

// The bits [lo, hi] of a lane's N cells (lo, hi relative to its first)
template <int N>
__device__ __forceinline__ unsigned cell_mask(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, N - 1);
  return hi >= lo ? (2u << hi) - (1u << lo) : 0u;
}

// a[k] at a warp-uniform position k of a lane's register array, from the
// lane that owns it
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int slot, int owner) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (k == slot) v = a[k];
  return __shfl_sync(0xffffffffu, v, owner);
}

// A symbol as the register form keeps it, a nibble: bits 0-2 the symbol
// (m <= 8), bit 3 set for N (m - 1), the wildcard of the simple scores
__device__ __forceinline__ unsigned nib(int c, int m) {
  return (unsigned)c | (c == m - 1 ? 8u : 0u);
}

// The CPL target bytes tw as nibbles, position k at bits 4k
template <int CPL>
__device__ __forceinline__ Nibs<CPL> target_nibbles(
    const unsigned (&tw)[CPL / 4], int m) {
  Nibs<CPL> tn = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    tn |= (Nibs<CPL>)nib((tw[k >> 2] >> (8 * (k & 3))) & 255, m) << (4 * k);
  return tn;
}

// Cell k's score byte in the top-byte form (zero below)
template <int N>
__device__ __forceinline__ int score_top(const unsigned (&s4)[N], int k) {
  return prmt((int)s4[k >> 2], 0, 0x444u | (unsigned)(k & 3) << 12);
}

// Four cells' bits of a cell mask as byte masks (bit i -> byte i)
__device__ __forceinline__ unsigned byte_mask(unsigned bits4) {
  return ((bits4 & 15u) * 0x00204081u & 0x01010101u) * 0xffu;
}

// A row's CPL bytes at position p (a multiple of CPL; the launch's
// target rows are zero past each target, and Lt is a multiple of 16):
// the target, or a splice launch's donor or acceptor row
template <int CPL>
__device__ __forceinline__ void load_target(const uint8_t* tg, int Lt, int p,
                                            unsigned (&tw)[CPL / 4]) {
  if (p >= 0 && p < Lt) {
    if constexpr (CPL == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(tg + p));
      tw[0] = v.x;
      tw[1] = v.y;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(tg + p));
      tw[0] = v.x;
      tw[1] = v.y;
      tw[2] = v.z;
      tw[3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) tw[i] = 0;
  }
}

// Query symbol i as a nibble (0 outside the query)
__device__ __forceinline__ int load_q(const uint8_t* qy, int qlen, int m,
                                      int i) {
  return (int)nib(i >= 0 && i < qlen ? (int)__ldg(qy + i) : 0, m);
}


// ---------------------------------------------------------------------
// The unit window of kernels 8 and 7's register forms: W = 256 NU target
// positions in units of 8, unit u (positions base + 8 u .. + 7) held by
// lane u % 32 in its slot u / 32, cell i of a unit at position base + 8 u
// + i.  With NU = 1 it is E's layout at CPL 8; with more slots a band
// narrower than the window lies in few of them, and a diagonal computes
// only the slots its band meets (the test is warp-uniform), so its work
// follows the band's width.  Cell 0 of a unit reads the unit below's
// cell 7: lane l - 1's in the same slot, lane 31's of the slot below for
// lane 0 (unit_prev: one rotation a slot).

// 8 bytes of a row at positions p .. p + 7, four to a register (position
// p + k in byte k & 3 of w[k / 4]); 0 at positions outside [0, lim).
// Byte loads: a launch's rows need not be aligned.
__device__ __forceinline__ void load_unit(const uint8_t* row, int lim, int p,
                                          unsigned (&w)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    unsigned v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = p + 4 * i + j;
      if (t >= 0 && t < lim) v |= (unsigned)__ldg(row + t) << (8 * j);
    }
    w[i] = v;
  }
}

// a[slot] of a lane's own registers at a warp-uniform slot: a tree of
// selects on slot's bits (depth log2 N)
template <int N>
__device__ __forceinline__ int sel_tree(const int (&a)[N], int slot) {
  static_assert((N & (N - 1)) == 0, "a power of two");
  int v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = a[k];
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
#pragma unroll
    for (int k = 0; k + s < N; k += 2 * s) v[k] = (slot & s) ? v[k + s] : v[k];
  return v[0];
}

// The value at window position rel (warp-uniform) of a unit-window plane,
// from the lane that holds it
template <int NU>
__device__ __forceinline__ int unit_pick(const int (&a)[NU][8], int rel) {
  const int i = rel & 7, j = rel >> 8;
  int row[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    row[k] = a[0][k];
#pragma unroll
    for (int s = 1; s < NU; ++s) row[k] = j == s ? a[s][k] : row[k];
  }
  return __shfl_sync(0xffffffffu, sel_tree<8>(row, i), (rel >> 3) & 31);
}

// The slide of a unit-window plane (the base 32 positions up, 4 units):
// unit u takes unit u + 4's value; the top 4 units take `init`
template <int NU>
__device__ __forceinline__ void unit_slide(int (&a)[NU][8], int lane,
                                           int init) {
  const int src = (lane + 4) & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int rot[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) rot[j] = __shfl_sync(0xffffffffu, a[j][i], src);
#pragma unroll
    for (int j = 0; j < NU; ++j)
      a[j][i] = lane < 28 ? rot[j] : (j + 1 < NU ? rot[j + 1] : init);
  }
}

// ... and of a unit-window row of bytes, the top 4 units taking `fresh`
template <int NU>
__device__ __forceinline__ void unit_slide(unsigned (&a)[NU][2], int lane,
                                           const unsigned (&fresh)[2]) {
  const int src = (lane + 4) & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    unsigned rot[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) rot[j] = __shfl_sync(0xffffffffu, a[j][i], src);
#pragma unroll
    for (int j = 0; j < NU; ++j)
      a[j][i] = lane < 28 ? rot[j] : (j + 1 < NU ? rot[j + 1] : fresh[i]);
  }
}

// Cell 0's left neighbour in each slot (the unit below's cell 7, before
// this diagonal writes it); unit 0 of slot 0 (position base, below st
// unless st is 0) gets 0
template <int NU>
__device__ __forceinline__ void unit_prev(const int (&a)[NU][8], int lane,
                                          int (&prev)[NU]) {
  int rot[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j)
    rot[j] = __shfl_sync(0xffffffffu, a[j][7], (lane + 31) & 31);
#pragma unroll
  for (int j = 0; j < NU; ++j) prev[j] = lane ? rot[j] : (j ? rot[j - 1] : 0);
}

// The query bytes moved up one position: unit 0 of slot 0 takes `ins` at
// its cell 0, every other unit the unit below's cell 7
template <int NU>
__device__ __forceinline__ void unit_query_up(unsigned (&q)[NU][2],
                                              unsigned ins, int lane) {
  unsigned rot[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j)
    rot[j] = __shfl_sync(0xffffffffu, q[j][1] >> 24, (lane + 31) & 31);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const unsigned in = lane ? rot[j] : (j ? rot[j - 1] : ins);
    q[j][1] = __funnelshift_l(q[j][0], q[j][1], 8);
    q[j][0] = (q[j][0] << 8) | in;
  }
}

// Byte k of a unit's row (k warp-uniform or not), zero-extended
__device__ __forceinline__ int unit_byte(const unsigned (&w)[2], int k) {
  return (int)((w[k >> 2] >> (8 * (k & 3))) & 255u);
}

// The symbol entering at the window's bottom (position base) on diagonal
// r, query symbol r - base, from the group's staged 64: lane l of qA
// holds symbol q0 - 32 + l, of qB q0 + l, q0 = r_lo - (the group's first
// base); the group slides at most once, so the index lies in [0, 64)
__device__ __forceinline__ unsigned query_in(int r, int base, int q0, int qA,
                                             int qB) {
  const int idx = r - base - (q0 - 32);
  return (unsigned)__shfl_sync(0xffffffffu, idx < 32 ? qA : qB, idx & 31);
}

// Bytes equal in a and b as 0xff, the others 0
__device__ __forceinline__ unsigned bytes_eq(unsigned a, unsigned b) {
  const unsigned x = a ^ b;
  const unsigned ne = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ~((ne >> 7) * 0xffu);
}

// The first strictly greater running maximum over a group's diagonals,
// lane j holding diagonal r_lo + j's value v at (t, r) (INT_MIN where it
// takes no part): the inclusive scan (iv, it, ir) and the exclusive one
// joined with the carried maximum (mx at (mt, mt + mq); a tie keeps the
// earlier), ksw_apply_zdrop's and the X-drop's order
struct RunMax {
  int iv, it, ir, pv, pt, pr;
};

__device__ __forceinline__ RunMax first_max_scan(int v, int t, int r, int lane,
                                                 int mx, int mt, int mq) {
  RunMax s{v, t, r, 0, 0, 0};
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ov = __shfl_up_sync(0xffffffffu, s.iv, o);
    const int ot = __shfl_up_sync(0xffffffffu, s.it, o);
    const int orr = __shfl_up_sync(0xffffffffu, s.ir, o);
    if (lane >= o && !(s.iv > ov)) {
      s.iv = ov;
      s.it = ot;
      s.ir = orr;
    }
  }
  s.pv = __shfl_up_sync(0xffffffffu, s.iv, 1);
  s.pt = __shfl_up_sync(0xffffffffu, s.it, 1);
  s.pr = __shfl_up_sync(0xffffffffu, s.ir, 1);
  if (lane == 0 || !(s.pv > mx)) {
    s.pv = mx;
    s.pt = mt;
    s.pr = mt + mq;
  }
  return s;
}

// A pair's unit window: NP int8 planes in the top-byte form and the
// score, target and query bytes four to a register, unit (lane, j) in
// slot j, based at `base`
template <int NU, int NP>
struct UnitWindow {
  int P[NP][NU][8];
  unsigned S4[NU][2], T4[NU][2], Q4[NU][2];
  int base;
};

// The unit window's sweep of diagonals [0, nd), the group loop of kernels
// 8 and 7's register forms.  The window starts at base 0 with its planes
// zero, its score bytes `sb4` (the reference's zero as the kernel keeps
// it) and the target's first W positions (zero from `tlim`).  A group of
// 32 diagonals stages its 64 query symbols and the fresh target units of
// its slide (lanes 28-31 of the top slot) one group ahead.  A diagonal
// slides the window where st - 1 passes base + 32 (the planes' fresh
// units zero, the score bytes `sb4`, the target's staged) and moves the
// query up one position.  The kernel's work is in four hooks, inlined:
// begin(r_lo, n) after a group's staging, head(r, r_lo) before a
// diagonal's slide, cells(r, band row) after it, and end(r_lo, n) after
// the group, which returns true to stop the sweep.
template <int NU, int NP, class Begin, class Head, class Cells, class End>
__device__ __forceinline__ void unit_sweep(
    UnitWindow<NU, NP>& win, const uint8_t* tg, int tlim, const uint8_t* qy,
    int qlen, int tlen, int w, int nd, int lane, const unsigned (&sb4)[2],
    Begin&& begin, Head&& head, Cells&& cells, End&& end) {
  constexpr int KD = 32;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    load_unit(tg, tlim, 8 * (32 * j + lane), win.T4[j]);
    win.S4[j][0] = sb4[0];
    win.S4[j][1] = sb4[1];
    win.Q4[j][0] = win.Q4[j][1] = 0;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i) win.P[p][j][i] = 0;
  }
  win.base = 0;
  auto group_base = [&](int r) {
    return window_base(band_row(r, qlen, tlen, w).st);
  };
  auto qsym = [&](int i) {
    return i >= 0 && i < qlen ? (int)__ldg(qy + i) : 0;
  };
  const int flim = lane >= 28 ? tlim : 0;
  const int ftop = 8 * (32 * (NU - 1) + lane);
  unsigned tnext[2];
  load_unit(tg, flim, group_base(min(KD - 1, nd - 1)) + ftop, tnext);
  int qAn = qsym(-32 + lane), qBn = qsym(lane);
  for (int r_lo = 0; r_lo < nd; r_lo += KD) {
    const int n = min(KD, nd - r_lo);
    const int qA = qAn, qB = qBn;
    const int q0 = r_lo - group_base(r_lo);
    const unsigned tcur[2] = {tnext[0], tnext[1]};
    if (r_lo + n < nd) {
      const int n_lo = r_lo + n;
      load_unit(tg, flim, group_base(min(n_lo + KD - 1, nd - 1)) + ftop,
                tnext);
      const int nq0 = n_lo - group_base(n_lo);
      qAn = qsym(nq0 - 32 + lane);
      qBn = qsym(nq0 + lane);
    }
    begin(r_lo, n);
    for (int rr = 0; rr < n; ++rr) {
      const int r = r_lo + rr;
      const BandRow bd = band_row(r, qlen, tlen, w);
      head(r, r_lo);
      const int nb = window_base(bd.st);
      if (nb != win.base) {
        // the slide (nb == base + 32): 4 units down, fresh on top; a fresh
        // position's query byte is replaced from below before a fill
        // reads it
        const unsigned zero[2] = {0, 0};
#pragma unroll
        for (int p = 0; p < NP; ++p) unit_slide<NU>(win.P[p], lane, 0);
        unit_slide<NU>(win.S4, lane, sb4);
        unit_slide<NU>(win.T4, lane, tcur);
        unit_slide<NU>(win.Q4, lane, zero);
        win.base = nb;
      }
      // the query moves up one position, byte r - base entering
      unit_query_up<NU>(win.Q4, query_in(r, win.base, q0, qA, qB), lane);
      cells(r, bd);
    }
    if (end(r_lo, n)) break;
  }
}

}  // namespace ksw2t
