// Definitions shared by the strips forward (strips_fwd.cu), the rows
// forward (rows_fwd.cu), the band forward (band_fwd.cu, which is also
// kernel 6's wide form), the single-pair forwards (extz_fwd.cu,
// lg_fwd.cu) and the walkers (strips_walk.cu, band_walk.cu,
// extz_walk.cu): the record sentinel, the virtual column boundaries, the
// SSE merge-order tie key, the direction-byte codes, ksw_backtrack's
// per-byte state step, the rows of the single-pair engine's compact byte
// store and the single-pair forwards' tiles (their diagonal ranges and
// the hand-off between them).  Their Python twins live in
// ksw2_tpu_torch/ops/strips.py, ops/extz_fwd.py and the walkers' plain
// versions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ksw2t {

// "no value" in the packed record streams: -(2**31) + 1
constexpr int SENT = -2147483647;

// Direction byte (ksw2.h:129-161): bits 0-2 hold the state that won the
// cell (0 = diagonal, 1 = E / deletion, 2 = F / insertion; two-piece
// adds 3 = E2 / long deletion, 4 = F2 / long insertion); bits 3 and 4
// say that E and F continue into the cell above / left, bits 5 and 6
// the same for E2 and F2 (ksw2_extd2_sse.c:191-322).  Splice (exts)
// bytes use 3 for the intron state N with 0x20 as its continuation bit
// (ksw2_exts2_sse.c).
constexpr int DIR_E = 1;
constexpr int DIR_F = 2;
constexpr int DIR_E2 = 3;
constexpr int DIR_F2 = 4;
constexpr int DIR_N = 3;
constexpr int DIR_E_CONT = 0x08;
constexpr int DIR_F_CONT = 0x10;
constexpr int DIR_E2_CONT = 0x20;
constexpr int DIR_F2_CONT = 0x40;
constexpr int DIR_N_CONT = 0x20;

// BAM op codes of the walkers' runs
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3;

// One step of ksw_backtrack's state machine (ksw2.h:140-147): the state
// after reading byte `tmp` at the cell while in `state`.  At an H cell
// (state 0) the byte's winning state is taken; a gap state continues
// only while its continuation bit ((tmp >> (state + 2)) & 1) is set.
// `force` >= 0 is the band-edge state of a rotated store that overrides
// both (2 left of the band, 1 right of it); -1 for none.
__device__ __forceinline__ int backtrack_step(int state, int tmp,
                                              int force) {
  if (state == 0)
    state = tmp & 7;
  else if (!((tmp >> (state + 2)) & 1))
    state = 0;
  if (state == 0) state = tmp & 7;
  return force >= 0 ? force : state;
}

// The op a state emits (ksw2.h:148-155): 0 matches, 1 deletes, 3
// deletes (E2) or, when min_intron_len > 0 as ksw_exts2_sse calls
// ksw_backtrack, skips an intron (N), 2 and 4 (F, F2) insert.
__device__ __forceinline__ int state_op(int state, int min_intron) {
  if (state == 0) return OP_M;
  if (state == DIR_E) return OP_D;
  if (state == DIR_E2) return min_intron > 0 ? OP_N : OP_D;
  return OP_I;
}

// Moves (i, j) one step back along `op`: M and I consume a query base,
// M, D and N a target base.
__device__ __forceinline__ void step_back(int op, int& i, int& j) {
  if (op != OP_I) --i;
  if (op == OP_M || op == OP_I) --j;
}

// H(i, -1): the reference's virtual-column boundary -(q + e + e*i).
__device__ __forceinline__ int col_h(int i, int gapoe, int e) {
  return -(gapoe + e * i);
}

// Two-piece H(i, -1) (and H(-1, i)): steps of -e until long_thres, the
// step long_diff at it, -e2 after (ksw2_extd2_sse.c:156-163).
__device__ __forceinline__ int col_h2(int i, int gapoe, int e, int e2,
                                      int lt, int ld) {
  return i < lt ? -(gapoe + e * i)
                : -(gapoe + e * (lt - 1)) + ld - e2 * (i - lt);
}

// ksw_extz2_sse's exact-max merge-order rank of cell (i, r - i) on
// diagonal r (spec/strips.py:merge_key): the en0 cell first, then the
// SSE vector region [st0, en1) by (lane class, i), then the scalar tail.
// Smaller ranks win score ties.
__device__ __forceinline__ int merge_key(int i, int r, int qlen, int tlen,
                                         int tv) {
  const int st0 = max(0, r - qlen + 1);
  const int en0 = min(tlen - 1, r);
  if (i == en0) return 0;
  const int en1 = st0 + ((en0 - st0) & -4);
  return i < en1 ? ((i - st0) & 3) * tv + i + 1 : 4 * tv + i + 1;
}

// The band of diagonal r (ksw2_extz2_sse.c:107-116): [st0, en0] and its
// 16-rounded bounds [st, en].
struct BandRow {
  int st0, en0, st, en;
};

__device__ __forceinline__ BandRow band_row(int r, int qlen, int tlen,
                                            int w) {
  BandRow b;
  b.st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
  b.en0 = min(min(tlen - 1, r), (r + w) >> 1);
  b.st = b.st0 & ~15;
  b.en = b.en0 | 15;
  return b;
}

// The first diagonal whose band is empty, else qlen + tlen - 1
// (batch_pallas.py:42-48; ops/bands.py:first_empty_diag).
__device__ __forceinline__ int first_empty_diag(int qlen, int tlen, int w) {
  const int ndb = qlen + tlen - 1;
  return min(min(ndb, 2 * qlen + w - 1),
             min(2 * tlen + w - 1, w == 0 ? 1 : ndb));
}

// Bytes of row r of the compact store (extz_fwd.cu): en(r) - st(r) + 1.
__device__ __forceinline__ int store_row_width(int r, int qlen, int tlen,
                                               int w) {
  const BandRow b = band_row(r, qlen, tlen, w);
  return b.en - b.st + 1;
}

// Bytes of rows 0 .. r - 1 of the compact store, in closed form
// (ops/extz_fwd.py:row_off): for each multiple x = 16 j, the rows whose
// en0 (st0) has reached x, from the first row where it does.
__device__ inline long long store_row_off(int r, int qlen, int tlen, int w) {
  long long s = r;
  for (int x = 16; x <= tlen - 1; x += 16) {
    const int f = max(x, 2 * x - w);
    if (f >= r) break;
    s += r - f;
  }
  for (int x = 16;; x += 16) {
    const int f = min(x + qlen - 1, 2 * x + w - 1);
    if (f >= r) break;
    s -= r - f;
  }
  return 16 * s;
}

// The single-pair forwards' tiles (extz_fwd.cu, lg_fwd.cu; band_fwd.cu
// keeps its own, block-scoped): a warp owns TP target positions of a pair
// and hands its last position's state on to the next tile once a group of
// KD diagonals (at most 32: a lane a diagonal at the group's end), with
// one release at GPU scope; the next tile waits once a group, one lane
// spinning with acquire semantics.
namespace tiles {

constexpr int KD = 32;
// a wait on the tile before may last SPIN_BASE + SPIN_DIAG cycles for each
// of the pair's diagonals (~10 s + ~100 us a diagonal of SM clock) before
// it counts as a fault; between reads it asks for a sleep that doubles
// from 16 ns up to SPIN_SLEEP_MAX ns
constexpr long long SPIN_BASE = 20000000000LL;
constexpr long long SPIN_DIAG = 200000LL;
constexpr unsigned SPIN_SLEEP_MAX = 128;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The first diagonal a tile starting at t0 can touch (the score fill runs
// up to 15 positions past en0) and the last one whose band starts in it
// (ops/extz_fwd.py:tile_range).
__device__ __forceinline__ int tile_first(int t0, int w) {
  if (t0 == 0) return 0;
  const int x = t0 - 15;
  return max(x, 2 * x - w);
}

__device__ __forceinline__ int tile_last(int t0, int TP, int qlen, int w,
                                         int rlim) {
  const int X = t0 + TP - 1;
  return min(min(rlim - 1, X + qlen - 1), 2 * X + w);
}

// The value of a per-chunk register array at a warp-uniform local
// position li of the tile: the owning chunk's register, from lane li % 32.
template <int NC>
__device__ __forceinline__ int tile_pick(const int (&a)[NC], int li) {
  int v = a[0];
#pragma unroll
  for (int c = 1; c < NC; ++c)
    if (c == li >> 5) v = a[c];
  return __shfl_sync(0xffffffffu, v, li & 31);
}

}  // namespace tiles

}  // namespace ksw2t

extern "C" const char* ksw2t_error_string(int err);
