// The windowed walk shared by the single-pair walker (kernel 17,
// extz_walk.cu), the band walker (kernel D, band_walk.cu, rotated and
// flat forms) and the strips walker (kernel B, strips_walk.cu, the
// row-major form): ksw_backtrack (ksw2.h:129-161; common.cuh's
// backtrack_step and state_op are its rules) with its bytes read from
// windows of the store staged in shared memory.
//
// A block of two warps walks one pair: the walker warp steps, the stager
// warp fills the windows it asks for.  From a cell (i0, r0 = i0 + j0) a
// step lowers r by 1 (I, D, N) or 2 (M) and i by 0 or 1, so on row
// r0 - d the walk lies at i in [i0 - d, i0].  A window anchored at
// (i0, r0) holds, for each of the R rows r0 .. r0 - R + 1, the 16-byte
// chunks of that range that lie in the row's stored bytes: a triangle,
// row d in a slot of ceil(d / 16) + 1 chunks (slot_base), so every
// in-band read the walk makes before it leaves those rows is in the
// window.  The row-major store (d8[i][j], strips_fwd.cu) holds the same
// triangle transposed: the cells within d < R of the anchor lie in store
// rows i0 - k (k < R), at j in [j0 - (R - 1 - k), j0], one contiguous
// run of bytes each, so store row i0 - k takes the slot of anti-diagonal
// row R - 1 - k (slot_row) and d = r0 - (i + j) still measures the walk's
// way into its window.  Each stored row starts on a 16-byte boundary
// (compact rows are multiples of 16 wide, rotated and flat rows ncol %
// 16 == 0 wide, st(r) a multiple of 16, row-major rows Lq % 16 == 0
// wide, and pair bases multiples of 16: a misaligned base traps), so the
// stager copies whole chunks with cp.async, all in flight at once: one
// memory latency a window.  Once the walk is R / 2 rows into its window
// (and the window does not reach row 0) the walker asks for the window
// anchored at its current cell, into the other buffer; every cell it
// reaches from there lies in that window, so it switches to it when its
// reads would leave the first, by then long landed.  Compact rows'
// offsets come from off(r0) by a warp prefix sum of the row widths
// (store_row_width), kept per window in shared memory, never from
// store_row_off's loop per row; off of a pair's first cell takes that
// loop once, its iterations spread over the lanes.
//
// A step is a chain: the byte, the state, the op, the next cell, its
// byte.  The walker takes up to LOOK = 4 steps a block: each of 27 lanes
// guesses the block's first three movements (M, I, D / N), loads the
// bytes and rows of the cells they lead to, all at once, and steps along
// its guess, each byte turned off the chain into a word of every state's
// next state (next_states), so a step on the chain is a shift and a
// mask; the lane whose guess held longest holds the block, and a
// max-reduce and four shuffles hand its cell and state to all.  The ops
// go to a scratch of a byte each; at the walk's end the warp turns them
// into runs 32 at a time (write_runs).
//
// Reads that the window cannot hold go straight to global memory, a step
// of their own: the flat form's reads past a row's n_col bytes into the
// next rows (gg2's NULL off_end), and, should a walk read a row the store
// does not hold (a compact row at or past the first empty diagonal, a
// rotated cell past n_col, a row-major cell R or more anti-diagonals from
// the anchor), that byte.  Compact, rotated and row-major stores make no
// such read on a walk from a cell the forward computed
// (tests/test_torch_walk_launch.py models the window and counts them).
// The row-major store is unbanded (is_rot = 0): its rows' table, computed
// and not staged, has no band edge, so no force state applies.
//
// What bounds it on an H100: a pair's walk is one chain of blocks, each
// ~250 instructions of one warp issued in order, most waiting on the one
// before (~3 cycles an instruction, ~200 cycles a step; --breakdown walk
// in chip_smoke.py splits a block into its loads, its steps and the
// hand-over); not memory (the stager's copies land long before they are
// needed) and not bandwidth.  A block is a pair's two warps in 10,016
// bytes of static shared memory, so many pairs share an SM.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ksw2t {
namespace walk {

constexpr int R = 64;         // rows a window
constexpr int HALF = R / 2;   // rows into a window when the next is issued
constexpr int K = R / 32;     // rows a lane stages
constexpr int LOOK = 4;       // steps a block of the walk takes at most
constexpr int REACH = 6;      // rows below a block's first cell it reads
constexpr unsigned FULL = 0xffffffffu;

// Bytes of the slots of rows 0 .. d - 1 of a window: row k's slot holds
// ceil(k / 16) + 1 chunks of 16 bytes (i0 >> 4 down to (i0 - k) >> 4).
// Branch-free: at d = 0 both products are 0.
__host__ __device__ constexpr int slot_base(int d) {
  return 16 * (d + 8 * ((d - 1) >> 4) * (((d - 1) >> 4) + 1) +
               ((d - 1) & 15) * (((d - 1) >> 4) + 1));
}
constexpr int WIN = slot_base(R);   // 3,520 bytes
static_assert(WIN % 16 == 0, "window slots are whole chunks");

// ROWMAJOR: the first byte of store row i0 - k's slot, the slot of
// anti-diagonal row R - 1 - k (rows k < R; slot sizes fall with k)
__host__ __device__ constexpr int slot_row(int k) {
  return WIN - slot_base(R - k);
}

// the store a walk reads: the single-pair forward's compact rows, the band
// and batched forwards' rotated (B, nd, ncol) bytes, gg2's flat rows, the
// strips forward's row-major (B, tv, Lq) bytes (nd = tv, ncol = Lq)
enum Form { COMPACT = 0, ROTATED = 1, FLAT = 2, ROWMAJOR = 3 };

// what a step does at a cell: take a band-edge force state (DIR_E = 1,
// DIR_F = 2), read its byte from the window, read it from the store, or
// stop (COMPACT with upper_force 0 above the band); the last two, rare,
// are the codes below READ
constexpr int READ = -1, DIRECT = -2, ESCAPE = -3;

struct Args {
  const uint8_t* p;
  const long long* pbase;   // COMPACT, FLAT: each pair's first byte
  const int* starts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  int B, nd, ncol, wr, min_intron, upper_force;
  int* res;
  int* runs;
  uint8_t* ops;   // wr bytes a pair: the walk's ops, one a byte
};

// a pair's store: its bytes from base, the rows it holds and (ROTATED,
// FLAT, ROWMAJOR) their width; FLAT's store size (reads past it give 0)
struct Pair {
  const uint8_t* base;
  int qlen, tlen, w, rows, ncol;
  long long size;
};

// a window: its anchor cell and (COMPACT) the anchor row's offset
struct Win {
  int i0, r0;
  long long off0;
};

// A pair's shared memory: two windows, and for each its rows' table (x,
// y: st, en (FLAT: no en); z: the last cell the window holds, -1 none)
// and, COMPACT, the rows' offsets below off0 (rel[d] = off(r0) -
// off(r0 - d)); the walker's request to the stager; the masks of
// next_states.  Rows R .. R + 7 pad the table: a block of a walk whose
// window reaches row 0 reads up to REACH rows past its cell as
// candidates that cannot be taken.
struct __align__(16) PairSmem {
  uint8_t buf[2][WIN];
  int4 row[2][R + 8];
  int rel[2][R];
  Win req;         // the window the walker asks the stager for
  int req_buf;     // into which buffer; -1: no more windows
  unsigned keep[32];   // next_states' masks, by a byte's bits 3-7
};

__device__ __forceinline__ void cp16(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared loads issued in program order (asm volatile keeps them in order
// among themselves), so a block's loads all go out before its steps use
// them instead of one after another along the chain.
__device__ __forceinline__ int4 lds128(const int4* p) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

__device__ __forceinline__ int lds8(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return (int)v;
}

// The walker and the stager of a pair meet at two named barriers of the
// block's 64 threads: REQ, a window asked for, and DONE, its copies
// landed.  The shared writes before an arrive are seen after the sync.
constexpr int BAR_REQ = 1, BAR_DONE = 2;

__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// off(r) of the compact store (common.cuh: store_row_off) with its terms
// spread over the warp's lanes: lane l sums x = 16 (l + 1 + 32 k).
__device__ __forceinline__ long long store_row_off_warp(int r, int qlen,
                                                        int tlen, int w,
                                                        int lane) {
  long long s = 0;
  for (int x = 16 * (lane + 1); x <= tlen - 1; x += 16 * 32) {
    const int f = max(x, 2 * x - w);
    if (f >= r) break;
    s += r - f;
  }
  for (int x = 16 * (lane + 1);; x += 16 * 32) {
    const int f = min(x + qlen - 1, 2 * x + w - 1);
    if (f >= r) break;
    s -= r - f;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return 16 * (r + s);
}

// The walk's runs, from its ops (one a byte at ops[0 .. t - 1]) by the
// warp at the walk's end, 32 ops at a time: a ballot marks where the op
// changes, each lane at such a start that is not the chunk's last writes
// the run it starts, and the run open at the chunk's end carries over.
// They are ksw_backtrack's runs `len << 4 | op` in walk order, an op's
// run extended while it repeats; returns their count.
__device__ __forceinline__ int write_runs(const uint8_t* ops, int t,
                                          int* out, int lane) {
  int k = 0, cop = -1, clen = 0;
  for (int t0 = 0; t0 < t; t0 += 32) {
    const int q = t0 + lane;
    const int o = q < t ? ops[q] : -2;
    int prev = __shfl_up_sync(FULL, o, 1);
    if (lane == 0) prev = cop;
    const unsigned st = __ballot_sync(FULL, q < t && o != prev);
    const int cnt = min(32, t - t0);
    if (st == 0) {
      clen += cnt;
      continue;
    }
    if (cop >= 0) out[k++] = ((clen + __ffs(st) - 1) << 4) | cop;
    const unsigned after = st & ~((2u << lane) - 1u);
    if ((st >> lane) & 1 && after)
      out[k + __popc(st & ((1u << lane) - 1u))] =
          ((__ffs(after) - 1 - lane) << 4) | o;
    k += __popc(st) - 1;
    const int last = 31 - __clz(st);
    cop = __shfl_sync(FULL, o, last);
    clen = cnt - last;
  }
  if (clen > 0) out[k++] = (clen << 4) | cop;
  return k;
}

// The last cell of row r whose byte the store holds in the row (-1: none).
template <int FORM>
__device__ __forceinline__ int row_hi(const Pair& P, int r,
                                      const BandRow& bd) {
  if (r < 0) return -1;
  if (FORM == COMPACT) return r < P.rows ? bd.en : -1;
  if (FORM == ROTATED) return r < P.rows ? min(bd.en, bd.st + P.ncol - 1)
                                         : -1;
  return bd.st + P.ncol - 1;
}

// What a step does at cell i of a row of the table (see READ): the upper
// force (or the escape, `up`) before the lower, as ksw_backtrack tests
// them; selects, no branches.
template <int FORM>
__device__ __forceinline__ int cell_code(int i, const int4& e, int up) {
  int c = i > e.z ? DIRECT : READ;
  c = i < e.x ? DIR_F : c;
  return FORM != FLAT && i > e.y ? up : c;
}

// Issue the copies of window W into buf, and fill its rows' table (and,
// COMPACT, their offsets); one commit group.  Each lane takes the K rows
// d = K lane .. K lane + K - 1: one warp scan of their widths gives the
// compact rows' offsets.  (Inlined, as every function of the walk: a
// struct passed by reference to a call would live in local memory, a
// load on each step's chain.)
template <int FORM>
__device__ __forceinline__ void stage(const Pair& P, const Win& W,
                                      uint8_t* buf, int4* row, int* rel,
                                      int lane) {
  if (FORM == ROWMAJOR) {
    // store row i0 - k: the chunks of [max(j0 - (R - 1 - k), 0), j0], in
    // its row (j0 < qlen <= Lq, Lq % 16 == 0) and in its slot; none above
    // row 0.  No rows' table: row_entry computes it.
    const int j0 = W.r0 - W.i0;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int k = K * lane + kk, i = W.i0 - k, jlo = j0 - (R - 1 - k);
      if (i < 0) continue;
      const int rb = slot_row(k) - (jlo & ~15);
      const uint8_t* g = P.base + (size_t)i * P.ncol;
      for (int c = max(jlo, 0) >> 4; c <= j0 >> 4; ++c)
        cp16(buf + rb + 16 * c, g + 16 * c);
    }
    cp_commit();
    return;
  }
  int x[K], sum = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = W.r0 - (K * lane + k);
    x[k] = FORM == COMPACT && r >= 1
               ? store_row_width(r - 1, P.qlen, P.tlen, P.w)
               : 0;
    sum += x[k];
  }
  int excl = 0;
  if (FORM == COMPACT) {
    // rel[d] = widths of rows r0 - 1 .. r0 - d: an exclusive scan (R rows
    // of at most tlen + 16 bytes fit an int)
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    excl = inc - sum;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = K * lane + k, r = W.r0 - d;
    const BandRow bd = band_row(r, P.qlen, P.tlen, P.w);
    const int rb = slot_base(d) - ((W.i0 - d) & ~15);
    const int hi = row_hi<FORM>(P, r, bd);
    row[d] = make_int4(bd.st, FORM == FLAT ? 0x7fffffff : bd.en, hi, 0);
    long long roff = (long long)r * P.ncol;
    if (FORM == COMPACT) {
      rel[d] = excl;
      roff = W.off0 - excl;
      excl += x[k];
    }
    // the chunks of [max(i0 - d, st), min(i0, hi)]: in the row's stored
    // bytes (st and hi + 1 are multiples of 16) and in row d's slot; none
    // when the range is empty
    const uint8_t* g = P.base + (roff - bd.st);
    const int top = min(W.i0, hi) >> 4;
    for (int c = max(W.i0 - d, bd.st) >> 4; c <= top; ++c)
      cp16(buf + rb + 16 * c, g + 16 * c);
  }
  cp_commit();
}

// The byte of cell (i, j), d = r0 - (i + j) rows into window W, in the
// window's buffer: anti-diagonal row d's slot, or (ROWMAJOR) store row
// i0 - i's, whose first chunk holds j0 - (R - 1 - k).  Past the window
// (d >= R) the caller reads no byte of it.
template <int FORM>
__device__ __forceinline__ int win_byte(const Win& W, int d, int i, int j) {
  if (FORM == ROWMAJOR) {
    const int k = W.i0 - i;
    return slot_row(k) - ((W.r0 - W.i0 - (R - 1 - k)) & ~15) + j;
  }
  return slot_base(d) - ((W.i0 - d) & ~15) + i;
}

// Row d's entry of a window's rows' table (PairSmem::row), loaded; the
// row-major store's, unbanded, computed: st 0, no upper edge, every cell
// held fewer than R anti-diagonals from the anchor, the store read past
// them (cells a walk reaches only past i = -1 or j = -1, where it ends)
template <int FORM>
__device__ __forceinline__ int4 row_entry(const int4* row, int d) {
  if constexpr (FORM == ROWMAJOR)
    return make_int4(0, 0x7fffffff, d < R ? 0x7fffffff : -1, 0);
  else
    return lds128(row + d);
}

// A byte the window does not hold, read from the store itself: cell i of
// row r at roff + i - st (FLAT: 0 at and past size; ROWMAJOR: cell j of
// store row i, roff = i Lq and st = 0).  A call, so that the
// steps that read the window do not spend instructions on it.
template <int FORM>
__device__ __noinline__ int direct_byte(const uint8_t* base, long long roff,
                                        int i, int st, long long size) {
  const long long k = roff + (i - st);
  return FORM == FLAT && k >= size ? 0 : base[k];
}

// backtrack_step for every state at once: the next state of each state s
// (3 bits at 3 s) after byte b, so that a step along the walk's chain is
// one shift of this word.  A gap state s (1-7) goes on while bit s + 2 of
// the byte is set (bits 3-7: states 1-5), else, as from state 0, the
// byte's state b & 7; a force state f > 0 replaces every state.  `keep`
// holds, by the byte's bits 3-7, the mask of the fields that go on.
constexpr unsigned KEEP = 0xFAC688u;   // field s holds s
__device__ __forceinline__ unsigned next_states(int b, int f,
                                               const unsigned* keep) {
  const unsigned m = keep[(b >> 3) & 31];
  const unsigned nx = ((unsigned)(b & 7) * 0x249249u & ~m) | (KEEP & m);
  return f > 0 ? (unsigned)f * 0x249249u : nx;
}

// a movement of the walk (0: M, 1: I, 2: D or N) and its steps in i, j
// and the window's rows
__device__ __forceinline__ int mv_di(int m) { return m == 1 ? 0 : -1; }
__device__ __forceinline__ int mv_dj(int m) { return m == 2 ? 0 : -1; }
__device__ __forceinline__ int mv_dd(int m) { return m == 0 ? 2 : 1; }

template <int FORM>
__device__ __forceinline__ Pair pair_of(const Args& A, int b) {
  Pair P;
  // ROWMAJOR: no lengths or band (the walk starts from a cell of the
  // store and ends where i or j does)
  P.qlen = FORM == ROWMAJOR ? 0 : A.qlens[b];
  P.tlen = FORM == ROWMAJOR ? 0 : A.tlens[b];
  P.w = FORM == ROWMAJOR ? 0 : A.ws[b];
  P.size = 0;
  if (FORM == ROTATED) {
    P.base = A.p + (size_t)b * A.nd * A.ncol;
    P.rows = A.nd;
    P.ncol = A.ncol;
  } else if (FORM == COMPACT) {
    P.base = A.p + A.pbase[b];
    P.rows = first_empty_diag(P.qlen, P.tlen, P.w);
    P.ncol = 0;
  } else if (FORM == ROWMAJOR) {
    P.base = A.p + (size_t)b * A.nd * A.ncol;
    P.rows = A.nd;
    P.ncol = A.ncol;
  } else {
    P.base = A.p + A.pbase[b];
    P.ncol = ((min(P.w + 1, P.tlen) + 15) / 16 + 1) * 16;
    P.rows = P.qlen + P.tlen;
    P.size = (long long)P.rows * P.ncol;
  }
  if (reinterpret_cast<uintptr_t>(P.base) & 15) __trap();
  return P;
}

// The stager warp: it stages each window the walker asks for, waits for
// its copies and tells the walker, until the walker asks for none.
template <int FORM>
__device__ __forceinline__ void stager(const Args& A, PairSmem& S, int b,
                                       int lane) {
  const Pair P = pair_of<FORM>(A, b);
  while (true) {
    bar_sync(BAR_REQ);
    const Win W = S.req;
    const int k = S.req_buf;
    if (k < 0) return;
    stage<FORM>(P, W, S.buf[k], S.row[k], S.rel[k], lane);
    cp_wait();
    bar_arrive(BAR_DONE);
  }
}

// The walker warp: ksw_backtrack from the pair's start cell, reading the
// windows the stager fills.
template <int FORM>
__device__ __forceinline__ void walker(const Args& A, PairSmem& S, int b,
                                       int lane) {
  const Pair P = pair_of<FORM>(A, b);
  // state_op as a word, 4 bits a state: M, D, I, D or N, and I for the
  // rest
  const unsigned ops = A.min_intron > 0 && FORM != FLAT ? 0x11113120u
                                                        : 0x11112120u;
  const int up = FORM == COMPACT && A.upper_force == 0 ? ESCAPE : DIR_E;
  // the lane's guess at a block's first three movements (lanes 27-31
  // repeat lanes 0-4) and the cells they lead to, relative to its first
  const int m1 = lane % 3, m2 = lane / 3 % 3, m3 = lane / 9 % 3;
  const int di1 = mv_di(m1), di2 = di1 + mv_di(m2), di3 = di2 + mv_di(m3);
  const int dj1 = mv_dj(m1), dj2 = dj1 + mv_dj(m2), dj3 = dj2 + mv_dj(m3);
  const int dd1 = mv_dd(m1), dd2 = dd1 + mv_dd(m2), dd3 = dd2 + mv_dd(m3);
  uint8_t* const opb = A.ops + (size_t)b * A.wr;
  int t = 0;   // the walk's steps so far
  {
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 5; ++q)
      if ((lane >> q) & 1) m |= 7u << (3 * (q + 1));
    S.keep[lane] = m;
    __syncwarp();
  }
  int i = A.starts[2 * b], j = A.starts[2 * b + 1];
  int state = 0, esc = 0;
  bool pending = false;
  if (i >= 0 && j >= 0) {
    Win W{i, i + j, 0};
    if (FORM == COMPACT)
      W.off0 = store_row_off_warp(W.r0, P.qlen, P.tlen, P.w, lane);
    int cb = 0;
    S.req = W;
    S.req_buf = 0;
    bar_arrive(BAR_REQ);
    bar_sync(BAR_DONE);
    const uint8_t* buf = S.buf[0];
    const int4* row = S.row[0];
    const int* rel = S.rel[0];
    Win N = W;
    // the row at which the walk must act on its windows: ask for the next
    // one (HALF, unless the window reaches row 0) or switch to it (its
    // reads would leave the window)
    int dact = W.r0 >= R ? HALF : 0x7fffffff;
    while (true) {
      int d = W.r0 - (i + j);
      if (d >= dact) {
        if (pending) {   // the next window was asked for at HALF
          bar_sync(BAR_DONE);
          W = N;
          cb ^= 1;
          pending = false;
          buf = S.buf[cb];
          row = S.row[cb];
          rel = S.rel[cb];
          d = W.r0 - (i + j);
        }
        if (d >= HALF && W.r0 >= R) {
          N = Win{i, i + j, FORM == COMPACT ? W.off0 - rel[d] : 0};
          S.req = N;
          S.req_buf = cb ^ 1;
          bar_arrive(BAR_REQ);
          pending = true;
        }
        dact = pending ? R - REACH : W.r0 >= R ? HALF : 0x7fffffff;
      }
      // A block of up to LOOK steps.  Each lane reads the rows and bytes
      // of the cells its guess leads to (all loads at once, the bytes'
      // places worked out from the window's anchor, none waiting on a
      // step) and runs ksw_backtrack's steps along its guess, keeping the
      // last that matched the walk's movements; the lane that got
      // furthest holds the walk's steps.  A block stops before a cell
      // with a rare code and at the walk's end.
      const int d1 = d + dd1, d2 = d + dd2, d3 = d + dd3;
      const int i1 = i + di1, i2 = i + di2, i3 = i + di3;
      const int4 e0 = row_entry<FORM>(row, d), e1 = row_entry<FORM>(row, d1),
                 e2 = row_entry<FORM>(row, d2), e3 = row_entry<FORM>(row, d3);
      const int a1 = win_byte<FORM>(W, d1, i1, j + dj1);
      const int a2 = win_byte<FORM>(W, d2, i2, j + dj2);
      const int a3 = win_byte<FORM>(W, d3, i3, j + dj3);
      const int b0 = lds8(buf + win_byte<FORM>(W, d, i, j));
      const int b1 = lds8(buf + (d1 < R ? a1 : 0));
      const int b2 = lds8(buf + (d2 < R ? a2 : 0));
      const int b3 = lds8(buf + (d3 < R ? a3 : 0));
      const int f0 = cell_code<FORM>(i, e0, up);
      if (f0 < READ) {   // one step on its own: an escape, or a direct read
        if (f0 == ESCAPE) {
          esc = 1;
          break;
        }
        // (ROWMAJOR: cell j of store row i)
        const int nb = direct_byte<FORM>(
            P.base,
            FORM == COMPACT ? W.off0 - rel[d]
                            : (long long)(FORM == ROWMAJOR ? i : i + j) *
                                  P.ncol,
            FORM == ROWMAJOR ? j : i, e0.x, P.size);
        state = backtrack_step(state, nb, -1);
        const int o = state_op(state, FORM == FLAT ? 0 : A.min_intron);
        if (lane == 0) opb[t] = o;
        ++t;
        step_back(o, i, j);
        if ((i | j) < 0) break;
        continue;
      }
      const int f1 = cell_code<FORM>(i1, e1, up);
      const int f2 = cell_code<FORM>(i2, e2, up);
      const int f3 = cell_code<FORM>(i3, e3, up);
      // the lane's walk along its guess (backtrack_step: a gap state goes
      // on while its continuation bit is set, else the byte's state; a
      // force state overrides both; the op's movement is min(op, 2)), and
      // its last step that matched, kept off the walk's chain
      const unsigned x0 = next_states(b0, f0, S.keep),
                     x1 = next_states(b1, f1, S.keep),
                     x2 = next_states(b2, f2, S.keep),
                     x3 = next_states(b3, f3, S.keep);
      int s = state, ci = i, cj = j;
      int ks = 0, ki = 0, kj = 0, got = 0, n = 0;
      bool alive = true;
#pragma unroll
      for (int k = 0; k < LOOK; ++k) {
        const unsigned xk = k == 0 ? x0 : k == 1 ? x1 : k == 2 ? x2 : x3;
        s = (xk >> (3 * s)) & 7;
        const int o = (ops >> (4 * s)) & 15;
        ci -= o != OP_I;
        cj -= o <= OP_I;
        ks = alive ? s : ks;
        ki = alive ? ci : ki;
        kj = alive ? cj : kj;
        got = alive ? got | o << (2 * k) : got;
        n = alive ? k + 1 : n;
        if (k + 1 < LOOK) {
          const int mk = k == 0 ? m1 : k == 1 ? m2 : m3;
          const int fn = k == 0 ? f1 : k == 1 ? f2 : f3;
          alive = alive && (ci | cj) >= 0 && min(o, 2) == mk && fn >= READ;
        }
      }
      const int best = __reduce_max_sync(FULL, (n << 5) | lane);
      const int src = best & 31;
      n = best >> 5;
      state = __shfl_sync(FULL, ks, src);
      i = __shfl_sync(FULL, ki, src);
      j = __shfl_sync(FULL, kj, src);
      got = __shfl_sync(FULL, got, src);
      if (lane < n) opb[t + lane] = (got >> (2 * lane)) & 3;
      t += n;
      if ((i | j) < 0) break;
    }
  }
  // let the stager go: after the window in flight, no more
  if (pending) bar_sync(BAR_DONE);
  S.req_buf = -1;
  bar_arrive(BAR_REQ);
  __syncwarp();   // the ops' stores, seen by every lane
  const int nruns = write_runs(opb, t, A.runs + (size_t)b * A.wr, lane);
  if (lane == 0) {
    const int rw_ = FORM == COMPACT ? 4 : 3;
    A.res[rw_ * b] = i;
    A.res[rw_ * b + 1] = j;
    A.res[rw_ * b + 2] = nruns;
    if (FORM == COMPACT) A.res[rw_ * b + 3] = esc;
  }
}

namespace {

// a block a pair: warp 0 walks, warp 1 stages; 10,016 bytes of shared
// memory
template <int FORM>
__global__ void __launch_bounds__(64) walk_kernel(Args A) {
  __shared__ PairSmem S;
  if (threadIdx.x < 32)
    walker<FORM>(A, S, blockIdx.x, threadIdx.x);
  else
    stager<FORM>(A, S, blockIdx.x, threadIdx.x - 32);
}

}  // namespace

// One warp a pair on `stream`; returns cudaGetLastError() after the
// launch.  The kernel asks for the SM's largest shared-memory carveout,
// so that 8 walks share an SM.
template <int FORM>
int launch(const Args& A, cudaStream_t stream) {
  static const cudaError_t carve = cudaFuncSetAttribute(
      walk_kernel<FORM>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  walk_kernel<FORM><<<A.B, 64, 0, stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace walk
}  // namespace ksw2t
