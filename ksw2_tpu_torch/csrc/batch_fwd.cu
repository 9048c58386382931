// Batched forward (kernels E and E2): the anti-diagonal difference DP of
// many pairs at once (extz and extd, exact or approximate max, score and
// direction bytes): one warp a pair in the register form, this file's
// kernel; the wide form is band_fwd.cu's block a pair.  The same register
// kernel in its SPL mode is kernel 6's register form (below).
//
// Replaces ksw2_tpu/ops/wavefront_batch.py:_batch_kernel_body (one-piece,
// counted as batch_fwd) and ksw2_tpu/ops/wavefront_batch_extd.py:
// _batch_extd_kernel (two-piece, TWO, counted as batch_extd_fwd).  It
// computes what spec/diagdiff.py:extz2 and extd2 specify with any band w
// (w = 0 and unbanded included) on targets of up to 3072: per
// anti-diagonal r = i + j the Suzuki-Kasahara deltas u, v, x, y (and x2,
// y2) in wrapping int8 over the 16-rounded band [st, en]
// (ksw2_extz2_sse.c:107-205, ksw2_extd2_sse.c), the int32 H row with the
// SSE 4-lane argmax tie order and ksw_apply_zdrop, or the O(1) H0 walk
// (APPROX), the mqe / mte captures and the score, written as the 9-field
// record of ops/records.py; with CIG the reference's direction byte of
// every cell of [st, en] into the rotated store p[b][r][t - st(r)] with
// n_col bytes a diagonal, the store band_fwd.cu writes, so band_walk.cu
// walks it unchanged.  The plain version is ops/band.py:
// band_forward_plain.
//
// Two forms, chosen on the host from the launch's n_col and m
// (ops/batch.py:batch_form), never at run time:
//
// The register form (batch_reg_kernel) keeps a pair's state in its warp's
// registers: a window of W = 32 CPL = 256 target positions based at
// (st - 1) & ~31, lane l holding positions base + CPL l .. + CPL - 1.
// The window holds every position a diagonal reads or writes (st - 1 up
// to en0 + 15 >= en and the score fill's end) while n_col + 48 <= W, so
// the reference's stale bytes (the edge byte at st - 1, the score bytes
// in [st, st0) and past the fill, H at st0 - 1) persist as they do in its
// SSE rows.  The int8 planes sit in the top byte of an int32 (v << 24),
// so int32 adds wrap as epi8 adds and compare as signed and unsigned byte
// compares do.  A cell reads t - 1's old state from its own lane's
// registers: the warp makes one shuffle a plane a diagonal.  [st, en] is
// whole lanes (st is a multiple of 16, en + 1 too), so a lane either
// computes all its cells or none.  A lane keeps its positions' target
// and query symbols a nibble each in one register apiece (bit 3 marks N)
// and their score bytes four to a register: a diagonal's simple scores
// are a code a cell (the symbols differ, either is N) made for 8 cells
// with a few word operations, and one prmt of the 4-byte table [mch,
// mis, scN, scN] scores 4 cells (generic scores come from the matrix in
// shared memory).  The query symbols move up one position a diagonal (the
// query advances along the anti-diagonal), a new one entering at the
// window's bottom from 64 symbols staged a group of 32 diagonals.  When
// st - 1 passes base + 32 the window slides up 32 positions (4 lanes)
// by shuffles; the positions that enter are fresh (init bytes, the
// target's symbols, prefetched a group ahead).  The diagonal's maximum is
// one __reduce_max_sync of the lanes' best H, and its position one
// __reduce_min_sync of each lane's best SSE rank among its cells that
// hold it (ties are common on short reads), taken
// from bit masks with no branch: the en0 cell, then the lowest lane class
// (the same for every lane), then the tail.  Lane j keeps diagonal
// r_lo + j's (maxH, t) (or the
// H0 walk's) and H(st0), H(en0) over a group of 32; at the group's end
// the warp replays Z-drop, mqe / mte and the score in order: an
// exclusive running maximum with its first position (ksw_apply_zdrop's
// strict >) is a 5-round scan, and the first diagonal whose test fails,
// by ballot, is the stop.  The warp has run up to 31 diagonals past a
// drop; it zeroes the store rows it wrote past the stop.  With CIG a lane
// writes its CPL direction bytes with one 8-byte store.
//
// Kernel 6's register form (SPL, counted as batch_exts_fwd) replaces
// ksw2_tpu/ops/wavefront_batch_exts.py:_batch_exts_kernel on the launches
// whose window holds them: the exts recurrence of spec/diagdiff.py:exts2
// (ksw2_exts2_sse.c) over [st, en] with w = qlen + tlen (exts has no
// band): u, v, x, y initialised to -(q + e) and the intron plane x2 to
// -q2, shifted at a slide as the other planes are; a position's donor and
// acceptor bytes four to a register beside its score bytes, the entering
// positions' prefetched a group ahead with their target; the intron
// candidate a2 + acceptor beside a and b with no clamp of z, x2' =
// max(a2', donor) - q2; the first-column switch ucol(r) is TWO's column
// value with e2 = 0, H signed and seeded -(q + e) (qe_pre), and Z-drop has
// no gap slope (e2 = 0).  With CIG a cell's direction code rides in the
// low bits of its candidates (a priority each, the reference's tie rule
// by their order), one max picks value and code.  The replay reads a
// diagonal's best position only where its maximum beats the running one
// or falls more than zdrop below it, so the warp skips the lane rank on
// the other diagonals.  CPL is 16 (W = 512: the splice launches' n_col
// of 320 needs more than E's 256); ops/batch_exts.py:exts_form gives
// launches the window cannot hold (n_col > 464), and alphabets of more
// than 8 symbols, kernel 6's wide form: band_fwd.cu's block a pair in its
// SPL mode.
//
// The wide form takes launches whose band is wider than the window
// (unbanded pairs up to 1536 bp CIGARs, 3072 scores) or m > 8: the band
// forward's block a pair, launched from band_fwd.cu by ops/batch.py in
// the layout of ops/batch.py:wide_layout (tiles of 64 positions, 128 for
// scores past n_col 1602; the score matrix in shared memory for m > 8).
// An unbanded pair meets every tile for ~qlen diagonals, so its tiles
// are all live at once and nw is about its tile count; the launch's
// pairs go longest first, so its tail is not a long pair started last.
//
// What bounds them on an H100.  The register form: each warp's chain of
// a diagonal's steps (about 2,500 cycles a warp-diagonal with clock
// stamps at w = 100: the head (band row, slide, query, score fill,
// neighbour shuffles) and the two warp reductions of the argmax ~70%,
// the cells ~25%; chip_smoke.py --breakdown batch), interleaved over the
// 3-4 warps a sub-partition that 128 registers leave, so a launch of
// many pairs runs at 3.2-3.8x the integer-pipe bound of its band cells
// (chip_smoke.py: OPS); half the window's cells are idle at w = 100. The
// wide form: the band kernel's, the SM's integer pipe over a pair's tile
// steps, a pair to an SM.  With CIG the n_col bytes a diagonal are the
// only large memory traffic.
#include <climits>

#include "reg_window.cuh"

using namespace ksw2t;

// clock64 stamps of a diagonal's parts, empty here: chip_smoke.py
// --breakdown batch builds a copy that defines them
#ifndef BATCH_STAMPS
#define BATCH_STAMP_INIT()
#define BATCH_STAMP(part)
#define BATCH_STAMP_FLUSH(diags)
#endif

namespace {

constexpr int NEG = -0x40000000;    // NEG_INF of core/flags.py
constexpr int KT = 4096;            // tie-rank class stride (ops/band.py)
constexpr int MAX_WARPS = 8;
constexpr int KD = 32;              // diagonals a group (a lane each)
constexpr unsigned FULL = 0xffffffffu;
constexpr int CPL_E = 8;            // E / E2's register form: positions a lane
constexpr int CPL_S = 16;           // kernel 6's (SPL): W = 512

// The position of the SSE scan's tie rank on a diagonal with band [st0,
// en0]: rank 0 the en0 cell, then 4 lane classes over [st0, en1) (rank
// class * KT + rel + 1), then the scalar tail (4 KT + rel + 1).
__device__ __forceinline__ int rank_pos(int rank, int st0, int en0) {
  return rank == 0 ? en0
         : rank <= 4 * KT ? st0 + (rank - 1) % KT
                          : st0 + rank - 1 - 4 * KT;
}

struct BatchArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const int* table;
  int B, Lq, Lt, m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N;
  int zdrop, right, generic, adrop, nd, ncol;
  int* rec;
  uint8_t* p;
  const uint8_t* don;                // SPL: the donor and acceptor rows
  const uint8_t* acc;
};

// The register form: see the head of the file.  RIGHT only where it
// matters (the direction bytes).  SPL: kernel 6's exts recurrence (its
// launches set e2 = 0 and qe_pre = q + e; signed deltas as TWO's)
template <int CPL, bool TWO, bool SPL, bool CIG, bool APPROX, bool RIGHT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
batch_reg_kernel(const BatchArgs A) {
  static_assert(!(TWO && SPL) && (CPL == 8 || CPL == 16));
  constexpr bool SGN = TWO || SPL;   // signed deltas, the H row unbiased
  constexpr int W = 32 * CPL, SLANES = 32 / CPL;
  __shared__ int stab[64];
  if (A.generic)
    for (int i = threadIdx.x; i < A.m * A.m; i += blockDim.x)
      stab[i] = A.table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= A.B) return;              // a whole warp; no barrier after this
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  // the launch's form holds bands of at most n_col - 16 cells
  if (min(min(w + 1, qlen), tlen) + 16 > A.ncol || A.ncol + 48 > W) __trap();
  const int q = A.q, e = A.e;
  const int qe = q + e, qe2 = A.q2 + A.e2;
  const int ez = SGN ? A.e2 : e;     // Z-drop gap slope
  const int initS = top(SGN ? -qe : 0), init2S = top(-qe2);
  const int qS = top(q), q2S = top(A.q2), qeS = top(qe), qe2S = top(qe2),
            mchS = top(A.sc_mch), twoqeS = top(2 * qe);
  const unsigned capS = (unsigned)top(A.sc_mch + 2 * qe);
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  uint8_t* prow = CIG ? A.p + (size_t)b * A.nd * A.ncol : nullptr;
  const uint8_t* dg = SPL ? A.don + (size_t)b * A.Lt : nullptr;
  const uint8_t* ag = SPL ? A.acc + (size_t)b * A.Lt : nullptr;
  const int ndb = qlen + tlen - 1;
  const int rlim = first_empty_diag(qlen, tlen, w);

  // lane l's positions base + CPL l + k: the planes in the top-byte form
  // and H; the positions' score bytes (S4, cell k in byte k & 3 of S4[k /
  // 4]); their target and their query symbols on the last diagonal, a
  // nibble each (Tn, Qn: cell k at bits 4k)
  int U[CPL], V[CPL], X[CPL], Y[CPL], X2[CPL], Y2[CPL], H[CPL];
  unsigned S4[CPL / 4];
  Nibs<CPL> Tn, Qn = 0;              // Qn: diagonal -1's, query -1 - t
  // SPL: the positions' donor and acceptor bytes, four to a register
  unsigned DN4[SPL ? CPL / 4 : 1], AC4[SPL ? CPL / 4 : 1];
  // the simple scores by a cell's code: 0 match, 1 mismatch, 2-3 N
  const int TAB = (int)((unsigned)(A.sc_mch & 255) |
                        (unsigned)(A.sc_mis & 255) << 8 |
                        (unsigned)(A.sc_N & 255) * 0x10100u << 8);
  int base = 0;
  {
    unsigned tw[CPL / 4];
    load_target<CPL>(tg, A.Lt, CPL * lane, tw);
    Tn = target_nibbles<CPL>(tw, A.m);
    if constexpr (SPL) {
      load_target<CPL>(dg, A.Lt, CPL * lane, DN4);
      load_target<CPL>(ag, A.Lt, CPL * lane, AC4);
    }
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) S4[i] = 0;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      U[k] = V[k] = X[k] = Y[k] = initS;
      X2[k] = Y2[k] = init2S;
      H[k] = NEG;
    }
    // the seed diagonal 0's generic H step reads (t = 0)
    if (lane == 0) H[0] = SGN ? -A.qe_pre : -qe;
  }

  int last_st = -1, last_en = -1, H0 = 0, lt0 = 0;
  int mx = 0, mt = -1, mq = -1, mqe = NEG, mqet = -1, mte = NEG, mteq = -1;
  int score = NEG, zd = 0, done_diags = 0;
  BATCH_STAMP_INIT();
  // the slide target of the first group and its fresh target bytes; the
  // query symbols of the first group
  auto group_base = [&](int r) {
    return window_base(band_row(r, qlen, tlen, w).st);
  };
  unsigned tnext[CPL / 4];
  unsigned dnext[SPL ? CPL / 4 : 1], anext[SPL ? CPL / 4 : 1];
  int qAn, qBn;
  {
    const int r_hi = min(KD - 1, rlim - 1);
    load_target<CPL>(tg, A.Lt, group_base(r_hi) + CPL * lane, tnext);
    if constexpr (SPL) {
      load_target<CPL>(dg, A.Lt, group_base(r_hi) + CPL * lane, dnext);
      load_target<CPL>(ag, A.Lt, group_base(r_hi) + CPL * lane, anext);
    }
    const int q0 = 0 - group_base(0);
    qAn = load_q(qy, qlen, A.m, q0 - 32 + lane);
    qBn = load_q(qy, qlen, A.m, q0 + lane);
  }

  for (int r_lo = 0; r_lo < rlim; r_lo += KD) {
    const int r_hi = min(r_lo + KD - 1, rlim - 1), n = r_hi - r_lo + 1;
    // this group's staged query and slide bytes; the next group's, in
    // flight while this one runs
    const int qA = qAn, qB = qBn;
    const int q0 = r_lo - group_base(r_lo);
    unsigned tcur[CPL / 4];
    unsigned dcur[SPL ? CPL / 4 : 1], acur[SPL ? CPL / 4 : 1];
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) tcur[i] = tnext[i];
    if constexpr (SPL) {
#pragma unroll
      for (int i = 0; i < CPL / 4; ++i) {
        dcur[i] = dnext[i];
        acur[i] = anext[i];
      }
    }
    if (r_hi + 1 < rlim) {
      const int n_lo = r_hi + 1, n_hi = min(n_lo + KD - 1, rlim - 1);
      load_target<CPL>(tg, A.Lt, group_base(n_hi) + CPL * lane, tnext);
      if constexpr (SPL) {
        load_target<CPL>(dg, A.Lt, group_base(n_hi) + CPL * lane, dnext);
        load_target<CPL>(ag, A.Lt, group_base(n_hi) + CPL * lane, anext);
      }
      const int nq0 = n_lo - group_base(n_lo);
      qAn = load_q(qy, qlen, A.m, nq0 - 32 + lane);
      qBn = load_q(qy, qlen, A.m, nq0 + lane);
    }
    // lane j's diagonal r_lo + j: its maximum and position (or the H0
    // walk's H0 and lt0), H(st0) and H(en0)
    int gH = INT_MIN, gT = 0, gS = 0, gE = 0;
    [[maybe_unused]] int run = mx;     // SPL: the running maximum
    BATCH_STAMP(5);

    for (int rr = 0; rr < n; ++rr) {
      const int r = r_lo + rr;
      const BandRow bd = band_row(r, qlen, tlen, w);
      const int st0 = bd.st0, en0 = bd.en0, st = bd.st, en = bd.en;
      const int nb = window_base(st);
      if (nb != base) {
        // the slide (nb == base + 32): 32 positions down, fresh on top
        const bool fresh = lane >= 32 - SLANES;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int u = __shfl_down_sync(FULL, U[k], SLANES);
          const int v = __shfl_down_sync(FULL, V[k], SLANES);
          const int x = __shfl_down_sync(FULL, X[k], SLANES);
          const int y = __shfl_down_sync(FULL, Y[k], SLANES);
          const int h = __shfl_down_sync(FULL, H[k], SLANES);
          U[k] = fresh ? initS : u;
          V[k] = fresh ? initS : v;
          X[k] = fresh ? initS : x;
          Y[k] = fresh ? initS : y;
          H[k] = fresh ? NEG : h;
          if (TWO) {
            const int x2 = __shfl_down_sync(FULL, X2[k], SLANES);
            const int y2 = __shfl_down_sync(FULL, Y2[k], SLANES);
            X2[k] = fresh ? init2S : x2;
            Y2[k] = fresh ? init2S : y2;
          } else if (SPL) {
            const int x2 = __shfl_down_sync(FULL, X2[k], SLANES);
            X2[k] = fresh ? init2S : x2;
          }
        }
#pragma unroll
        for (int i = 0; i < CPL / 4; ++i) {
          const unsigned s4 = __shfl_down_sync(FULL, S4[i], SLANES);
          S4[i] = fresh ? 0u : s4;
          if constexpr (SPL) {
            const unsigned d4 = __shfl_down_sync(FULL, DN4[i], SLANES);
            const unsigned a4 = __shfl_down_sync(FULL, AC4[i], SLANES);
            DN4[i] = fresh ? dcur[i] : d4;
            AC4[i] = fresh ? acur[i] : a4;
          }
        }
        const Nibs<CPL> tn = __shfl_down_sync(FULL, Tn, SLANES);
        Tn = fresh ? target_nibbles<CPL>(tcur, A.m) : tn;
        // a fresh position's query symbol is never filled before the
        // symbols from below have replaced it
        const Nibs<CPL> qd = __shfl_down_sync(FULL, Qn, SLANES);
        Qn = fresh ? (Nibs<CPL>)0 : qd;
        base = nb;
      }
      const int p0 = base + CPL * lane;
      // the query moves up one position; symbol r - base enters at the
      // bottom, from the group's staged 64 (the group slides at most once)
      {
        const int idx = r - base - (q0 - 32);
        const int ins = __shfl_sync(FULL, idx < 32 ? qA : qB, idx & 31);
        unsigned up;
        if constexpr (CPL == 8)
          up = (__shfl_up_sync(FULL, Qn, 1) >> (4 * (CPL - 1))) & 15u;
        else
          up = __shfl_up_sync(FULL, (unsigned)(Qn >> (4 * (CPL - 1))), 1);
        Qn = (Qn << 4) | (lane == 0 ? (unsigned)ins : up);
      }
      if (CIG && en - st + 1 > A.ncol) __trap();   // the store's row width
      // the boundary entering lane st (ksw2_extz2_sse.c:152-158) and the
      // first-column value (the j == 0 cell at t == r)
      const bool prevok = st > 0 && last_st <= st - 1 && st - 1 <= last_en;
      const int colv =
          SGN ? (r == 0 ? -qe : (r < A.lt ? -e : (r == A.lt ? A.ld : -A.e2)))
              : (r ? q : 0);
      const int colvS = top(colv);
      // the score fill: [st0, hi]; the other positions keep stale bytes
      const int hi = A.generic ? en0 : st0 + ((en0 - st0) & ~15) + 15;
      const unsigned fm = cell_mask<CPL>(st0 - p0, hi - p0);
      {
        // the cells' scores: simple ones by a code a cell (bit 0: the
        // symbols differ, bit 1: either is N) and one prmt for 4 cells,
        // generic ones from the matrix
        unsigned sn[CPL / 4];
        if (!A.generic) {
          using N = Nibs<CPL>;
          const N d = (Tn ^ Qn) & (N)0x7777777777777777ull;
          const N code = ((d | d >> 1 | d >> 2) & (N)0x1111111111111111ull) |
                         ((Tn | Qn) & (N)0x8888888888888888ull) >> 2;
#pragma unroll
          for (int i = 0; i < CPL / 4; ++i)
            sn[i] = (unsigned)prmt(TAB, TAB, (unsigned)(code >> (16 * i)));
        } else {
#pragma unroll
          for (int i = 0; i < CPL / 4; ++i) sn[i] = 0;
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int T = (Tn >> (4 * k)) & 7, Q = (Qn >> (4 * k)) & 7;
            sn[k >> 2] |= (unsigned)(stab[T * A.m + Q] & 255) << (8 * (k & 3));
          }
        }
#pragma unroll
        for (int i = 0; i < CPL / 4; ++i) {
          const unsigned bm = byte_mask(fm >> (4 * i));
          S4[i] = (S4[i] & ~bm) | (sn[i] & bm);
        }
      }
      if (r <= en) {
        // the first column lies in the band: its cell reads colv, init
        const int kc = r - p0;
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          if (k == kc) {
            U[k] = colvS;
            Y[k] = initS;
            if (TWO) Y2[k] = init2S;
          }
      }
      // t - 1's old state for the first cell (lane 0's first position is
      // below st, never in the band)
      int Xm0 = __shfl_up_sync(FULL, X[CPL - 1], 1);
      int Vm0 = __shfl_up_sync(FULL, V[CPL - 1], 1);
      int X2m0 = SGN ? __shfl_up_sync(FULL, X2[CPL - 1], 1) : 0;
      const int Hm0 = APPROX ? 0 : __shfl_up_sync(FULL, H[CPL - 1], 1);
      if (p0 == st && !prevok) {
        Xm0 = initS;
        Vm0 = st == 0 ? colvS : initS;
        X2m0 = init2S;
      }
      const bool inb = p0 >= st && p0 + CPL - 1 <= en;
      const unsigned hmask = cell_mask<CPL>(st0 - p0, en0 - p0);
      const int ke = en0 > 0 ? en0 - p0 : -1;   // the en0 cell's H form
      const int sub = SGN ? 0 : qe;
      int bh = INT_MIN;
      unsigned dw[CPL / 4];
#pragma unroll
      for (int i = 0; i < CPL / 4; ++i) dw[i] = 0;
      BATCH_STAMP(0);
      // the diagonal's cells, last first: cell k reads k - 1's old state
      if (inb) {
#pragma unroll
        for (int k = CPL - 1; k >= 0; --k) {
          const int X1 = k ? X[k - 1] : Xm0, V1 = k ? V[k - 1] : Vm0;
          const int X21 = SGN ? (k ? X2[k - 1] : X2m0) : 0;
          const int Hp = APPROX ? 0 : (k ? H[k - 1] : Hm0);
          const int Uc = U[k];
          int a = wadd(X1, V1), bb = wadd(Y[k], Uc);
          int d = 0, un, vn;
          if constexpr (SPL) {
            // exts (ksw2_exts2_sse.c): the intron candidate a2 +
            // acceptor beside a and b, no clamp of z; x2' = max(a2',
            // donor) - q2
            int a2 = wadd(X21, V1);
            const int c3 = wadd(a2, score_top(AC4, k));
            int z = score_top(S4, k);
            // CIG: the winner's code rides in the low bits the top-byte
            // form leaves 0, a priority a candidate (S 0, a 1, b 2, the
            // intron 3): the largest wins, a tie to the first (the
            // reference's strict >) or with RIGHT to the last (>=)
            constexpr int P0 = RIGHT ? 0 : 3, P1 = RIGHT ? 1 : 2,
                          P2 = RIGHT ? 2 : 1, P3 = 3 - P0;
            if (CIG) {
              a = wadd(a, P1);
              bb = wadd(bb, P2);
              const int zp =
                  max(__vimax3_s32(wadd(z, P0), a, bb), wadd(c3, P3));
              d = RIGHT ? (zp & 3) : ((zp & 3) ^ 3);
              z = zp & (int)0xff000000u;
            } else {
              z = max(__vimax3_s32(z, a, bb), c3);
            }
            un = wsub(z, V1);
            vn = wsub(z, Uc);
            const int t1 = wsub(z, qS);
            a = wsub(a, CIG ? wadd(t1, P1) : t1);
            bb = wsub(bb, CIG ? wadd(t1, P2) : t1);
            a2 = wsub(a2, wsub(z, q2S));
            const int Dn = score_top(DN4, k);
            if (CIG) {
              const bool ca = RIGHT ? a >= 0 : a > 0;
              const bool cb = RIGHT ? bb >= 0 : bb > 0;
              const bool cd = RIGHT ? a2 >= Dn : a2 > Dn;
              d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
                   (cd ? DIR_N_CONT : 0);
            }
            X[k] = wsub(max(a, 0), qeS);
            Y[k] = wsub(max(bb, 0), qeS);
            X2[k] = wsub(max(a2, Dn), q2S);
          } else if (!TWO) {
            const int zz = wadd(score_top(S4, k), twoqeS);
            if (CIG) d = RIGHT ? (zz > a ? 0 : DIR_E) : (a > zz ? DIR_E : 0);
            int z = max(zz, a);
            if (CIG) d = RIGHT ? (z > bb ? d : DIR_F) : (bb > z ? DIR_F : d);
            z = (int)max((unsigned)z, (unsigned)bb);     // max_epu8
            z = (int)min((unsigned)z, capS);             // min_epu8
            un = wsub(z, V1);
            vn = wsub(z, Uc);
            const int z2 = wsub(z, qS);
            a = wsub(a, z2);
            bb = wsub(bb, z2);
            if (CIG) {
              const bool ta = RIGHT ? a >= 0 : a > 0;
              const bool tb = RIGHT ? bb >= 0 : bb > 0;
              d |= (ta ? DIR_E_CONT : 0) | (tb ? DIR_F_CONT : 0);
            }
            X[k] = max(a, 0);
            Y[k] = max(bb, 0);
          } else {
            int a2 = wadd(X21, V1), b2 = wadd(Y2[k], Uc);
            int z = score_top(S4, k);
            if (CIG) {
              const int cand[4] = {a, bb, a2, b2};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                d = RIGHT ? (z > cand[i] ? d : i + 1)
                          : (cand[i] > z ? i + 1 : d);
                z = max(z, cand[i]);
              }
            } else {
              z = __vimax3_s32(__vimax3_s32(z, a, bb), a2, b2);
            }
            z = min(z, mchS);
            un = wsub(z, V1);
            vn = wsub(z, Uc);
            const int t1 = wsub(z, qS), t2 = wsub(z, q2S);
            a = wsub(a, t1);
            bb = wsub(bb, t1);
            a2 = wsub(a2, t2);
            b2 = wsub(b2, t2);
            if (CIG) {
              const bool ca = RIGHT ? a >= 0 : a > 0;
              const bool cb = RIGHT ? bb >= 0 : bb > 0;
              const bool ca2 = RIGHT ? a2 >= 0 : a2 > 0;
              const bool cb2 = RIGHT ? b2 >= 0 : b2 > 0;
              d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
                   (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
            }
            X[k] = wsub(max(a, 0), qeS);
            Y[k] = wsub(max(bb, 0), qeS);
            X2[k] = wsub(max(a2, 0), qe2S);
            Y2[k] = wsub(max(b2, 0), qe2S);
          }
          U[k] = un;
          V[k] = vn;
          if (CIG) dw[k >> 2] |= (unsigned)d << (8 * (k & 3));
          if (!APPROX) {
            // the H row over [st0, en0] (spec/common.py:exact_max_scan):
            // unsigned deltas less q + e one-piece, signed two-piece; the
            // en0 cell reads the older H(en0 - 1); diagonal 0 reads the
            // seed at t = 0
            const int vv = SGN ? vn >> 24 : (int)((unsigned)vn >> 24);
            const int uu = SGN ? un >> 24 : (int)((unsigned)un >> 24);
            const int h = k == ke ? Hp + uu - sub : H[k] + vv - sub;
            if (hmask >> k & 1) {
              H[k] = h;
              bh = max(bh, h);
            }
          }
        }
      }
      BATCH_STAMP(1);
      if (!APPROX) {
        // the diagonal's best cell: the largest H, then the SSE tie order.
        // A lane takes its best rank among its cells that hold the
        // largest H from bit masks: the en0 cell first, then by lane
        // class (rel & 3, which is (k - st0) & 3 for every lane: p0 is a
        // multiple of 4) and position over [st0, en1), then the tail
        const int hm = __reduce_max_sync(FULL, bh);
        auto best_t = [&]() {
          unsigned em = 0;
#pragma unroll
          for (int k = 0; k < CPL; ++k) em |= (H[k] == hm ? 1u : 0u) << k;
          em &= hmask;
          int rk = INT_MAX;
          {
            // cells k, k + 4, ..: one lane class
            constexpr unsigned PAT = CPL == 8 ? 0x11u : 0x1111u;
            const int d0 = p0 - st0;                 // rel of cell 0
            const int en1 = st0 + ((en0 - st0) & ~3);
            const unsigned R = cell_mask<CPL>(-d0, en1 - 1 - p0);
            const unsigned cm = em & R;
            unsigned cb = 0;
            int cls = 0;
#pragma unroll
            for (int c = 3; c >= 0; --c) {
              const unsigned mc = cm & (PAT << ((c + st0) & 3));
              if (mc) {
                cb = mc;
                cls = c;
              }
            }
            const int ke0 = en0 - p0;
            const unsigned eb = (unsigned)ke0 < CPL ? 1u << ke0 : 0u;
            const unsigned tm = em & ~R & ~eb;
            if (cb)
              rk = cls * KT + d0 + __ffs(cb);        // rel + 1
            else if (tm)
              rk = 4 * KT + d0 + __ffs(tm);
            if (em & eb) rk = 0;
          }
          return rank_pos(__reduce_min_sync(FULL, rk), st0, en0);
        };
        int tw;
        if constexpr (SPL) {
          // the replay reads a diagonal's position only where its maximum
          // beats the running one or falls more than zdrop below it (no
          // gap slope): the warp skips the rank elsewhere
          if (hm > run || (A.zdrop >= 0 && run - hm > A.zdrop))
            tw = best_t();
          else
            tw = 0;
          run = max(run, hm);
        } else {
          tw = best_t();
        }
        if (lane == rr) {
          gH = hm;
          gT = tw;
        }
        // H(st0) where mqe may change, H(en0) where mte or the score may
        if (r - st0 == qlen - 1) {
          const int hs = pick<CPL>(H, (st0 - base) % CPL, (st0 - base) / CPL);
          if (lane == rr) gS = hs;
        }
        if (en0 == tlen - 1) {
          const int he = pick<CPL>(H, (en0 - base) % CPL, (en0 - base) / CPL);
          if (lane == rr) gE = he;
        }
      } else {
        // the H0 walk (ksw2_extz2_sse.c:262-279) on unsigned deltas less
        // q + e one-piece, on signed deltas two-piece
        if (r == 0) {                    // base 0: position 0 is lane 0's
          const int v0 = __shfl_sync(FULL, V[0], 0);
          H0 = SGN ? (v0 >> 24) - A.qe_pre
                   : (int)((unsigned)v0 >> 24) - 2 * qe;
          lt0 = 0;
        } else {
          const bool c1 = st0 <= lt0 && lt0 <= en0;
          const bool c2 = st0 <= lt0 + 1 && lt0 + 1 <= en0;
          int d0 = c1 ? pick<CPL>(V, (lt0 - base) % CPL, (lt0 - base) / CPL)
                      : 0;
          int d1 = c2 ? pick<CPL>(U, (lt0 + 1 - base) % CPL,
                                  (lt0 + 1 - base) / CPL)
                      : 0;
          if (SGN) {
            d0 >>= 24;
            d1 >>= 24;
          } else {
            d0 = (int)((unsigned)d0 >> 24) - qe;
            d1 = (int)((unsigned)d1 >> 24) - qe;
          }
          if (c1 && c2) {
            if (d0 > d1) {
              H0 += d0;
            } else {
              H0 += d1;
              ++lt0;
            }
          } else if (c1) {
            H0 += d0;
          } else {
            H0 += d1;
            ++lt0;
          }
        }
        if (lane == rr) {
          gH = H0;
          gT = lt0;
        }
      }
      BATCH_STAMP(2);
      if (CIG && inb) {
        // CPL-byte aligned: p0 - st is a multiple of CPL, rows of
        // n_col % 16 == 0 bytes
        uint8_t* dst = prow + (size_t)r * A.ncol + (p0 - st);
        if constexpr (CPL == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(dw[0], dw[1]);
        else
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(dw[0], dw[1], dw[2], dw[3]);
      }
      last_st = st;
      last_en = en;
      BATCH_STAMP(3);
    }

    // the group's replay: lane j holds diagonal rj = r_lo + j.
    // ksw_apply_zdrop (ksw2.h:191-207) with the form's gap slope, in
    // order: the running maximum before rj is the carried one combined
    // with an exclusive scan of the group's (first strictly greater wins)
    const int rj = r_lo + lane;
    const bool valid = lane < n;
    const BandRow bj = band_row(rj, qlen, tlen, w);
    const bool contrib =
        valid && (!APPROX || (A.adrop && (SGN || rj > 0)));
    const int v = contrib ? gH : INT_MIN;
    int iv = v, it = gT, ir = rj;          // inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ov = __shfl_up_sync(FULL, iv, o);
      const int ot = __shfl_up_sync(FULL, it, o);
      const int orr = __shfl_up_sync(FULL, ir, o);
      if (lane >= o && !(iv > ov)) {
        iv = ov;
        it = ot;
        ir = orr;
      }
    }
    int pv = __shfl_up_sync(FULL, iv, 1), pt = __shfl_up_sync(FULL, it, 1),
        pr = __shfl_up_sync(FULL, ir, 1);
    if (lane == 0 || !(pv > mx)) {
      pv = mx;
      pt = mt;
      pr = mt + mq;
    }
    bool drop = false;
    if (contrib && A.zdrop >= 0 && !(v > pv) && gT >= pt &&
        rj - gT >= pr - pt) {
      const int tl_ = gT - pt, ql_ = (rj - gT) - (pr - pt);
      const int l = tl_ > ql_ ? tl_ - ql_ : ql_ - tl_;
      drop = pv - v > A.zdrop + l * ez;
    }
    const unsigned DM = __ballot_sync(FULL, drop);
    const int jd = DM ? __ffs(DM) - 1 : KD;
    {
      const int jl = min(jd, n - 1);
      const int lv = __shfl_sync(FULL, iv, jl), lt_ = __shfl_sync(FULL, it, jl),
                lr = __shfl_sync(FULL, ir, jl);
      if (lv > mx) {
        mx = lv;
        mt = lt_;
        mq = lr - lt_;
      }
    }
    if (!APPROX) {
      // mte (mte_q keeps the reference's r - en rounding) and mqe, strict
      // > in order, the drop diagonal included
      const bool em = valid && lane <= jd && bj.en0 == tlen - 1;
      const int te = __reduce_max_sync(FULL, em ? gE : INT_MIN);
      if (te > mte) {
        const int L = __ffs(__ballot_sync(FULL, em && gE == te)) - 1;
        mte = te;
        mteq = __shfl_sync(FULL, rj - bj.en, L);
      }
      const bool qm = valid && lane <= jd && rj - bj.st0 == qlen - 1;
      const int ts = __reduce_max_sync(FULL, qm ? gS : INT_MIN);
      if (ts > mqe) {
        const int L = __ffs(__ballot_sync(FULL, qm && gS == ts)) - 1;
        mqe = ts;
        mqet = __shfl_sync(FULL, bj.st0, L);
      }
    }
    // the score: the last diagonal reaching the target's end, not dropped
    const unsigned SM = __ballot_sync(
        FULL, valid && lane < jd && rj == ndb - 1 && bj.en0 == tlen - 1);
    if (SM) score = __shfl_sync(FULL, APPROX ? gH : gE, __ffs(SM) - 1);
    done_diags += min(jd + 1, n);
    BATCH_STAMP(4);
    if (jd < n) {
      zd = 1;
      if (CIG) {
        // the rows computed past the stop are 0, as the reference leaves
        // them
        const int rows = n - 1 - jd;
        uint4* z = reinterpret_cast<uint4*>(
            prow + (size_t)(r_lo + jd + 1) * A.ncol);
        const int n16 = rows * (A.ncol / 16);
        for (int i = lane; i < n16; i += 32) z[i] = make_uint4(0, 0, 0, 0);
      }
      break;
    }
  }
  BATCH_STAMP_FLUSH(done_diags);
  if (rlim < ndb) zd = 1;
  if (lane == 0) {
    int* out = A.rec + (size_t)b * 9;
    out[0] = mx;
    out[1] = mt;
    out[2] = mq;
    out[3] = mqe;
    out[4] = mqet;
    out[5] = mte;
    out[6] = mteq;
    out[7] = score;
    out[8] = zd;
  }
}

template <int CPL, bool TWO, bool SPL, bool CIG, bool APPROX, bool RIGHT>
cudaError_t launch_reg(const BatchArgs& a, int warps, cudaStream_t stream) {
  const int blocks = (a.B + warps - 1) / warps;
  batch_reg_kernel<CPL, TWO, SPL, CIG, APPROX, RIGHT>
      <<<blocks, warps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// RIGHT changes only the direction bytes: the score forms take one
template <int CPL, bool TWO, bool SPL, bool APPROX>
cudaError_t launch_reg_forms(const BatchArgs& a, int cig, int warps,
                             cudaStream_t stream) {
  if (!cig)
    return launch_reg<CPL, TWO, SPL, false, APPROX, false>(a, warps, stream);
  return a.right
             ? launch_reg<CPL, TWO, SPL, true, APPROX, true>(a, warps, stream)
             : launch_reg<CPL, TWO, SPL, true, APPROX, false>(a, warps,
                                                               stream);
}

template <int CPL, bool TWO, bool SPL>
cudaError_t launch_two(const BatchArgs& a, int cig, int approx, int warps,
                       cudaStream_t stream) {
  return approx ? launch_reg_forms<CPL, TWO, SPL, true>(a, cig, warps, stream)
                : launch_reg_forms<CPL, TWO, SPL, false>(a, cig, warps,
                                                         stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success): the
// register form, `warps` pairs a block, on a launch that
// ops/batch.py:batch_form gives it (ncol + 48 <= 32 CPL, m <= 8).
extern "C" int ksw2t_batch_fwd(
    const void* qs, const void* ts, const void* qlen, const void* tlen,
    const void* w, const void* table, int B, int Lq, int Lt, int m, int q,
    int e, int q2, int e2, int qe_pre, int lt, int ld, int sc_mch,
    int sc_mis, int sc_N, int zdrop, int right, int generic, int approx,
    int adrop, int cig, int two, int nd, int ncol, int warps, void* rec,
    void* p, void* stream) {
  if (B <= 0 || warps <= 0 || warps > MAX_WARPS || ncol % 16 || Lt % 16 ||
      (cig && p == nullptr) || m > 8 || ncol + 48 > 32 * CPL_E)
    return (int)cudaErrorInvalidValue;
  BatchArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
              (const int*)tlen, (const int*)w, (const int*)table, B, Lq, Lt,
              m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N, zdrop,
              right, generic, adrop, nd, ncol, (int*)rec, (uint8_t*)p,
              nullptr, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(two ? launch_two<CPL_E, true, false>(a, cig, approx, warps, st)
                   : launch_two<CPL_E, false, false>(a, cig, approx, warps,
                                                     st));
}

// Kernel 6's register form (counted as batch_exts_fwd): the same kernel
// with SPL, CPL_S positions a lane, on a launch that
// ops/batch_exts.py:exts_form gives it (ncol + 48 <= 32 CPL_S, m <= 8).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_batch_exts_reg_fwd(
    const void* qs, const void* ts, const void* qlen, const void* tlen,
    const void* w, const void* table, const void* don, const void* acc,
    int B, int Lq, int Lt, int m, int q, int e, int q2, int lt, int ld,
    int sc_mch, int sc_mis, int sc_N, int zdrop, int right, int generic,
    int approx, int adrop, int cig, int nd, int ncol, int warps, void* rec,
    void* p, void* stream) {
  if (B <= 0 || warps <= 0 || warps > MAX_WARPS || ncol % 16 || Lt % 16 ||
      (cig && p == nullptr) || m > 8 || ncol + 48 > 32 * CPL_S)
    return (int)cudaErrorInvalidValue;
  BatchArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
              (const int*)tlen, (const int*)w, (const int*)table, B, Lq, Lt,
              m, q, e, q2, 0, q + e, lt, ld, sc_mch, sc_mis, sc_N, zdrop,
              right, generic, adrop, nd, ncol, (int*)rec, (uint8_t*)p,
              (const uint8_t*)don, (const uint8_t*)acc};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_two<CPL_S, false, true>(a, cig, approx, warps, st);
}
