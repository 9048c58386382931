// Band forward (kernels 9 and 10): the anti-diagonal difference DP over a
// rotated band (extz and extd, exact or approximate max, score and
// direction bytes).
//
// Replaces ksw2_tpu/ops/wavefront_band.py:_band_kernel_body (one-piece,
// counted as band_fwd) and ksw2_tpu/ops/wavefront_band_extd.py:
// _band_extd_kernel_body (two-piece, TWO, counted as band_extd_fwd).  It
// computes what spec/diagdiff.py:extz2 and extd2 specify with a band w:
// per anti-diagonal r = i + j the Suzuki-Kasahara deltas u, v, x, y (and
// x2, y2) in wrapping int8 over the 16-rounded band [st, en]
// (ksw2_extz2_sse.c:107-205, ksw2_extd2_sse.c), the int32 H row with the
// SSE 4-lane argmax tie order and ksw_apply_zdrop, or the O(1) H0 walk
// (APPROX), the mqe / mte captures and the score, written as the 9-field
// record of ops/records.py; with CIG the reference's direction byte of
// every cell of [st, en] into its rotated store p[b][r][t - st(r)] with
// n_col bytes a diagonal.  The plain version is ops/band.py:
// band_forward_plain.  The batched forward's wide form (kernels E / E2 on
// bands wider than their register window, or m > 8) launches this kernel
// too, through ops/batch.py (counted as batch_fwd / batch_extd_fwd), and so
// does kernel 6's wide form (SPL, below).
//
// Kernel 6's wide form (MODE SPL, counted as batch_exts_fwd) replaces
// ksw2_tpu/ops/wavefront_batch_exts.py:_batch_exts_kernel on the splice
// launches whose n_col kernel 6's register form (batch_fwd.cu, SPL) cannot
// hold (n_col > 464: pairs whose shorter side passes ~448 bp) and on
// alphabets of more than 8 symbols (ops/batch_exts.py:exts_form): the exts
// recurrence of spec/diagdiff.py:exts2 (ksw2_exts2_sse.c) with w = qlen +
// tlen (exts has no band).  It is TWO's form with the intron plane x2 on
// the deletion side only (initialised to -q2 and handed on at a tile edge
// as TWO's is) and no y2: a position's donor and acceptor bytes sit in
// one register a chunk beside its score table; the intron candidate a2 +
// acceptor joins a and b with no clamp of z; x2' = max(a2', donor) - q2,
// its continuation bit 0x20 where a2' > donor.  The first-column switch
// and H's seed are TWO's with e2 = 0 and qe_pre = q + e, and Z-drop has
// no gap slope (e2 = 0), APPROX_DROP from r = 0.  Its launches take tiles
// of 64 (ops/batch_exts.py:exts_wide_layout).
//
// Layout: one block a pair, NW compute warps and one replay warp.  The pair's
// target axis is cut into tiles of TP = 32 NC positions (NC = 1 or 2 for the
// band route; 2 or 4, scores only, for the batched wide form;
// ops/band.py:band_layout picks TP and NW from the launch's n_col). Tile k
// belongs to warp k % NW, which walks the diagonals on which the tile meets the
// band, then takes tile k + NW: NW is chosen so that a tile's first diagonal
// comes after the last of the tile NW before it, so the warps run the band's
// tiles in turn and no warp holds two tiles at once.  As in kernel 12
// (extz_fwd.cu), lane l keeps the positions t0 + 32 c + l of its tile in
// registers, so the reference's stale bytes persist as they do in its SSE rows:
// the edge byte at st - 1, the score bytes in [st, st0) and past the 16-byte
// fill, H at st0 - 1 and the older H(en0 - 1) that the en0 cell reads.  The
// int8 planes u, v, x, y (x2, y2) sit in the top byte of an int32 (v << 24):
// int32 adds wrap as the reference's epi8 adds do and compare as its signed and
// unsigned byte compares do, so no cell spends instructions on sign
// extension.  A lane's score against each query symbol is a table of bytes in
// two registers, and one prmt picks a cell's score (m <= 8; for a larger
// alphabet, SCMAT, the m x m matrix in shared memory, one shared load a
// cell).  Neighbour t - 1 is one shuffle a plane.  A tile that lies inside
// [st0, en0] past the first column (most tile-diagonals of a long band) takes a
// form of the step with no band-edge selects.  Diagonals go in groups of KD =
// 32, aligned on multiples of KD for every tile; per group a lane a diagonal
// prepares the diagonal's band row and the tile before's edge state, and the
// warp stages the query window its cells read (TP + KD bases).  The tile before
// hands on its last position's (x, v, x2, H) through a ring of ERING entries in
// shared memory: one release a group by the writer, one acquire a group by the
// reader, which then marks how far it has read, so the writer never overwrites
// an entry still to be read.  No block-wide barrier runs inside the loop.
//
// The diagonal's maximum: each warp takes its tile's largest H with one
// __reduce_max_sync and the lanes that hold it with a ballot; only a tie
// ranks them (the SSE scan's 4-lane order).  At the group's end lane j
// ranks diagonal r_lo + j's winner and folds its 64-bit (H, rank) key
// into the pair's per-diagonal ring in shared memory with one atomicMax;
// the lanes that hold st0 and en0 store their H beside it.  The replay
// warp waits until every compute warp has passed a group, then replays
// Z-drop, mqe / mte, the score and the stop in order over it
// (ops/strips.py:replay_records and kernel 12's replay are the models)
// and frees the ring's entries.  Under APPROX the H0 walk runs in the
// compute warps (the tile that holds the walk's next cell takes the step
// and stores (H0, t) in the ring) and the replay applies APPROX_DROP to
// it.  A drop sets the pair's stop, which the compute warps read at each
// group's start; they run at most the ring's length past it, every field
// comes from the replay's exact stopping diagonal, and the store's rows
// they wrote past the stop are zeroed before the kernel ends.
//
// What bounds it on an H100: the SM's integer pipe (16 lanes a
// scheduler: one warp instruction every 2 cycles) over a pair's tile
// steps, ~w / 32 a diagonal for tens of thousands of diagonals, all on
// the pair's SM (~34 integer operations a cell that the recurrence needs,
// ~44 two-piece; chip_smoke.py: OPS); with CIG the n_col bytes a diagonal
// of store.  The parent design (state in shared byte planes, a barrier
// and a block argmax every diagonal) spent ~4,000 cycles a warp-diagonal
// on one latency-bound chain (chip_smoke.py --breakdown band).  Here a
// tile step is ~140 instructions in the general form, fewer inside the
// band; the hand-off, fold and replay leave the chain every KD diagonals.
// A launch waits on its longest pair, on one SM: spreading a long pair
// over SMs and byte SIMD are later work.
#include <climits>
#include <type_traits>

#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;    // NEG_INF of core/flags.py
constexpr int KT = 4096;            // tie-rank class stride (ops/band.py)
constexpr unsigned FULL = 0xffffffffu;
constexpr int KD = 32;              // diagonals a group (a lane each)
constexpr int ERING = 4 * KD;       // entries of a tile edge's ring
// compute warps a block: the bound the compiler sizes registers for (at
// 27 warps or 26, 72 a thread); ops/band.py:NW_MAX and batch.WIDE_NW_MAX
constexpr int MAX_NW = 26;
constexpr int MAX_THREADS = 32 * (MAX_NW + 1);
// a wait may last SPIN_BASE + SPIN_DIAG cycles for each of the pair's
// diagonals (~10 s + ~100 us a diagonal of SM clock) before it counts as
// a fault and traps; between reads it sleeps up to SPIN_SLEEP_MAX ns
constexpr long long SPIN_BASE = 20000000000LL;
constexpr long long SPIN_DIAG = 200000LL;
constexpr unsigned SPIN_SLEEP_MAX = 256;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// An int8 value in the top byte of an int32 (v << 24): the planes' form.
// Sums and differences in that form wrap as the reference's epi8 ones do:
// they are taken in unsigned arithmetic, where wrapping is defined.
__device__ __forceinline__ int top(int v) { return (int)((unsigned)v << 24); }
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// The byte of (hi:lo) that sel's low nibble picks, sign-extended (prmt's
// sign mode: sel = Q * 0x1111 + 0x8880 picks byte Q).
__device__ __forceinline__ int prmt(int lo, int hi, int sel) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

// The SSE scan's tie rank of cell t on a diagonal with band [st0, en0]:
// the en0 cell, then 4 lane classes over [st0, en1), then the scalar
// tail; smaller ranks win.  rank_pos inverts it.
__device__ __forceinline__ int sse_rank(int t, int st0, int en0) {
  const int rel = t - st0;
  const int en1 = st0 + ((en0 - st0) & ~3);
  return t == en0 ? 0 : t < en1 ? (rel & 3) * KT + rel + 1 : 4 * KT + rel + 1;
}

__device__ __forceinline__ int rank_pos(int rank, int st0, int en0) {
  return rank == 0 ? en0
         : rank <= 4 * KT ? st0 + (rank - 1) % KT
                          : st0 + rank - 1 - 4 * KT;
}

__device__ __forceinline__ long long pack_walk(int H0, int t) {
  return (long long)(((unsigned long long)(unsigned)H0 << 32) |
                     (unsigned long long)(unsigned)t);
}

// How a lane scores its cells (the kernel's SC): SC8, a table of its score
// against each of m <= 8 query symbols, a byte each in two registers, one
// prmt a cell (the query window holds prmt selectors); SCMAT, any m, the
// m x m matrix of bytes in shared memory, one load a cell (the window holds
// the symbols).
constexpr int SC8 = 8, SCMAT = 0;

// The recurrence (the kernel's MODE): ONE, extz; TWO, extd; SPL, exts.
constexpr int ONE = 0, TWO_PIECE = 1, SPL_MODE = 2;

struct BandArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const int* table;
  int Lq, Lt, m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N, zdrop;
  int generic, adrop, nd, ncol, NW, RING;
  int* rec;
  uint8_t* p;
  const signed char* don;          // SPL: the donor and acceptor rows
  const signed char* acc;
};

// One compute warp's shared memory: its group's band rows and boundary
// state, the tile before's staged entries, its own edge ring, the
// group's keys, the query window and two rows of direction bytes.
template <int TP>
struct WarpSmem {
  int4 sdiag[KD];                  // st0, en0, hi_s - st0, colv | prevok
  int4 sbnd[KD];                   // position t0 - 1 before the diagonal
  __align__(16) uint8_t stage[2][TP];
  int2 skey[KD];                   // the warp's best H and its position
  int2 sprev[KD + 1];              // the tile before's entries, staged
  int2 sedge[KD];                  // this tile's last position, a diagonal
  int2 ering[ERING];               // ... published to the tile after
  int2 plast;                      // the tile before's last entry
  int sbvn[KD];                    // APPROX: v of t0 - 1 after the diagonal
  unsigned short qsel[TP + KD];    // the query window's score selectors
};

// The block's shared memory after the per-diagonal rings: per warp the
// diagonal its edge entries are published to (pub), the lowest entry of
// the tile before it may still read (low), the diagonal up to which it
// adds no more keys (settled) and the last diagonal it computed (hiw);
// then the replay's progress and the pair's stop, and the score table;
// with SCMAT the m x m score matrix after the warps'.
constexpr int CTL_INTS = 4 * 32 + 4 + 64;

template <int TP, int SC>
constexpr size_t band_smem_bytes(int NW, int RING, int m) {
  return (size_t)RING * (8 + 8) + 4 * CTL_INTS +
         (size_t)NW * sizeof(WarpSmem<TP>) +
         (SC == SCMAT ? (size_t)(m * m + 15) / 16 * 16 : 0);
}

// The first diagonal a tile starting at t0 can touch (the score fill runs
// up to 15 positions past en0) and the last one whose band starts in it
// (extz_fwd.cu's tile_first / tile_last).
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

template <int NC>
__device__ __forceinline__ int tile_pick(const int (&a)[NC], int li) {
  int v = a[0];
#pragma unroll
  for (int c = 1; c < NC; ++c)
    if (c == li >> 5) v = a[c];
  return __shfl_sync(FULL, v, li & 31);
}

// Lane 0 spins (acquire) until *p >= need; false, with no wait, once the
// pair's stop is at or before r (the caller then stops too).  A wait
// past the spin limit is a fault: trap, do not hang.
__device__ __forceinline__ bool wait_until(const int* p, int need,
                                           const int* stopp, int r,
                                           long long limit, int lane) {
  int ok = 1;
  if (lane == 0) {
    const long long t_start = clock64();
    unsigned nap = 16;
    while (ld_acquire(p) < need) {
      if (ld_acquire(stopp) <= r) {
        ok = 0;
        break;
      }
      if (clock64() - t_start > limit) __trap();
      __nanosleep(nap);
      nap = min(2 * nap, SPIN_SLEEP_MAX);
    }
  }
  __syncwarp();
  return __shfl_sync(FULL, ok, 0);
}

template <int MODE, bool CIG, bool APPROX, int NC, bool RIGHT, int SC>
__global__ void __launch_bounds__(MAX_THREADS)
band_fwd_kernel(const BandArgs A) {
  constexpr bool TWO = MODE == TWO_PIECE, SPL = MODE == SPL_MODE;
  constexpr bool SGN = TWO || SPL;   // signed deltas, the H row unbiased
  constexpr int TP = 32 * NC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int RING = A.RING, RMASK = RING - 1, NW = A.NW;
  long long* Dr = reinterpret_cast<long long*>(smem);   // keys, or walk
  int2* Hs = reinterpret_cast<int2*>(Dr + RING);        // H at st0, en0
  int* pub = reinterpret_cast<int*>(Hs + RING);
  int* low = pub + 32;
  int* settled = low + 32;
  int* hiw = settled + 32;
  int* replayed = hiw + 32;
  int* stopp = replayed + 1;
  int* stab = replayed + 4;
  WarpSmem<TP>* wsm = reinterpret_cast<WarpSmem<TP>*>(stab + 64);
  signed char* smat = reinterpret_cast<signed char*>(wsm + NW);   // SCMAT

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int rlim = first_empty_diag(qlen, tlen, w);
  const long long spin_limit = SPIN_BASE + SPIN_DIAG * rlim;
  // NW was chosen for bands of at most n_col - 16 cells (ops/band.py:
  // band_layout): a wider one would give a warp two tiles at once
  if (min(min(w + 1, qlen), tlen) + 16 > A.ncol) __trap();
  for (int i = threadIdx.x; i < RING; i += blockDim.x)
    Dr[i] = APPROX ? -1LL : LLONG_MIN;
  if (threadIdx.x < 32) {
    pub[threadIdx.x] = -1;
    low[threadIdx.x] = -1;
    settled[threadIdx.x] = -1;
    hiw[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) {
    *replayed = -1;
    *stopp = INT_MAX;
  }
  if (SC == SC8 && A.generic)
    for (int i = threadIdx.x; i < A.m * A.m; i += blockDim.x)
      stab[i] = A.table[i];
  if (SC == SCMAT)
    for (int i = threadIdx.x; i < A.m * A.m; i += blockDim.x) {
      const int T = i / A.m, Q = i % A.m;
      const int sv = T == Q ? A.sc_mch : A.sc_mis;
      smat[i] = (signed char)(A.generic                       ? A.table[i]
                              : T == A.m - 1 || Q == A.m - 1 ? A.sc_N
                                                              : sv);
    }
  __syncthreads();

  if (warp < NW) {
    // ------------------------------------------------------------------
    // a compute warp: tiles warp, warp + NW, ...
    const int q = A.q, e = A.e, qe = q + e, qe2 = A.q2 + A.e2;
    // the reference's init bytes: 0 one-piece; -(q + e) for u, v, x, y
    // and -(q2 + e2) for x2, y2 two-piece
    const int init = SGN ? -qe : 0, init2 = -qe2;
    // the same in the planes' top-byte form
    const int initS = top(init), init2S = top(init2), qS = top(q),
              q2S = top(A.q2), qeS = top(qe), qe2S = top(qe2),
              mchS = top(A.sc_mch), twoqeS = top(2 * qe);
    const unsigned capS = (unsigned)top(A.sc_mch + 2 * qe);
    const int ntiles = (tlen + 15 + TP - 1) / TP;
    const size_t bL = (size_t)b * A.Lt;
    const uint8_t* tg = A.ts + bL;
    const uint8_t* qy = A.qs + (size_t)b * A.Lq;
    WarpSmem<TP>& S = wsm[warp];
    const int pw = (warp + NW - 1) % NW, cw = (warp + 1) % NW;
    const WarpSmem<TP>& Pv = wsm[pw];
    uint8_t* pp = CIG ? A.p + (size_t)b * A.nd * A.ncol : nullptr;
    int H0 = 0, lt = 0, known = -2;        // the H0 walk after `known`
    int mylow = -1, mysettled = -1, myhi = -1;
    bool quit = false;

    for (int k = warp; k < ntiles && !quit; k += NW) {
      const int t0 = k * TP, X = t0 + TP - 1;
      const int rA = tile_first(t0, w), rB = tile_last(t0, TP, qlen, w, rlim);
      if (rA > rB) continue;
      // this tile reads no entry of the tile before below rA - 1, and no
      // key of this warp's comes below rA (nor, APPROX, a walk step:
      // the walk reaches a tile's positions after its first diagonal)
      // (tile 0 reads no tile before: this warp's next tile reads from
      // its own first diagonal on)
      mylow = max(mylow, k > 0 ? rA - 1
                               : k + NW < ntiles ? tile_first(t0 + NW * TP, w) - 1
                                                 : INT_MAX);
      mysettled = max(mysettled, rA - 1);
      if (lane == 0) {
        st_release(low + warp, mylow);
        st_release(settled + warp, mysettled);
      }
      const bool feeds = k + 1 < ntiles;

      // lane l's state: position t0 + 32 c + l in chunk c's registers.
      // The int8 planes are kept in the top byte (v << 24), so int32 adds
      // wrap as the reference's epi8 adds do and compare as they do, with
      // no sign extension; the score byte Sc as a plain int.  SL / SH:
      // the lane's score against each query symbol, a byte each (SCMAT:
      // SL its target symbol's row of the matrix).
      int U[NC], V[NC], Xp[NC], Y[NC], X2[NC], Y2[NC], H[NC], Sc[NC],
          SL[NC], SH[NC];
      // SPL: the position's donor byte in the top byte, its acceptor byte
      // below it
      int DA[SPL ? NC : 1];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int t = t0 + 32 * c + lane;
        const int T = t < tlen ? tg[t] : 0;
        U[c] = V[c] = Xp[c] = Y[c] = initS;
        X2[c] = Y2[c] = init2S;
        H[c] = NEG;
        Sc[c] = 0;
        if (SPL)
          DA[c] = t < A.Lt ? (int)((unsigned)(uint8_t)A.don[bL + t] << 24 |
                                   (unsigned)(uint8_t)A.acc[bL + t] << 16)
                           : 0;
        if (SC == SCMAT) {
          SL[c] = T * A.m;
          SH[c] = 0;
          continue;
        }
        unsigned lo = 0, hi = 0;
        for (int Qs = 0; Qs < 8; ++Qs) {
          int sv;
          if (A.generic) {
            sv = Qs < A.m ? stab[T * A.m + Qs] : 0;
          } else {
            sv = T == Qs ? A.sc_mch : A.sc_mis;
            sv = T == A.m - 1 || Qs == A.m - 1 ? A.sc_N : sv;
          }
          const unsigned byte = (unsigned)(sv & 255);
          if (Qs < 4)
            lo |= byte << (8 * Qs);
          else
            hi |= byte << (8 * (Qs - 4));
        }
        SL[c] = (int)lo;
        SH[c] = (int)hi;
      }
      // the tile before and the diagonals it computes
      int pA = 0, pB = -1;
      if (k > 0) {
        pA = tile_first(t0 - TP, w);
        pB = tile_last(t0 - TP, TP, qlen, w, rlim);
      }
      int seen = -1;                       // entries of it known published
      int buf = 0;

      for (int r_lo = rA; r_lo <= rB;) {
        const int r_hi = min(r_lo - r_lo % KD + KD - 1, rB);
        const int nr = r_hi - r_lo + 1;
        // the pair stops: the replay has passed its Z-drop
        int sp = 0;
        if (lane == 0) sp = ld_acquire(stopp);
        if (__shfl_sync(FULL, sp, 0) <= r_lo) {
          quit = true;
          break;
        }
        // the per-diagonal ring's entries of this group are free
        if (!wait_until(replayed, r_hi - RING, stopp, r_lo, spin_limit,
                        lane)) {
          quit = true;
          break;
        }
        // the tile before's entries [cb, ce]: e0 = min(r - 1, pB) and,
        // APPROX, e1 = min(r, pB) for r in the group
        int cb = 0;
        if (k > 0) {
          const int need = min(APPROX ? r_hi : r_hi - 1, pB);
          if (need >= pA && need > seen) {
            if (!wait_until(pub + pw, need, stopp, r_lo, spin_limit, lane)) {
              quit = true;
              break;
            }
            seen = need;
          }
          cb = max(min(r_lo - 1, pB), pA);
          const int ce = min(min(APPROX ? r_hi : r_hi - 1, pB), seen);
          if (r_lo - 1 > pB) {
            // past the tile before's last diagonal: its last entry, kept
            if (lane == 0) S.sprev[0] = S.plast;
          } else {
            for (int j = lane; j <= ce - cb; j += 32) {
              const int2 ent = Pv.ering[(cb + j) & (ERING - 1)];
              S.sprev[j] = ent;
              if (cb + j == pB) S.plast = ent;
            }
          }
          __syncwarp();
          // the next group reads the tile before from r_hi on
          mylow = max(mylow, r_hi);
          if (lane == 0) st_release(low + warp, mylow);
        }
        // the query bases the group's cells read (r - t for r in the
        // group) as the prmt selector of their score byte, sign-extended
        // (SCMAT: the symbol)
        const int qb = r_lo - X;
        for (int i = lane; i < TP + KD - 1; i += 32) {
          const int qi = qb + i;
          const int Q = qi >= 0 && qi < qlen ? qy[qi] : 0;
          S.qsel[i] =
              (unsigned short)(SC == SCMAT ? Q : Q * 0x1111 + 0x8880);
        }
        // what each diagonal of the group needs besides its cells, a lane
        // a diagonal, off the chain of chunk steps
        if (lane < nr) {
          const int r = r_lo + lane;
          const BandRow bd = band_row(r, qlen, tlen, w);
          bool prevok = false;
          if (r > 0 && bd.st > 0) {
            const BandRow bp = band_row(r - 1, qlen, tlen, w);
            prevok = bp.st <= bd.st - 1 && bd.st - 1 <= bp.en;
          }
          // the first column (the j == 0 cell at t == r): q one-piece;
          // the two-piece switch at long_thres (ksw2_extd2_sse.c:156-163)
          const int colv = !SGN ? (r ? q : 0)
                                : r == 0 ? -qe
                                         : r < A.lt ? -e
                                                    : r == A.lt ? A.ld : -A.e2;
          const int hi_s = A.generic ? bd.en0
                                     : bd.st0 + ((bd.en0 - bd.st0) & ~15) + 15;
          S.sdiag[lane] = make_int4(bd.st0, bd.en0, hi_s - bd.st0,
                                    top(colv) | (prevok ? 1 : 0));
          // position t0 - 1 before this diagonal (and, APPROX, v after
          // it): the tile before's entry of min(r - 1, pB); the initial
          // values before its first
          int bx = initS, bv = initS, bx2 = init2S, bH = NEG, bvn = 0;
          if (k > 0 && t0 >= bd.st && t0 <= bd.en) {
            const int e0 = min(r - 1, pB);
            const int e1 = APPROX ? min(r, pB) : e0;
            if (e1 >= pA) {
              if (e0 >= pA) {
                const int2 ent = S.sprev[e0 - cb];
                bx = top(ent.x);
                bv = top(ent.x >> 8);
                bx2 = top(ent.x >> 16);
                bH = ent.y;
              }
              if (APPROX) bvn = top(S.sprev[e1 - cb].x >> 8);
            }
          }
          S.sbnd[lane] = make_int4(bx, bv, bx2, bH);
          if (APPROX) S.sbvn[lane] = bvn;
        }
        __syncwarp();

#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          const int r = r_lo + rr;
          const int4 dg = S.sdiag[rr];
          const int st0 = dg.x, en0 = dg.y, st = st0 & ~15, en = en0 | 15;
          const int hs = dg.z, colv = dg.w & (int)0xff000000;
          const bool prevok = dg.w & 1;
          const int4 bw = S.sbnd[rr];
          const int bvn = APPROX ? S.sbvn[rr] : 0;
          // this lane's best cell of the diagonal: its H and position
          int bh = INT_MIN, bt = 0;
          // the old state of t - 1 for lane 0: the boundary, then each
          // chunk's lane 31 (a rotation by one lane gives it to lane 0)
          int cX = bw.x, cV = bw.y, cX2 = bw.z, cH = bw.w;
          // a tile inside [st0, en0] and past the first column has no cell
          // at an edge of the band: most tile-diagonals take this form
          const bool interior = st0 < t0 && X < en0 && r > X;
          auto cells = [&](auto in_) {
            constexpr bool IN = decltype(in_)::value;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int l = 32 * c + lane;
              const int t = t0 + l;
              const int src = (lane + 31) & 31;
              const bool l0 = lane == 0;
              const int sX = __shfl_sync(FULL, Xp[c], src);
              const int sV = __shfl_sync(FULL, V[c], src);
              const int sX2 = SGN ? __shfl_sync(FULL, X2[c], src) : 0;
              const int sH = APPROX ? 0 : __shfl_sync(FULL, H[c], src);
              const int Xm = l0 ? cX : sX, Vm = l0 ? cV : sV;
              const int X2m = l0 ? cX2 : sX2, Hm = l0 ? cH : sH;
              cX = sX;
              cV = sV;
              cX2 = sX2;
              cH = sH;

              // the score fill over [st0, hi_s]; the other lanes keep stale
              // bytes
              const int rel = t - st0;
              const int qs = S.qsel[rr + TP - 1 - l];
              const int sv = SC == SCMAT ? smat[SL[c] + qs]
                                         : prmt(SL[c], SH[c], qs);
              const int Sv = IN || (unsigned)rel <= (unsigned)hs ? sv : Sc[c];
              Sc[c] = Sv;

              const bool inb = IN || (unsigned)(t - st) <= (unsigned)(en - st);
              const bool edge = !IN && t == st && !prevok;
              const int X1 = edge ? initS : Xm, X21 = edge ? init2S : X2m;
              const int V1 = edge ? (st == 0 ? colv : initS) : Vm;
              const int Uc = !IN && t == r ? colv : U[c];
              const int Yc = !IN && t == r ? initS : Y[c];
              int a = wadd(X1, V1), bb = wadd(Yc, Uc);
              int d, un, vn;
              if (!SGN) {
                const int zz = wadd(top(Sv), twoqeS);
                d = RIGHT ? (zz > a ? 0 : DIR_E) : (a > zz ? DIR_E : 0);
                int z = max(zz, a);
                d = RIGHT ? (z > bb ? d : DIR_F) : (bb > z ? DIR_F : d);
                z = (int)max((unsigned)z, (unsigned)bb);   // max_epu8
                z = (int)min((unsigned)z, capS);           // min_epu8
                un = wsub(z, V1);
                vn = wsub(z, Uc);
                const int z2 = wsub(z, qS);
                a = wsub(a, z2);
                bb = wsub(bb, z2);
                const bool ta = RIGHT ? a >= 0 : a > 0;
                const bool tb = RIGHT ? bb >= 0 : bb > 0;
                d |= (ta ? DIR_E_CONT : 0) | (tb ? DIR_F_CONT : 0);
                Xp[c] = inb ? max(a, 0) : Xp[c];
                Y[c] = inb ? max(bb, 0) : Y[c];
              } else if (TWO) {
                const int Y2c = !IN && t == r ? init2S : Y2[c];
                int a2 = wadd(X21, V1), b2 = wadd(Y2c, Uc);
                int z = top(Sv);
                d = 0;
                const int cand[4] = {a, bb, a2, b2};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  d = RIGHT ? (z > cand[i] ? d : i + 1)
                            : (cand[i] > z ? i + 1 : d);
                  z = max(z, cand[i]);
                }
                z = min(z, mchS);
                un = wsub(z, V1);
                vn = wsub(z, Uc);
                const int t1 = wsub(z, qS), t2 = wsub(z, q2S);
                a = wsub(a, t1);
                bb = wsub(bb, t1);
                a2 = wsub(a2, t2);
                b2 = wsub(b2, t2);
                const bool ca = RIGHT ? a >= 0 : a > 0;
                const bool cb_ = RIGHT ? bb >= 0 : bb > 0;
                const bool ca2 = RIGHT ? a2 >= 0 : a2 > 0;
                const bool cb2 = RIGHT ? b2 >= 0 : b2 > 0;
                d |= (ca ? DIR_E_CONT : 0) | (cb_ ? DIR_F_CONT : 0) |
                     (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
                Xp[c] = inb ? wsub(max(a, 0), qeS) : Xp[c];
                Y[c] = inb ? wsub(max(bb, 0), qeS) : Y[c];
                X2[c] = inb ? wsub(max(a2, 0), qe2S) : X2[c];
                Y2[c] = inb ? wsub(max(b2, 0), qe2S) : Y2[c];
              } else {
                // exts (ksw2_exts2_sse.c): the intron candidate a2 +
                // acceptor beside a and b, no clamp of z; x2' = max(a2',
                // donor) - q2
                const int dnS = DA[c] & (int)0xff000000;
                const int acS = DA[c] << 8;
                int a2 = wadd(X21, V1);
                int z = top(Sv);
                d = 0;
                const int cand[3] = {a, bb, wadd(a2, acS)};
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                  d = RIGHT ? (z > cand[i] ? d : i + 1)
                            : (cand[i] > z ? i + 1 : d);
                  z = max(z, cand[i]);
                }
                un = wsub(z, V1);
                vn = wsub(z, Uc);
                const int t1 = wsub(z, qS);
                a = wsub(a, t1);
                bb = wsub(bb, t1);
                a2 = wsub(a2, wsub(z, q2S));
                const bool ca = RIGHT ? a >= 0 : a > 0;
                const bool cb_ = RIGHT ? bb >= 0 : bb > 0;
                const bool cd = RIGHT ? a2 >= dnS : a2 > dnS;
                d |= (ca ? DIR_E_CONT : 0) | (cb_ ? DIR_F_CONT : 0) |
                     (cd ? DIR_N_CONT : 0);
                Xp[c] = inb ? wsub(max(a, 0), qeS) : Xp[c];
                Y[c] = inb ? wsub(max(bb, 0), qeS) : Y[c];
                X2[c] = inb ? wsub(max(a2, dnS), q2S) : X2[c];
              }
              U[c] = inb ? un : U[c];
              V[c] = inb ? vn : V[c];

              if (!APPROX) {
                // the H row (spec/common.py:exact_max_scan) over [st0, en0]:
                // unsigned deltas less q + e one-piece, signed two-piece;
                // seeded with 2 (q + e) one-piece, the PRE-swap q + e
                // two-piece
                const bool inh = IN || (unsigned)rel <= (unsigned)(en0 - st0);
                const int vv = SGN ? vn >> 24 : (int)((unsigned)vn >> 24);
                const int uu = SGN ? un >> 24 : (int)((unsigned)un >> 24);
                const int sub = SGN ? 0 : qe;
                const int h = !IN && r == 0 ? vv - (SGN ? A.qe_pre : 2 * qe)
                              : IN || t < en0 || en0 == 0 ? H[c] + vv - sub
                                                          : Hm + uu - sub;
                H[c] = inh ? h : H[c];
                // the lane's best: of its chunks the first, unless a later
                // one is higher or is the en0 cell (the SSE scan's tie
                // order ranks en0 first, then by position within a lane
                // class of 4, and chunks are 32 apart)
                const bool better =
                    inh && (c == 0 || h > bh || (!IN && h == bh && t == en0));
                bh = better ? h : bh;
                bt = better ? t : bt;
                if (!IN && inh && t == st0) Hs[r & RMASK].x = h;
                if (!IN && inh && t == en0) Hs[r & RMASK].y = h;
              }
              if (CIG) S.stage[buf][l] = (uint8_t)(inb ? d : 0);
            }
          };
          if (interior)
            cells(std::true_type{});
          else
            cells(std::false_type{});
          if (!APPROX) {
            // the warp's best cell: the largest H, then the SSE tie order
            // among the lanes that hold it (ballot, rank only on a tie);
            // its position, ranked at the fold
            const int hm = __reduce_max_sync(FULL, bh);
            const unsigned M = __ballot_sync(FULL, bh == hm);
            int tw = 0;
            if (hm != INT_MIN) {
              if ((M & (M - 1)) == 0) {
                tw = __shfl_sync(FULL, bt, __ffs(M) - 1);
              } else {
                const int rk = bh == hm ? sse_rank(bt, st0, en0) : INT_MAX;
                tw = rank_pos(__reduce_min_sync(FULL, rk), st0, en0);
              }
            }
            if (lane == 0) S.skey[rr] = make_int2(hm, tw);
          }

          if (CIG) {
            // 16-byte groups lie wholly inside or outside [st, en]; the two
            // stage rows alternate, so one warp barrier a diagonal suffices
            __syncwarp();
            if (lane < 2 * NC) {
              const int gs = t0 + 16 * lane;
              if (gs >= st && gs + 15 <= en)
                *reinterpret_cast<uint4*>(pp + (size_t)r * A.ncol +
                                          (gs - st)) =
                    *reinterpret_cast<const uint4*>(&S.stage[buf][16 * lane]);
            }
            buf ^= 1;
          }

          if (APPROX) {
            // the H0 walk (ksw2_extz2_sse.c:262-279) on unsigned deltas
            // less q + e one-piece, on signed deltas two-piece: the tile
            // that holds the walk's next cell takes the step
            if (r == 0) {
              const int v0 = __shfl_sync(FULL, V[0], 0);
              H0 = SGN ? (v0 >> 24) - A.qe_pre
                       : (int)((unsigned)v0 >> 24) - 2 * qe;
              lt = 0;
              known = 0;
              if (lane == 0) Dr[0] = pack_walk(H0, lt);
            } else {
              if (known != r - 1) {
                const long long wv =
                    *reinterpret_cast<volatile long long*>(
                        Dr + ((r - 1) & RMASK));
                if ((int)(unsigned)(wv & 0xffffffffLL) >= 0) {
                  H0 = (int)(wv >> 32);
                  lt = (int)(unsigned)(wv & 0xffffffffLL);
                  known = r - 1;
                }
              }
              if (known == r - 1) {
                const bool c1 = st0 <= lt && lt <= en0;
                const bool c2 = st0 <= lt + 1 && lt + 1 <= en0;
                const int P = c2 ? lt + 1 : lt;
                if (P >= t0 && P <= X) {
                  int d0 = 0, d1 = 0;
                  if (c1) d0 = lt >= t0 ? tile_pick<NC>(V, lt - t0) : bvn;
                  if (c2) d1 = tile_pick<NC>(U, lt + 1 - t0);
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
                      ++lt;
                    }
                  } else if (c1) {
                    H0 += d0;
                  } else {
                    H0 += d1;
                    ++lt;
                  }
                  known = r;
                  if (lane == 0) Dr[r & RMASK] = pack_walk(H0, lt);
                }
              }
            }
          }

          // lane 31 of the last chunk owns the tile's last position: its
          // x, v (and x2) bytes and H
          if (feeds && lane == 31)
            S.sedge[rr] = make_int2(
                SGN ? __byte_perm(__byte_perm(Xp[NC - 1], V[NC - 1], 0x0073),
                                  X2[NC - 1], 0x2710)
                    : __byte_perm(Xp[NC - 1], V[NC - 1], 0x0073),
                H[NC - 1]);
        }

        myhi = r_hi;
        // the group's hand-off: once the tile after has read what these
        // entries overwrite, the edge entries and one release
        __syncwarp();
        if (feeds) {
          if (!wait_until(low + cw, r_hi - ERING + 1, stopp, r_lo,
                          spin_limit, lane)) {
            quit = true;
            break;
          }
          if (lane < nr) S.ering[(r_lo + lane) & (ERING - 1)] = S.sedge[lane];
          __syncwarp();
          if (lane == 0) st_release(pub + warp, r_hi);
        }
        // the keys into the pair's ring, then no more below r_hi
        if (!APPROX && lane < nr) {
          const int2 kv = S.skey[lane];
          if (kv.x != INT_MIN) {
            const int4 dg = S.sdiag[lane];
            const int rank = sse_rank(kv.y, dg.x, dg.y);
            atomicMax(Dr + ((r_lo + lane) & RMASK),
                      (long long)kv.x * 4294967296LL +
                          (long long)(0x7fffffff - rank));
          }
        }
        if (APPROX && known != r_hi) {
          // the walk's step of r_hi, if another tile took it, before the
          // replay may free it (a later group of this tile may need it)
          const long long wv = *reinterpret_cast<volatile long long*>(
              Dr + (r_hi & RMASK));
          if ((int)(unsigned)(wv & 0xffffffffLL) >= 0) {
            H0 = (int)(wv >> 32);
            lt = (int)(unsigned)(wv & 0xffffffffLL);
            known = r_hi;
          }
        }
        __threadfence_block();
        __syncwarp();
        mysettled = max(mysettled, r_hi);
        if (lane == 0) st_release(settled + warp, mysettled);
        r_lo = r_hi + 1;
      }
    }
    // no more tiles: nothing to wait for from this warp
    if (lane == 0) {
      hiw[warp] = myhi;
      st_release(low + warp, INT_MAX);
      st_release(settled + warp, INT_MAX);
    }
  } else if (warp == NW) {
    // ------------------------------------------------------------------
    // the replay: ksw_apply_zdrop (ksw2.h:191-207) with the form's gap
    // slope (e one-piece, e2 two-piece), mqe / mte (mte_q keeps the
    // reference's r - en rounding), the score and the stop, in order, a
    // group of KD diagonals a round; APPROX_DROP from diagonal 1
    // one-piece, 0 two-piece
    const int ez = SGN ? A.e2 : A.e;
    const int ndb = qlen + tlen - 1;
    int mx = 0, mt = -1, mq = -1, mqe = NEG, mqet = -1, mte = NEG, mteq = -1;
    int score = NEG, zd = 0, stop = rlim;
    auto zdrop_apply = [&](int r, int Hm, int t) {
      if (Hm > mx) {
        mx = Hm;
        mt = t;
        mq = r - t;
        return false;
      }
      if (t >= mt && r - t >= mq) {
        const int tl_ = t - mt, ql_ = (r - t) - mq;
        const int l = tl_ > ql_ ? tl_ - ql_ : ql_ - tl_;
        return A.zdrop >= 0 && mx - Hm > A.zdrop + l * ez;
      }
      return false;
    };
    const long long t_start = clock64();
    bool done = false;
    for (int base = 0; base < rlim && !done; base += KD) {
      const int n = min(KD, rlim - base);
      const int hi = base + n - 1;
      // every compute warp has passed the group
      unsigned nap = 16;
      while (true) {
        const int s = lane < NW ? ld_acquire(settled + lane) : INT_MAX;
        if (__all_sync(FULL, s >= hi)) break;
        if (clock64() - t_start > spin_limit) __trap();
        __nanosleep(nap);
        nap = min(2 * nap, SPIN_SLEEP_MAX);
      }
      long long dv = 0;
      int2 hv = make_int2(0, 0);
      if (lane < n) {
        const int i = (base + lane) & RMASK;
        dv = Dr[i];
        if (!APPROX) hv = Hs[i];
        Dr[i] = APPROX ? -1LL : LLONG_MIN;
      }
      for (int j = 0; j < n; ++j) {
        const int r = base + j;
        const BandRow bd = band_row(r, qlen, tlen, w);
        const long long key = __shfl_sync(FULL, dv, j);
        bool drop = false;
        int fin;
        if (!APPROX) {
          const int hst = __shfl_sync(FULL, hv.x, j);
          const int hen = __shfl_sync(FULL, hv.y, j);
          const int maxH = (int)(key >> 32);
          const int rank = 0x7fffffff - (int)(key & 0xffffffffLL);
          const int maxt = rank_pos(rank, bd.st0, bd.en0);
          if (bd.en0 == tlen - 1 && hen > mte) {
            mte = hen;
            mteq = r - bd.en;
          }
          if (r - bd.st0 == qlen - 1 && hst > mqe) {
            mqe = hst;
            mqet = bd.st0;
          }
          drop = zdrop_apply(r, maxH, maxt);
          fin = hen;
        } else {
          const int h0 = (int)(key >> 32);
          const int t = (int)(unsigned)(key & 0xffffffffLL);
          if (A.adrop && (SGN || r > 0)) drop = zdrop_apply(r, h0, t);
          fin = h0;
        }
        if (drop) {
          zd = 1;
          stop = r + 1;
          done = true;
          break;
        }
        if (r == ndb - 1 && bd.en0 == tlen - 1) score = fin;
      }
      __syncwarp();
      if (lane == 0) st_release(done ? stopp : replayed, done ? stop : hi);
    }
    if (rlim < ndb) zd = 1;
    if (lane == 0) {
      st_release(replayed, INT_MAX);
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
  __syncthreads();
  // the store's rows past the stop are 0, as the reference leaves them
  if (CIG) {
    const int stop = *stopp;
    int top = -1;
    for (int i = 0; i < NW; ++i) top = max(top, hiw[i]);
    if (stop <= top) {
      const int per = A.ncol / 16;
      uint4* rows = reinterpret_cast<uint4*>(
          A.p + ((size_t)b * A.nd + stop) * A.ncol);
      const long long n = (long long)(top - stop + 1) * per;
      for (long long i = threadIdx.x; i < n; i += blockDim.x)
        rows[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int MODE, bool CIG, bool APPROX, int NC, bool RIGHT, int SC>
cudaError_t launch(const BandArgs& a, int B, cudaStream_t stream) {
  const size_t smem = band_smem_bytes<32 * NC, SC>(a.NW, a.RING, a.m);
  cudaError_t err = cudaFuncSetAttribute(
      band_fwd_kernel<MODE, CIG, APPROX, NC, RIGHT, SC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  band_fwd_kernel<MODE, CIG, APPROX, NC, RIGHT, SC>
      <<<B, 32 * (a.NW + 1), smem, stream>>>(a);
  return cudaGetLastError();
}

// RIGHT changes only the direction bytes: score launches take one form;
// tiles of 128 (NC 4) take score launches only
template <int MODE, int NC, int SC>
cudaError_t launch_forms(const BandArgs& a, int cig, int approx, int right,
                         int B, cudaStream_t stream) {
  if constexpr (NC < 4) {
    if (cig && right)
      return approx ? launch<MODE, true, true, NC, true, SC>(a, B, stream)
                    : launch<MODE, true, false, NC, true, SC>(a, B, stream);
    if (cig)
      return approx ? launch<MODE, true, true, NC, false, SC>(a, B, stream)
                    : launch<MODE, true, false, NC, false, SC>(a, B, stream);
  }
  return approx ? launch<MODE, false, true, NC, false, SC>(a, B, stream)
                : launch<MODE, false, false, NC, false, SC>(a, B, stream);
}

// tiles of 32 (m <= 8 only), 64 or 128
template <int MODE, int SC>
cudaError_t launch_tiles(const BandArgs& a, int cig, int approx, int right,
                         int TP, int B, cudaStream_t stream) {
  if (TP == 128)
    return launch_forms<MODE, 4, SC>(a, cig, approx, right, B, stream);
  if constexpr (SC == SC8) {
    if (TP == 32)
      return launch_forms<MODE, 1, SC>(a, cig, approx, right, B, stream);
  }
  return launch_forms<MODE, 2, SC>(a, cig, approx, right, B, stream);
}

template <int MODE>
cudaError_t launch_two(const BandArgs& a, int cig, int approx, int right,
                       int TP, int B, cudaStream_t stream) {
  return a.m <= 8
             ? launch_tiles<MODE, SC8>(a, cig, approx, right, TP, B, stream)
             : launch_tiles<MODE, SCMAT>(a, cig, approx, right, TP, B,
                                         stream);
}

// 0 when a launch's layout (TP, NW, RING) and its block's shared memory
// fit the kernel, else the error the C entries return
int check_layout(int B, int m, int TP, int NW, int RING, int cig, int ncol,
                 const void* p) {
  if (B <= 0 || (TP != 32 && TP != 64 && TP != 128) ||
      (TP == 128 && cig) || (TP == 32 && m > 8) || m < 1 || NW < 2 ||
      NW > MAX_NW || RING < (NW + 2) * KD || (RING & (RING - 1)) ||
      ncol % 16 || (cig && p == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      m <= 8 ? (TP == 128  ? band_smem_bytes<128, SC8>(NW, RING, m)
                : TP == 64 ? band_smem_bytes<64, SC8>(NW, RING, m)
                           : band_smem_bytes<32, SC8>(NW, RING, m))
             : (TP == 128 ? band_smem_bytes<128, SCMAT>(NW, RING, m)
                          : band_smem_bytes<64, SCMAT>(NW, RING, m));
  return smem > 232448 ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  TP: the
// tile (32 or 64 positions; 128 for score launches; not 32 for m > 8),
// NW: the compute warps a block (at most MAX_NW), RING: the per-diagonal
// ring (a power of two of at least (NW + 2) KD); ops/band.py:band_layout
// picks them.
extern "C" int ksw2t_band_fwd(
    const void* qs, const void* ts, const void* qlen, const void* tlen,
    const void* w, const void* table, int B, int Lq, int Lt, int m, int q,
    int e, int q2, int e2, int qe_pre, int lt, int ld, int sc_mch,
    int sc_mis, int sc_N, int zdrop, int right, int generic, int approx,
    int adrop, int cig, int two, int nd, int ncol, int TP, int NW, int RING,
    void* rec, void* p, void* stream) {
  if (const int err = check_layout(B, m, TP, NW, RING, cig, ncol, p))
    return err;
  BandArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
             (const int*)tlen, (const int*)w, (const int*)table, Lq, Lt, m,
             q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N, zdrop,
             generic, adrop, nd, ncol, NW, RING, (int*)rec, (uint8_t*)p,
             nullptr, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(two ? launch_two<TWO_PIECE>(a, cig, approx, right, TP, B, st)
                   : launch_two<ONE>(a, cig, approx, right, TP, B, st));
}

// Kernel 6's wide form (SPL, counted as batch_exts_fwd): the exts
// recurrence with the donor and acceptor rows (int8, Lt a pair), on tiles
// of 64 (ops/batch_exts.py:exts_wide_layout).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_band_exts_fwd(
    const void* qs, const void* ts, const void* qlen, const void* tlen,
    const void* w, const void* table, const void* don, const void* acc,
    int B, int Lq, int Lt, int m, int q, int e, int q2, int lt, int ld,
    int sc_mch, int sc_mis, int sc_N, int zdrop, int right, int generic,
    int approx, int adrop, int cig, int nd, int ncol, int TP, int NW,
    int RING, void* rec, void* p, void* stream) {
  if (TP != 64) return (int)cudaErrorInvalidValue;
  if (const int err = check_layout(B, m, TP, NW, RING, cig, ncol, p))
    return err;
  BandArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
             (const int*)tlen, (const int*)w, (const int*)table, Lq, Lt, m,
             q, e, q2, 0, q + e, lt, ld, sc_mch, sc_mis, sc_N, zdrop,
             generic, adrop, nd, ncol, NW, RING, (int*)rec, (uint8_t*)p,
             (const signed char*)don, (const signed char*)acc};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(m <= 8 ? launch_forms<SPL_MODE, 2, SC8>(a, cig, approx, right,
                                                       B, st)
                      : launch_forms<SPL_MODE, 2, SCMAT>(a, cig, approx,
                                                         right, B, st));
}
