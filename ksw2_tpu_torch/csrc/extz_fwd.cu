// Single-pair forward (kernel 12): the one-piece anti-diagonal DP of one
// or many pairs, each spread over many blocks, for any band.
//
// Replaces ksw2_tpu/ops/wavefront.py:_extz_kernel_body (and its
// row-windowed form _extz_phase_body, which exists for the TPU's static
// shapes).  It computes what spec/diagdiff.py:extz2 specifies with any
// w >= 0: per anti-diagonal r = i + j the Suzuki-Kasahara deltas u, v, x,
// y in wrapping int8 over the 16-rounded band [st, en]
// (ksw2_extz2_sse.c:107-205), the exact max with the SSE 4-lane tie order
// and ksw_apply_zdrop, or the O(1) H0 walk (APPROX), the mqe / mte
// captures, the score and the first-empty-band stop, as the 9-field
// record of ops/records.py; with CIG the reference's direction byte of
// every cell of [st, en], into the compact store: row r at
// pbase[b] + off(r), off(r) the widths of the rows before it
// (common.cuh:store_row_off).  The plain version is
// ops/extz_fwd.py:extz_forward_plain.
//
// The same kernel in its MODE_EXTD form is kernel 13 (counted as
// extd_fwd), replacing ksw2_tpu/ops/wavefront_extd.py:_extd_kernel_body
// (and _extd_phase_body): the two-piece DP of spec/diagdiff.py:extd2
// (ksw2_extd2_sse.c) with the x2, y2 planes, signed bytes clamped at
// mat[0], the long_thres / long_diff first column, H seeded with the
// PRE-swap q + e and Z-drop with the gap slope e2.  In its MODE_EXTS form
// it is kernel 14 (exts_fwd), replacing ksw2_tpu/ops/wavefront_exts.py:
// _exts_kernel_body (and _exts_phase_body): the spliced DP of
// spec/diagdiff.py:exts2 (ksw2_exts2_sse.c) with the intron delta x2,
// the donor and acceptor rows each tile reads for its own positions, no
// per-cell clamp, H without offsets and Z-drop with no gap slope; exts
// has no band, so the caller passes w = max(qlen, tlen), whose rounded
// band is the whole matrix.  Their recurrences are band_fwd.cu's TWO form
// and batch_exts_fwd.cu's; the plain versions are ops/extd.py:
// extd_forward_plain and ops/exts.py:exts_forward_plain.
//
// Layout: the target axis of a pair is cut into tiles of TP positions
// (TP a multiple of 32); one warp (one block) owns a tile for the pair's
// whole run and walks the diagonals on which its tile meets the band.  A
// tile's state lives in shared memory at its absolute positions, as in
// kernel E (batch_fwd.cu), so the reference's stale bytes persist: lane l
// owns the positions t0 + 32 c + l, and neighbour t - 1 comes by shuffle
// or, at the tile's first position, from the tile before it.  That tile
// publishes the x, v (x2 two-piece and splice: the only planes a cell
// reads at t - 1, so the three bytes share one word whatever the form)
// and H of its last position after every diagonal it
// computes into a per-diagonal boundary history (no ring, so no
// back-pressure) and raises its progress counter with release semantics;
// the next tile spins on the counter with acquire semantics and reads up
// to 32 entries at once.  Blocks take their tile from an atomic ticket in
// pair, then tile order, so a tile waits only on one that is running
// already: no cooperative launch, any grid size.
//
// The diagonal's maximum is not reduced across blocks in the chain: each
// tile folds its part into one 64-bit (H, tie rank) key per diagonal with
// atomicMax into D[r], and the tiles that own st0 and en0 store that
// cell's H.  Z-drop, mqe / mte, the score and the stop are then replayed
// in order over the per-diagonal records by a second kernel, one warp a
// pair (ops/strips.py:replay_records is the model).  Under APPROX the H0
// walk runs inside the forward: the tile that holds the walk's next cell
// takes the step and stores (H0, t) of the diagonal, and the replay reads
// them.  The forward computes diagonals past a Z-drop stop; every field
// comes from the replay's exact stopping diagonal.
//
// What bounds it on an H100: the serial chain of a pair's diagonals
// (qlen + tlen - 1, ~100k on a 50 kb pair), each a few chunk steps of
// its tile, a 5-round shuffle argmax, an atomic and a hand-off through
// L2, against ~34 integer operations a cell (45 with the byte; ~44 and
// ~65 two-piece, ~41 and ~57 splice; chip_smoke.py: OPS, BYTE_OPS) and,
// with CIG, the store's bytes.  The
// design spreads a long pair over ~TP-wide tiles so that every diagonal
// runs on many SMs; several diagonals a hand-off, DPX byte SIMD and
// registers instead of shared memory are later work.
#include <climits>

#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;   // NEG_INF of core/flags.py
constexpr int KT = 1 << 24;        // tie-rank class stride (> a band)
constexpr unsigned FULL = 0xffffffffu;
// a wait on the tile before may last SPIN_BASE + SPIN_DIAG cycles for each
// of the pair's diagonals (~10 s + ~100 us a diagonal of SM clock) before
// it counts as a fault; between reads it asks for a sleep that doubles
// from 16 ns up to SPIN_SLEEP_MAX ns
constexpr long long SPIN_BASE = 20000000000LL;
constexpr long long SPIN_DIAG = 200000LL;
constexpr unsigned SPIN_SLEEP_MAX = 128;

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ long long pack_walk(int H0, int t) {
  return (long long)(((unsigned long long)(unsigned)H0 << 32) |
                     (unsigned long long)(unsigned)t);
}

// The kernel's forms: one-piece (kernel 12), two-piece (kernel 13) and
// splice (kernel 14).
constexpr int MODE_EXTZ = 0, MODE_EXTD = 1, MODE_EXTS = 2;

struct FwdArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const int* table;
  const signed char* don;  // (B, Lt) splice donor rows (MODE_EXTS)
  const signed char* acc;  // (B, Lt) ... and acceptor rows
  const int* tbase;        // (B + 1) first tile of each pair
  const long long* dbase;  // (B) first per-diagonal record
  const long long* bbase;  // (B) first boundary entry
  const long long* pbase;  // (B) first store byte
  int B, Lq, Lt, m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N;
  int zdrop, right, generic, adrop, TP;
  int* ticket;
  int* progress;           // per tile: its last published diagonal
  int2* bnd;               // (x | v << 8 | x2 << 16, H) of a tile's last
                           // position
  long long* D;            // per diagonal: the max (H, rank) key
  int2* hse;               // per diagonal: H at st0 and at en0
  long long* W;            // per diagonal (APPROX): (H0, its t)
  uint8_t* p;
};

// The first diagonal a tile starting at t0 can touch (the score fill runs
// up to 15 positions past en0) and the last one whose band starts in it.
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

// Delta planes of a form: u, v, x, y, and x2, y2 (two-piece) or x2
// (splice).
__host__ __device__ constexpr int n_planes(int mode) {
  return mode == MODE_EXTD ? 6 : mode == MODE_EXTS ? 5 : 4;
}

template <int MODE, bool CIG, bool APPROX>
__global__ void __launch_bounds__(32) extz_fwd_kernel(const FwdArgs A) {
  constexpr bool ONE = MODE == MODE_EXTZ;
  constexpr int PL = n_planes(MODE);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int TP = A.TP;
  uint8_t* stage = smem;                                       // [32]
  int* Hr = reinterpret_cast<int*>(smem + 32);                 // [TP]
  signed char* pl = reinterpret_cast<signed char*>(Hr + TP);   // [PL][TP]
  signed char* sr = pl + PL * TP;                              // [TP]
  uint8_t* tgs = reinterpret_cast<uint8_t*>(sr + TP);          // [TP]
  signed char* dns = reinterpret_cast<signed char*>(tgs + TP); // [TP]
  signed char* acs = dns + TP;                                 // [TP]

  int g = 0;
  if (lane == 0) g = atomicAdd(A.ticket, 1);
  g = __shfl_sync(FULL, g, 0);
  int lo = 0, hi = A.B - 1;                // the pair: last tbase[b] <= g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (A.tbase[mid] <= g) lo = mid; else hi = mid - 1;
  }
  const int b = lo, k = g - A.tbase[b];
  const int ntiles = A.tbase[b + 1] - A.tbase[b];
  const int t0 = k * TP, X = t0 + TP - 1;
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int q = A.q, e = A.e, qe = q + e, q2 = A.q2, qe2 = A.q2 + A.e2;
  // the reference's init bytes: 0 one-piece; -(q + e) for u, v, x, y and
  // -(q2 + e2) for x2, y2 two-piece; -(q + e) and -q2 (e2 = 0) splice
  const int init = ONE ? 0 : w8(-qe), init2 = w8(-qe2);
  const int rlim = first_empty_diag(qlen, tlen, w);
  const int rA = tile_first(t0, w), rB = tile_last(t0, TP, qlen, w, rlim);
  const long long spin_limit = SPIN_BASE + SPIN_DIAG * rlim;
  const long long db = A.dbase[b];
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;

  for (int t = lane; t < TP; t += 32) {
    for (int c = 0; c < 4; ++c) pl[c * TP + t] = (signed char)init;
    for (int c = 4; c < PL; ++c) pl[c * TP + t] = (signed char)init2;
    sr[t] = 0;
    Hr[t] = NEG;
    tgs[t] = t0 + t < tlen ? tg[t0 + t] : 0;
    if (MODE == MODE_EXTS) {
      dns[t] = t0 + t < A.Lt ? A.don[(size_t)b * A.Lt + t0 + t] : 0;
      acs[t] = t0 + t < A.Lt ? A.acc[(size_t)b * A.Lt + t0 + t] : 0;
    }
  }
  __syncwarp();

  // the tile before this one: its history and the diagonals it computes
  const int2* prevb = nullptr;
  int pA = 0, pB = -1;
  if (k > 0) {
    prevb = A.bnd + A.bbase[b] + (long long)(k - 1) * rlim;
    pA = tile_first(t0 - TP, w);
    pB = tile_last(t0 - TP, TP, qlen, w, rlim);
  }
  int2* myb = k + 1 < ntiles ? A.bnd + A.bbase[b] + (long long)k * rlim
                             : nullptr;
  int cb = 0, ch = -1, seen = -1;          // cached history [cb, ch]
  int2 cent = make_int2(0, 0);
  int H0 = 0, lt = 0, known = -2;          // the H0 walk after `known`
  long long off = CIG ? store_row_off(rA, qlen, tlen, w) : 0;
  uint8_t* pp = CIG ? A.p + A.pbase[b] : nullptr;

  for (int r = rA; r <= rB; ++r) {
    const BandRow bd = band_row(r, qlen, tlen, w);
    const int st0 = bd.st0, en0 = bd.en0, st = bd.st, en = bd.en;
    bool prevok = false;
    if (r > 0 && st > 0) {
      const BandRow bp = band_row(r - 1, qlen, tlen, w);
      prevok = bp.st <= st - 1 && st - 1 <= bp.en;
    }
    // the first column (the j == 0 cell at t == r): q one-piece; the
    // two-piece switch at long_thres (ksw2_extd2_sse.c:156-163), which
    // is the splice one with e2 = 0 (ksw2_exts2_sse.c)
    const int colv = w8(ONE ? (r ? q : 0)
                            : r == 0 ? -qe
                                     : r < A.lt ? -e
                                                : r == A.lt ? A.ld : -A.e2);
    const int hi = A.generic ? en0 : st0 + ((en0 - st0) & ~15) + 15;

    // position t0 - 1 before this diagonal (and, APPROX, after it): the
    // previous tile's entry of min(r - 1, its last diagonal); the initial
    // values before its first
    int bx = init, bv = init, bx2 = init2, bH = NEG, bvn = 0;
    if (k > 0 && t0 >= st && t0 <= en) {
      const int e0 = min(r - 1, pB);
      const int e1 = APPROX ? min(r, pB) : e0;
      if (e1 >= pA) {
        const int elo = max(e0, pA);
        if (elo < cb || e1 > ch) {
          if (e1 > seen) {
            // the tile before runs already (its ticket came first), so
            // the wait ends; one past the pair's spin limit is a fault:
            // trap, do not hang
            const int* pp_ = A.progress + g - 1;
            const long long t_start = clock64();
            unsigned nap = 16;
            int pv;
            while ((pv = __reduce_min_sync(FULL, ld_acquire(pp_))) < e1) {
              if (clock64() - t_start > spin_limit) __trap();
              __nanosleep(nap);
              nap = min(2 * nap, SPIN_SLEEP_MAX);
            }
            seen = pv;
          }
          cb = elo;
          ch = min(seen, cb + 31);
          if (cb + lane <= ch) cent = __ldcg(prevb + cb + lane);
        }
        const int ex = __shfl_sync(FULL, cent.x, elo - cb);
        const int eH = __shfl_sync(FULL, cent.y, elo - cb);
        if (e0 >= pA) {
          bx = w8(ex);
          bv = w8(ex >> 8);
          bx2 = w8(ex >> 16);
          bH = eH;
        }
        if (APPROX) bvn = w8(__shfl_sync(FULL, cent.x, e1 - cb) >> 8);
      }
    }

    const int lo_t = max(st - 1, t0), hi_t = min(max(en, hi), X);
    long long best = LLONG_MIN;
    // the old state of t - 1, lane 0
    int cX = bx, cV = bv, cX2 = bx2, cH = bH;
    for (int c = lo_t <= hi_t ? (lo_t - t0) >> 5 : 1,
             ce = lo_t <= hi_t ? (hi_t - t0) >> 5 : 0;
         c <= ce; ++c) {
      const int l = (c << 5) + lane;      // local position
      const int t = t0 + l;
      if (t >= st0 && t <= hi) {
        const int T = tgs[l];
        const int Q = r - t >= 0 ? qy[r - t] : 0;
        int sv;
        if (A.generic) {
          sv = A.table[T * A.m + Q];
        } else {
          sv = T == Q ? A.sc_mch : A.sc_mis;
          if (T == A.m - 1 || Q == A.m - 1) sv = A.sc_N;
        }
        sr[l] = (signed char)w8(sv);
      }
      const int Uo = pl[l], Vo = pl[TP + l], Xo = pl[2 * TP + l],
                Yo = pl[3 * TP + l];
      const int X2o = ONE ? 0 : pl[4 * TP + l];
      const int Ho = APPROX ? 0 : Hr[l];
      int Xm = __shfl_up_sync(FULL, Xo, 1);
      int Vm = __shfl_up_sync(FULL, Vo, 1);
      int X2m = ONE ? 0 : __shfl_up_sync(FULL, X2o, 1);
      int Hm = APPROX ? 0 : __shfl_up_sync(FULL, Ho, 1);
      if (lane == 0) {
        Xm = cX;
        Vm = cV;
        X2m = cX2;
        Hm = cH;
      }
      cX = __shfl_sync(FULL, Xo, 31);
      cV = __shfl_sync(FULL, Vo, 31);
      if (!ONE) cX2 = __shfl_sync(FULL, X2o, 31);
      if (!APPROX) cH = __shfl_sync(FULL, Ho, 31);

      int d = 0;
      if (t >= st && t <= en) {
        const int S = sr[l];
        int X1 = Xm, V1 = Vm, X21 = X2m;
        if (t == st && !prevok) {
          X1 = init;
          V1 = st == 0 ? colv : init;
          X21 = init2;
        }
        const int U = t == r ? colv : Uo;
        const int Y = t == r ? init : Yo;
        int a = w8(X1 + V1), bb = w8(Y + U);
        int un, vn;
        if (MODE == MODE_EXTZ) {
          const int zz = w8(S + 2 * qe);
          d = A.right ? (zz > a ? 0 : DIR_E) : (a > zz ? DIR_E : 0);
          int z = max(zz, a);
          d = A.right ? (z > bb ? d : DIR_F) : (bb > z ? DIR_F : d);
          z = w8(max(z & 255, bb & 255));                   // max_epu8
          z = w8(min(z & 255, (A.sc_mch + 2 * qe) & 255));  // min_epu8
          un = w8(z - V1);
          vn = w8(z - U);
          const int z2 = w8(z - q);
          a = w8(a - z2);
          bb = w8(bb - z2);
          const bool ta = A.right ? a >= 0 : a > 0;
          const bool tb = A.right ? bb >= 0 : bb > 0;
          d |= (ta ? DIR_E_CONT : 0) | (tb ? DIR_F_CONT : 0);
          pl[2 * TP + l] = (signed char)(a > 0 ? a : 0);
          pl[3 * TP + l] = (signed char)(bb > 0 ? bb : 0);
        } else if (MODE == MODE_EXTD) {
          // band_fwd.cu's TWO recurrence (ksw2_extd2_sse.c)
          const int Y2 = t == r ? init2 : pl[5 * TP + l];
          int a2 = w8(X21 + V1), b2 = w8(Y2 + U);
          int z = S;
          const int cand[4] = {a, bb, a2, b2};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d = A.right ? (z > cand[i] ? d : i + 1)
                        : (cand[i] > z ? i + 1 : d);
            z = max(z, cand[i]);
          }
          z = min(z, w8(A.sc_mch));
          un = w8(z - V1);
          vn = w8(z - U);
          const int t1 = w8(z - q), t2 = w8(z - q2);
          a = w8(a - t1);
          bb = w8(bb - t1);
          a2 = w8(a2 - t2);
          b2 = w8(b2 - t2);
          const bool ca = A.right ? a >= 0 : a > 0;
          const bool cb_ = A.right ? bb >= 0 : bb > 0;
          const bool ca2 = A.right ? a2 >= 0 : a2 > 0;
          const bool cb2 = A.right ? b2 >= 0 : b2 > 0;
          d |= (ca ? DIR_E_CONT : 0) | (cb_ ? DIR_F_CONT : 0) |
               (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
          pl[2 * TP + l] = (signed char)w8(max(a, 0) - qe);
          pl[3 * TP + l] = (signed char)w8(max(bb, 0) - qe);
          pl[4 * TP + l] = (signed char)w8(max(a2, 0) - qe2);
          pl[5 * TP + l] = (signed char)w8(max(b2, 0) - qe2);
        } else {
          // batch_exts_fwd.cu's recurrence (ksw2_exts2_sse.c): the
          // intron candidate with the acceptor, no clamp of z
          const int Dn = dns[l];
          int a2 = w8(X21 + V1);
          const int cand[3] = {a, bb, w8(a2 + acs[l])};
          int z = S;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            d = A.right ? (z > cand[i] ? d : i + 1)
                        : (cand[i] > z ? i + 1 : d);
            z = max(z, cand[i]);
          }
          un = w8(z - V1);
          vn = w8(z - U);
          const int t1 = w8(z - q);
          a = w8(a - t1);
          bb = w8(bb - t1);
          a2 = w8(a2 - z + q2);
          const bool ca = A.right ? a >= 0 : a > 0;
          const bool cb_ = A.right ? bb >= 0 : bb > 0;
          const bool cd = A.right ? a2 >= Dn : a2 > Dn;
          d |= (ca ? DIR_E_CONT : 0) | (cb_ ? DIR_F_CONT : 0) |
               (cd ? DIR_N_CONT : 0);
          pl[2 * TP + l] = (signed char)w8(max(a, 0) - qe);
          pl[3 * TP + l] = (signed char)w8(max(bb, 0) - qe);
          pl[4 * TP + l] = (signed char)w8(max(a2, Dn) - q2);
        }
        pl[l] = (signed char)un;
        pl[TP + l] = (signed char)vn;

        if (!APPROX && t >= st0 && t <= en0) {
          // the H row (spec/common.py:exact_max_scan): unsigned deltas
          // less q + e one-piece, signed deltas otherwise; seeded with
          // 2 (q + e) one-piece, the PRE-swap q + e two-piece and q + e
          // splice (qe_pre)
          const int vv = ONE ? vn & 255 : vn, uu = ONE ? un & 255 : un;
          const int sub = ONE ? qe : 0;
          int h;
          if (r == 0)
            h = vv - (ONE ? 2 * qe : A.qe_pre);
          else if (t < en0 || en0 == 0)
            h = Ho + vv - sub;
          else
            h = Hm + uu - sub;
          Hr[l] = h;
          // the SSE scan's tie rank: the en0 cell, then 4 lane classes
          // over [st0, en1), then the scalar tail; smaller ranks win
          const int rel = t - st0;
          const int en1 = st0 + ((en0 - st0) & ~3);
          const int rank = t == en0 ? 0
                           : t < en1 ? (rel & 3) * KT + rel + 1
                                     : 4 * KT + rel + 1;
          best = max(best, (long long)h * 4294967296LL +
                               (long long)(0x7fffffff - rank));
          if (t == st0) A.hse[db + r].x = h;
          if (t == en0) A.hse[db + r].y = h;
        }
      }
      if (CIG) {
        // 16-byte groups lie wholly inside or outside [st, en]
        stage[lane] = (uint8_t)d;
        __syncwarp();
        if (lane < 2) {
          const int gs = t0 + (c << 5) + 16 * lane;
          if (gs >= st && gs + 15 <= en)
            *reinterpret_cast<uint4*>(pp + off + (gs - st)) =
                *reinterpret_cast<const uint4*>(stage + 16 * lane);
        }
        __syncwarp();
      }
    }

    if (!APPROX) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best = max(best, __shfl_xor_sync(FULL, best, o));
      if (lane == 0 && best != LLONG_MIN) atomicMax(A.D + db + r, best);
    } else {
      __syncwarp();
      // the H0 walk (ksw2_extz2_sse.c:262-279) on unsigned deltas less
      // q + e one-piece, on signed deltas otherwise: the tile that holds
      // the walk's next cell takes the step
      if (r == 0) {
        H0 = ONE ? (pl[TP] & 255) - 2 * qe : pl[TP] - A.qe_pre;
        lt = 0;
        known = 0;
        if (lane == 31) A.W[db] = pack_walk(H0, lt);
      } else {
        if (known != r - 1) {
          const long long wv = __ldcg(A.W + db + r - 1);
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
            if (c1) d0 = lt >= t0 ? pl[TP + lt - t0] : bvn;
            if (c2) d1 = pl[lt + 1 - t0];
            if (ONE) {
              d0 = (d0 & 255) - qe;
              d1 = (d1 & 255) - qe;
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
            if (lane == 31) A.W[db + r] = pack_walk(H0, lt);
          }
        }
      }
      __syncwarp();
    }

    if (myb != nullptr && lane == 31) {
      // lane 31 owns the tile's last position: publish it, then release
      const int x2b = ONE ? 0 : pl[4 * TP + TP - 1] & 255;
      myb[r] = make_int2((pl[2 * TP + TP - 1] & 255) |
                             ((pl[TP + TP - 1] & 255) << 8) | (x2b << 16),
                         Hr[TP - 1]);
      st_release(A.progress + g, r);
    }
    if (CIG) off += en - st + 1;
  }
}

struct ReplayArgs {
  const int* qlens;
  const int* tlens;
  const int* ws;
  const long long* dbase;
  const long long* D;
  const int2* hse;
  const long long* W;
  int B, zslope, zdrop, adrop, adrop_r0;
  int* rec;
  int* stop;
};

// The in-order replay of the per-diagonal records: ksw_apply_zdrop
// (ksw2.h:191-207) with the form's gap slope (e one-piece, e2 two-piece,
// 0 splice), mqe / mte (mte_q keeps the reference's r - en rounding), the
// score and the stop, one warp a pair, 32 diagonals a load.  APPROX_DROP
// applies from diagonal adrop_r0: 1 one-piece, 0 otherwise.
template <bool APPROX>
__global__ void __launch_bounds__(128) extz_replay_kernel(
    const ReplayArgs A) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (b >= A.B) return;
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int ndb = qlen + tlen - 1;
  const int rlim = first_empty_diag(qlen, tlen, w);
  const long long db = A.dbase[b];
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
      return A.zdrop >= 0 && mx - Hm > A.zdrop + l * A.zslope;
    }
    return false;
  };
  bool done = false;
  for (int base = 0; base < rlim && !done; base += 32) {
    const int n = min(32, rlim - base);
    long long dv = 0;
    int2 hv = make_int2(0, 0);
    if (lane < n) {
      if (APPROX) {
        dv = A.W[db + base + lane];
      } else {
        dv = A.D[db + base + lane];
        hv = A.hse[db + base + lane];
      }
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
        const int maxt = rank == 0 ? bd.en0
                         : rank <= 4 * KT ? bd.st0 + (rank - 1) % KT
                                          : bd.st0 + rank - 1 - 4 * KT;
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
        if (A.adrop && r >= A.adrop_r0) drop = zdrop_apply(r, h0, t);
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
  }
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
    A.stop[b] = stop;
  }
}

template <int MODE, bool CIG, bool APPROX>
cudaError_t launch_fwd(const FwdArgs& a, int n_tiles, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      extz_fwd_kernel<MODE, CIG, APPROX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  extz_fwd_kernel<MODE, CIG, APPROX><<<n_tiles, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const FwdArgs& a, int cig, int approx, int n_tiles,
                        cudaStream_t stream) {
  // a tile's state: the byte stage, H int32, the delta planes, the score
  // bytes, the target and, splice, the donor and acceptor bytes
  const size_t smem = 32 + (size_t)a.TP * (4 + n_planes(MODE) + 2 +
                                           (MODE == MODE_EXTS ? 2 : 0));
  if (cig)
    return approx ? launch_fwd<MODE, true, true>(a, n_tiles, smem, stream)
                  : launch_fwd<MODE, true, false>(a, n_tiles, smem, stream);
  return approx ? launch_fwd<MODE, false, true>(a, n_tiles, smem, stream)
                : launch_fwd<MODE, false, false>(a, n_tiles, smem, stream);
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 on success).
// mode: 0 one-piece (kernel 12), 1 two-piece (kernel 13; POST-swap q, e,
// q2, e2 and the PRE-swap q + e as qe_pre), 2 splice (kernel 14; e2 = 0,
// qe_pre = q + e, don and acc the (B, Lt) int8 site rows).
extern "C" int ksw2t_extz_fwd(
    int mode, const void* qs, const void* ts, const void* qlen,
    const void* tlen, const void* w, const void* table, const void* don,
    const void* acc, const void* tbase, const void* dbase, const void* bbase,
    const void* pbase, int B, int Lq, int Lt, int m, int q, int e, int q2,
    int e2, int qe_pre, int lt, int ld, int sc_mch, int sc_mis, int sc_N,
    int zdrop, int right, int generic, int approx, int adrop, int cig,
    int TP, int n_tiles, void* ticket, void* progress, void* bnd, void* D,
    void* hse, void* W, void* rec, void* stop, void* p, void* stream) {
  if (B <= 0 || n_tiles <= 0 || TP < 32 || TP % 32 || mode < MODE_EXTZ ||
      mode > MODE_EXTS || (cig && p == nullptr) ||
      (approx && W == nullptr) ||
      (!approx && (D == nullptr || hse == nullptr)) ||
      (mode == MODE_EXTS && (don == nullptr || acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
            (const int*)tlen, (const int*)w, (const int*)table,
            (const signed char*)don, (const signed char*)acc,
            (const int*)tbase, (const long long*)dbase,
            (const long long*)bbase, (const long long*)pbase, B, Lq, Lt, m, q,
            e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N, zdrop, right,
            generic, adrop, TP, (int*)ticket, (int*)progress, (int2*)bnd,
            (long long*)D, (int2*)hse, (long long*)W, (uint8_t*)p};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      mode == MODE_EXTZ   ? launch_mode<MODE_EXTZ>(a, cig, approx, n_tiles, st)
      : mode == MODE_EXTD ? launch_mode<MODE_EXTD>(a, cig, approx, n_tiles, st)
                          : launch_mode<MODE_EXTS>(a, cig, approx, n_tiles, st);
  if (err != cudaSuccess) return (int)err;
  const int zslope = mode == MODE_EXTZ ? e : mode == MODE_EXTD ? e2 : 0;
  ReplayArgs ra{(const int*)qlen, (const int*)tlen, (const int*)w,
                (const long long*)dbase, (const long long*)D,
                (const int2*)hse, (const long long*)W, B, zslope, zdrop,
                adrop, mode == MODE_EXTZ ? 1 : 0, (int*)rec, (int*)stop};
  if (approx)
    extz_replay_kernel<true><<<(B + 3) / 4, 128, 0, st>>>(ra);
  else
    extz_replay_kernel<false><<<(B + 3) / 4, 128, 0, st>>>(ra);
  return (int)cudaGetLastError();
}
