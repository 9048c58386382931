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
// band is the whole matrix.  Their recurrences are band_fwd.cu's TWO and
// SPL forms; the plain versions are ops/extd.py:
// extd_forward_plain and ops/exts.py:exts_forward_plain.
//
// Layout: the target axis of a pair is cut into tiles of TP positions
// (TP = 32 NC, NC = 1 or 2 chunks of 32; ops/extz_fwd.py:choose_tp picks
// it); one warp (one block) owns a tile for the pair's whole run and
// walks the diagonals on which its tile meets the band.  Lane l keeps the
// positions t0 + 32 c + l, chunk c = 0 .. NC - 1, in registers: the
// planes u, v, x, y (x2, y2 two-piece; x2 splice), H, the score byte and
// the target (and site) bytes, so the reference's stale bytes persist as
// they do in its SSE rows.  Neighbour t - 1 is one shuffle a plane: a
// rotation by one lane, whose lane 0 receives lane 31, which is the next
// chunk's t - 1; the first chunk's comes from the tile before.  Every
// chunk is computed with selects, not branches, so the chunks' chains
// interleave.  Diagonals go in groups of KD (32), aligned on multiples of
// KD for every tile.  Per group, lane j prepares diagonal r_lo + j's band
// row and t0 - 1's old state in shared memory, and the tile stages the
// query window its cells read (TP + KD bases: the window slides one base
// a diagonal).  After the group the tile publishes the x, v (x2: the
// only planes a cell reads at t - 1, so the three bytes share one word)
// and H of its last position for each of the group's diagonals into a
// per-diagonal boundary history (no ring, so no back-pressure), then
// raises its progress counter once with release semantics; the next tile
// waits once a group, one lane spinning with acquire semantics, and
// reads the group's entries at once.  A tile thus runs one group behind
// the tile before it.  Blocks take their tile from an atomic ticket in
// pair, then tile order, so a tile waits only on one that is running
// already: no cooperative launch, any grid size.
//
// The diagonal's maximum is not reduced across blocks in the chain: each
// lane keeps its best 64-bit (H, tie rank) key of each diagonal of the
// group in shared memory, and after the group's release lane j folds
// diagonal r_lo + j's 32 keys into one atomicMax on D[r]; the tiles that
// own st0 and en0 store that cell's H then too.  Z-drop, mqe / mte, the
// score and the stop are then replayed
// in order over the per-diagonal records by a second kernel, one warp a
// pair (ops/strips.py:replay_records is the model).  Under APPROX the H0
// walk runs inside the forward: the tile that holds the walk's next cell
// takes the step and stores (H0, t) of the diagonal, and the replay reads
// them.  The forward computes diagonals past a Z-drop stop; every field
// comes from the replay's exact stopping diagonal.
//
// What bounds it on an H100: the serial chain of a pair's diagonals
// (qlen + tlen - 1, ~100k on a 50 kb pair) through one tile's chunk steps,
// plus the pipeline's fill of tiles x (KD diagonals + a hand-off), against
// ~34 integer operations a cell (45 with the byte; ~44 and ~65 two-piece,
// ~41 and ~57 splice; chip_smoke.py: OPS, BYTE_OPS) and, with CIG, the
// store's bytes.  One warp runs a chunk step's ~150 dependent
// instructions in ~500 cycles (a clock64 breakdown on the card: of ~870
// cycles a tile-diagonal at 32-position tiles, ~520 are the chunk step;
// the waits, the group's loads, release, fold and atomics ~240), so the
// narrowest tiles run the shortest chain and a wide tile's chunks barely
// overlap.  Byte SIMD (four cells an instruction) and an early exit past
// a Z-drop are later work.
#include <climits>

#include "common.cuh"

using namespace ksw2t;
using namespace ksw2t::tiles;

namespace {

constexpr int NEG = -0x40000000;   // NEG_INF of core/flags.py
constexpr int KT = 1 << 24;        // tie-rank class stride (> a band)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

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

template <int MODE, bool CIG, bool APPROX, int NC, bool RIGHT>
__global__ void __launch_bounds__(32) extz_fwd_kernel(const FwdArgs A) {
  constexpr bool ONE = MODE == MODE_EXTZ;
  constexpr bool SPL = MODE == MODE_EXTS;
  constexpr int TP = 32 * NC;
  // a group's query window, the direction bytes of two diagonals, the
  // tile before's entries [r_lo - 1, r_hi], this tile's edge entries, each
  // lane's key and the st0 / en0 H of every diagonal of the group
  __shared__ uint8_t qwin[TP + KD];
  __shared__ __align__(16) uint8_t stage[2][CIG ? TP : 16];
  __shared__ int2 sprev[KD + 1];
  __shared__ int4 sdiag[KD];               // st0, en0, hi_s, colv | prevok
  __shared__ int2 sbnd[KD];                // position t0 - 1's old state
  __shared__ int2 sedge[KD];
  __shared__ long long skey[APPROX ? 1 : KD][33];
  __shared__ int shs[KD], she[KD];
  extern __shared__ int stab[];            // GENERIC_SC: the m x m table
  const int lane = threadIdx.x;

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
  const int q = A.q, e = A.e, qe = q + e, qe2 = A.q2 + A.e2;
  // the reference's init bytes: 0 one-piece; -(q + e) for u, v, x, y and
  // -(q2 + e2) for x2, y2 two-piece; -(q + e) and -q2 (e2 = 0) splice
  const int init = ONE ? 0 : w8(-qe), init2 = w8(-qe2);
  const int rlim = first_empty_diag(qlen, tlen, w);
  const int rA = tile_first(t0, w), rB = tile_last(t0, TP, qlen, w, rlim);
  const long long spin_limit = SPIN_BASE + SPIN_DIAG * rlim;
  const long long db = A.dbase[b];
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  if (A.generic)
    for (int i = lane; i < A.m * A.m; i += 32) stab[i] = A.table[i];

  // lane l's state: position t0 + 32 c + l in chunk c's registers
  int U[NC], V[NC], Xp[NC], Y[NC], X2[NC], Y2[NC], H[NC], S[NC], TG[NC],
      DN[NC], AC[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int t = t0 + 32 * c + lane;
    U[c] = V[c] = Xp[c] = Y[c] = init;
    X2[c] = Y2[c] = init2;
    H[c] = NEG;
    S[c] = 0;
    TG[c] = t < tlen ? tg[t] : 0;
    DN[c] = AC[c] = 0;
    if (SPL && t < A.Lt) {
      DN[c] = A.don[(size_t)b * A.Lt + t];
      AC[c] = A.acc[(size_t)b * A.Lt + t];
    }
  }

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
  int seen = -1;                           // the tile before's progress
  int H0 = 0, lt = 0, known = -2;          // the H0 walk after `known`
  long long off = CIG ? store_row_off(rA, qlen, tlen, w) : 0;
  uint8_t* pp = CIG ? A.p + A.pbase[b] : nullptr;
  int buf = 0;

  // groups of KD diagonals, aligned on multiples of KD for every tile, so
  // a tile runs one group behind the tile before it
  for (int r_lo = rA; r_lo <= rB;) {
    const int r_hi = min(r_lo - r_lo % KD + KD - 1, rB);
    const int nr = r_hi - r_lo + 1;
    // one wait a group: lane 0 spins (acquire) until the tile before has
    // released every diagonal this group reads of it; the tile before
    // runs already (its ticket came first), so the wait ends, and one
    // past the pair's spin limit is a fault: trap, do not hang
    int cb = 0;
    if (k > 0) {
      const int need = min(APPROX ? r_hi : r_hi - 1, pB);
      if (need >= pA && need > seen) {
        int pv = seen;
        if (lane == 0) {
          const int* pg = A.progress + g - 1;
          const long long t_start = clock64();
          unsigned nap = 16;
          while ((pv = ld_acquire(pg)) < need) {
            if (clock64() - t_start > spin_limit) __trap();
            __nanosleep(nap);
            nap = min(2 * nap, SPIN_SLEEP_MAX);
          }
        }
        __syncwarp();                       // orders the reads below
        seen = __shfl_sync(FULL, pv, 0);
      }
      // [cb, ce]: the entries the group reads (e0 = min(r - 1, pB) and,
      // APPROX, e1 = min(r, pB)); after the tile before's last diagonal
      // only its last entry
      cb = max(min(r_lo - 1, pB), pA);
      const int ce = min(min(r_hi, pB), seen);
      for (int j = lane; j <= ce - cb; j += 32)
        sprev[j] = __ldcg(prevb + cb + j);
    }
    // the query bases the group's cells read: r - t for r in the group
    const int qb = r_lo - X;
    for (int i = lane; i < TP + KD - 1; i += 32) {
      const int qi = qb + i;
      qwin[i] = qi >= 0 && qi < qlen ? qy[qi] : 0;
    }
    __syncwarp();
    // what each diagonal of the group needs besides its cells, a lane a
    // diagonal, off the chain of chunk steps
    if (lane < nr) {
      const int r = r_lo + lane;
      const BandRow bd = band_row(r, qlen, tlen, w);
      bool prevok = false;
      if (r > 0 && bd.st > 0) {
        const BandRow bp = band_row(r - 1, qlen, tlen, w);
        prevok = bp.st <= bd.st - 1 && bd.st - 1 <= bp.en;
      }
      // the first column (the j == 0 cell at t == r): q one-piece; the
      // two-piece switch at long_thres (ksw2_extd2_sse.c:156-163), which
      // is the splice one with e2 = 0 (ksw2_exts2_sse.c)
      const int colv = w8(ONE ? (r ? q : 0)
                              : r == 0 ? -qe
                                       : r < A.lt ? -e
                                                  : r == A.lt ? A.ld : -A.e2);
      const int hi_s = A.generic ? bd.en0
                                 : bd.st0 + ((bd.en0 - bd.st0) & ~15) + 15;
      sdiag[lane] = make_int4(bd.st0, bd.en0, hi_s,
                              (colv & 255) | (prevok ? 256 : 0));
      // position t0 - 1 before this diagonal (and, APPROX, v after it):
      // the tile before's entry of min(r - 1, its last diagonal); the
      // initial values before its first
      int bx = init, bv = init, bx2 = init2, bH = NEG, bvn = 0;
      if (k > 0 && t0 >= bd.st && t0 <= bd.en) {
        const int e0 = min(r - 1, pB);
        const int e1 = APPROX ? min(r, pB) : e0;
        if (e1 >= pA) {
          if (e0 >= pA) {
            const int2 ent = sprev[e0 - cb];
            bx = ent.x;
            bv = ent.x >> 8;
            bx2 = ent.x >> 16;
            bH = ent.y;
          }
          if (APPROX) bvn = sprev[e1 - cb].x >> 8;
        }
      }
      sbnd[lane] = make_int2((bx & 255) | (bv & 255) << 8 | (bx2 & 255) << 16 |
                                 (bvn & 255) << 24,
                             bH);
    }
    __syncwarp();

    // unrolled: a diagonal's loads and score bytes overlap the chain of
    // the one before
#pragma unroll 4
    for (int rr = 0; rr < nr; ++rr) {
      const int r = r_lo + rr;
      const int4 dg = sdiag[rr];
      const int st0 = dg.x, en0 = dg.y, st = st0 & ~15, en = en0 | 15;
      const int hi_s = dg.z, colv = w8(dg.w);
      const bool prevok = dg.w & 256;
      const int2 bw = sbnd[rr];
      const int bx = w8(bw.x), bv = w8(bw.x >> 8), bx2 = w8(bw.x >> 16),
                bvn = w8(bw.x >> 24), bH = bw.y;
      long long best = LLONG_MIN;
      // the old state of t - 1 for lane 0: the boundary, then each chunk's
      // lane 31 (a rotation by one lane gives it to lane 0)
      int cX = bx, cV = bv, cX2 = bx2, cH = bH;
      // every chunk, straight-line: a cell outside the band keeps its
      // state (selects, not branches), so the chunks' chains interleave
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int l = 32 * c + lane;
        const int t = t0 + l;
        const int src = (lane + 31) & 31;
        const bool l0 = lane == 0;
        const int sX = __shfl_sync(FULL, Xp[c], src);
        const int sV = __shfl_sync(FULL, V[c], src);
        const int sX2 = ONE ? 0 : __shfl_sync(FULL, X2[c], src);
        const int sH = APPROX ? 0 : __shfl_sync(FULL, H[c], src);
        const int Xm = l0 ? cX : sX, Vm = l0 ? cV : sV;
        const int X2m = l0 ? cX2 : sX2, Hm = l0 ? cH : sH;
        // lane 0 now holds lane 31's old state: the next chunk's t - 1
        cX = sX;
        cV = sV;
        cX2 = sX2;
        cH = sH;

        const int T = TG[c];
        const int Q = qwin[rr + TP - 1 - l];
        int sv;
        if (A.generic) {
          sv = stab[T * A.m + Q];
        } else {
          sv = T == Q ? A.sc_mch : A.sc_mis;
          sv = T == A.m - 1 || Q == A.m - 1 ? A.sc_N : sv;
        }
        const int Sv = t >= st0 && t <= hi_s ? w8(sv) : S[c];
        S[c] = Sv;

        const bool inb = t >= st && t <= en;
        const bool edge = t == st && !prevok;
        const int X1 = edge ? init : Xm, X21 = edge ? init2 : X2m;
        const int V1 = edge ? (st == 0 ? colv : init) : Vm;
        const int Uc = t == r ? colv : U[c];
        const int Yc = t == r ? init : Y[c];
        int a = w8(X1 + V1), bb = w8(Yc + Uc);
        int d, un, vn;
        if (MODE == MODE_EXTZ) {
          const int zz = w8(Sv + 2 * qe);
          d = RIGHT ? (zz > a ? 0 : DIR_E) : (a > zz ? DIR_E : 0);
          int z = max(zz, a);
          d = RIGHT ? (z > bb ? d : DIR_F) : (bb > z ? DIR_F : d);
          z = w8(max(z & 255, bb & 255));                   // max_epu8
          z = w8(min(z & 255, (A.sc_mch + 2 * qe) & 255));  // min_epu8
          un = w8(z - V1);
          vn = w8(z - Uc);
          const int z2 = w8(z - q);
          a = w8(a - z2);
          bb = w8(bb - z2);
          const bool ta = RIGHT ? a >= 0 : a > 0;
          const bool tb = RIGHT ? bb >= 0 : bb > 0;
          d |= (ta ? DIR_E_CONT : 0) | (tb ? DIR_F_CONT : 0);
          Xp[c] = inb ? (a > 0 ? a : 0) : Xp[c];
          Y[c] = inb ? (bb > 0 ? bb : 0) : Y[c];
        } else if (MODE == MODE_EXTD) {
          // band_fwd.cu's TWO recurrence (ksw2_extd2_sse.c)
          const int Y2c = t == r ? init2 : Y2[c];
          int a2 = w8(X21 + V1), b2 = w8(Y2c + Uc);
          int z = Sv;
          d = 0;
          const int cand[4] = {a, bb, a2, b2};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d = RIGHT ? (z > cand[i] ? d : i + 1)
                        : (cand[i] > z ? i + 1 : d);
            z = max(z, cand[i]);
          }
          z = min(z, w8(A.sc_mch));
          un = w8(z - V1);
          vn = w8(z - Uc);
          const int t1 = w8(z - q), t2 = w8(z - A.q2);
          a = w8(a - t1);
          bb = w8(bb - t1);
          a2 = w8(a2 - t2);
          b2 = w8(b2 - t2);
          const bool ca = RIGHT ? a >= 0 : a > 0;
          const bool cb_ = RIGHT ? bb >= 0 : bb > 0;
          const bool ca2 = RIGHT ? a2 >= 0 : a2 > 0;
          const bool cb2 = RIGHT ? b2 >= 0 : b2 > 0;
          d |= (ca ? DIR_E_CONT : 0) | (cb_ ? DIR_F_CONT : 0) |
               (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
          Xp[c] = inb ? w8(max(a, 0) - qe) : Xp[c];
          Y[c] = inb ? w8(max(bb, 0) - qe) : Y[c];
          X2[c] = inb ? w8(max(a2, 0) - qe2) : X2[c];
          Y2[c] = inb ? w8(max(b2, 0) - qe2) : Y2[c];
        } else {
          // kernel 6's recurrence (ksw2_exts2_sse.c): the intron
          // candidate with the acceptor, no clamp of z
          const int Dn = DN[c];
          int a2 = w8(X21 + V1);
          const int cand[3] = {a, bb, w8(a2 + AC[c])};
          int z = Sv;
          d = 0;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            d = RIGHT ? (z > cand[i] ? d : i + 1)
                        : (cand[i] > z ? i + 1 : d);
            z = max(z, cand[i]);
          }
          un = w8(z - V1);
          vn = w8(z - Uc);
          const int t1 = w8(z - q);
          a = w8(a - t1);
          bb = w8(bb - t1);
          a2 = w8(a2 - z + A.q2);
          const bool ca = RIGHT ? a >= 0 : a > 0;
          const bool cb_ = RIGHT ? bb >= 0 : bb > 0;
          const bool cd = RIGHT ? a2 >= Dn : a2 > Dn;
          d |= (ca ? DIR_E_CONT : 0) | (cb_ ? DIR_F_CONT : 0) |
               (cd ? DIR_N_CONT : 0);
          Xp[c] = inb ? w8(max(a, 0) - qe) : Xp[c];
          Y[c] = inb ? w8(max(bb, 0) - qe) : Y[c];
          X2[c] = inb ? w8(max(a2, Dn) - A.q2) : X2[c];
        }
        U[c] = inb ? un : U[c];
        V[c] = inb ? vn : V[c];

        if (!APPROX) {
          // the H row (spec/common.py:exact_max_scan) over [st0, en0]:
          // unsigned deltas less q + e one-piece, signed deltas
          // otherwise; seeded with 2 (q + e) one-piece, the PRE-swap
          // q + e two-piece and q + e splice (qe_pre)
          const bool inh = t >= st0 && t <= en0;
          const int vv = ONE ? vn & 255 : vn, uu = ONE ? un & 255 : un;
          const int sub = ONE ? qe : 0;
          const int h = r == 0 ? vv - (ONE ? 2 * qe : A.qe_pre)
                        : t < en0 || en0 == 0 ? H[c] + vv - sub
                                              : Hm + uu - sub;
          H[c] = inh ? h : H[c];
          // the SSE scan's tie rank: the en0 cell, then 4 lane classes
          // over [st0, en1), then the scalar tail; smaller ranks win
          const int rel = t - st0;
          const int en1 = st0 + ((en0 - st0) & ~3);
          const int rank = t == en0 ? 0
                           : t < en1 ? (rel & 3) * KT + rel + 1
                                     : 4 * KT + rel + 1;
          const long long key = (long long)h * 4294967296LL +
                                (long long)(0x7fffffff - rank);
          best = inh && key > best ? key : best;
          if (inh && t == st0) shs[rr] = h;
          if (inh && t == en0) she[rr] = h;
        }
        if (CIG) stage[buf][l] = (uint8_t)(inb ? d : 0);
      }
      if (!APPROX) skey[rr][lane] = best;

      if (CIG) {
        // 16-byte groups lie wholly inside or outside [st, en]; the two
        // stage buffers alternate, so one barrier a diagonal suffices
        __syncwarp();
        if (lane < 2 * NC) {
          const int gs = t0 + 16 * lane;
          if (gs >= st && gs + 15 <= en)
            *reinterpret_cast<uint4*>(pp + off + (gs - st)) =
                *reinterpret_cast<const uint4*>(&stage[buf][16 * lane]);
        }
        buf ^= 1;
        off += en - st + 1;
      }

      if (APPROX) {
        // the H0 walk (ksw2_extz2_sse.c:262-279) on unsigned deltas less
        // q + e one-piece, on signed deltas otherwise: the tile that holds
        // the walk's next cell takes the step
        if (r == 0) {
          const int v0 = __shfl_sync(FULL, V[0], 0);
          H0 = ONE ? (v0 & 255) - 2 * qe : v0 - A.qe_pre;
          lt = 0;
          known = 0;
          if (lane == 0) A.W[db] = pack_walk(H0, lt);
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
              if (c1) d0 = lt >= t0 ? tile_pick<NC>(V, lt - t0) : bvn;
              if (c2) d1 = tile_pick<NC>(U, lt + 1 - t0);
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
              if (lane == 0) A.W[db + r] = pack_walk(H0, lt);
            }
          }
        }
      }

      // lane 31 of the last chunk owns the tile's last position
      if (myb != nullptr && lane == 31)
        sedge[rr] = make_int2((Xp[NC - 1] & 255) | ((V[NC - 1] & 255) << 8) |
                                  (ONE ? 0 : (X2[NC - 1] & 255) << 16),
                              H[NC - 1]);
    }

    // the group's hand-off: its edge entries, one release, then the
    // per-diagonal keys and st0 / en0 H off the chain
    __syncwarp();
    if (myb != nullptr) {
      if (lane < nr) myb[r_lo + lane] = sedge[lane];
      __syncwarp();
      if (lane == 0) st_release(A.progress + g, r_hi);
    }
    if (!APPROX && lane < nr) {
      const int r = r_lo + lane;
      long long key = skey[lane][0];
#pragma unroll 8
      for (int i = 1; i < 32; ++i) key = max(key, skey[lane][i]);
      if (key != LLONG_MIN) atomicMax(A.D + db + r, key);
      const int4 dg = sdiag[lane];
      if (dg.x >= t0 && dg.x <= X) A.hse[db + r].x = shs[lane];
      if (dg.y >= t0 && dg.y <= X) A.hse[db + r].y = she[lane];
    }
    __syncwarp();
    r_lo = r_hi + 1;
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

template <int MODE, bool CIG, bool APPROX, int NC, bool RIGHT>
cudaError_t launch_fwd(const FwdArgs& a, int n_tiles, cudaStream_t stream) {
  // the dynamic part: the score table under GENERIC_SC
  const int smem = a.generic ? 4 * a.m * a.m : 0;
  cudaError_t err = cudaFuncSetAttribute(
      extz_fwd_kernel<MODE, CIG, APPROX, NC, RIGHT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  extz_fwd_kernel<MODE, CIG, APPROX, NC, RIGHT>
      <<<n_tiles, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int NC, bool RIGHT>
cudaError_t launch_tile(const FwdArgs& a, int cig, int approx, int n_tiles,
                        cudaStream_t stream) {
  if (cig)
    return approx
               ? launch_fwd<MODE, true, true, NC, RIGHT>(a, n_tiles, stream)
               : launch_fwd<MODE, true, false, NC, RIGHT>(a, n_tiles, stream);
  return approx
             ? launch_fwd<MODE, false, true, NC, RIGHT>(a, n_tiles, stream)
             : launch_fwd<MODE, false, false, NC, RIGHT>(a, n_tiles, stream);
}

template <int MODE>
cudaError_t launch_mode(const FwdArgs& a, int cig, int approx, int n_tiles,
                        cudaStream_t stream) {
  if (a.right)
    return a.TP == 64
               ? launch_tile<MODE, 2, true>(a, cig, approx, n_tiles, stream)
               : launch_tile<MODE, 1, true>(a, cig, approx, n_tiles, stream);
  return a.TP == 64
             ? launch_tile<MODE, 2, false>(a, cig, approx, n_tiles, stream)
             : launch_tile<MODE, 1, false>(a, cig, approx, n_tiles, stream);
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
  if (B <= 0 || n_tiles <= 0 ||
      (TP != 32 && TP != 64) || mode < MODE_EXTZ ||
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
