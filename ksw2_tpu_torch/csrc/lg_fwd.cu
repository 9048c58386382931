// Single-pair linear-gap and global forwards (kernels 15 and 16): one or
// many pairs, each spread over many blocks in tiles of target positions.
//
// Kernel 15 (MODE_EXTF, counted as extf_fwd) replaces
// ksw2_tpu/ops/wavefront_extf.py:_extf_kernel_body.  It computes what
// spec/diagdiff.py:extf2 specifies (ksw2_extf2_sse.c) for any w >= 0: per
// anti-diagonal r = i + j the Suzuki-Kasahara deltas u, v in wrapping int8
// over the 16-rounded band [st, en], the score bytes filled over [st0,
// st0 + 16 floor((en0 - st0) / 16) + 15] by raw symbol equality (N matches
// N, as in the reference), z = max(s + 2e, v[t - 1]) signed then unsigned
// max with u[t], and the O(1) H0 walk with the X-drop break
// (ksw2_extf2_sse.c:80-91).  A pair stops at its first empty band or at an
// X-drop; both set zdropped ("not completed", ksw2_extf2_sse.c:49).  Score
// only: the 9-field record of ops/records.py (mqe and mte NEG_INF, their
// coordinates -1).  The plain version is ops/batch_extf.py:
// extf_forward_plain.
//
// Kernel 16 (MODE_GG2, counted as gg2_fwd) replaces
// ksw2_tpu/ops/wavefront_gg2.py:_gg2_kernel_body.  It computes what
// spec/diagdiff.py:gg2_sse specifies (ksw2_gg2_sse.c): the deltas u, v, x,
// y over [st, en], the score bytes gathered from the matrix over [st0,
// en0], no unsigned clamp, the direction byte of every cell of [st, en]
// and the O(1) H0 walk to the corner.  No band stops the sweep: all qlen +
// tlen - 1 diagonals run, and a rounded band that is empty leaves its byte
// row zero.  The bytes go to the reference's flat layout
// (ksw2_gg2_sse.c:41-47; ops/batch_gg2.py:flat_layout): pair b's row r at
// pbase[b] + r * n_col, cell t at t - st(r), one zero row after the last
// (the caller zeroes the store), so band_walk.cu's flat form walks it,
// upward overrun included.  The plain version is ops/batch_gg2.py:
// gg2_forward_plain with overrun.
//
// Layout: kernel 12's (extz_fwd.cu; common.cuh's tiles).  The target axis
// of a pair is cut into tiles of TP = 32 NC positions (NC = 1 or 2;
// ops/extz_fwd.py:choose_tp picks it); one warp (one block) owns a tile and
// walks the diagonals on which it meets the band or the score fill.  Lane
// l keeps positions t0 + 32 c + l in registers: u, v and the score byte
// (x, y too for gg2), so the reference's stale bytes persist as they do in
// its rows.  Neighbour t - 1 is one shuffle a plane (v; x and v for gg2),
// the tile's first from the tile before.  Diagonals go in groups of KD,
// aligned on multiples of KD; after a group the tile publishes its last
// position's v (x | v << 8 for gg2) of each of the group's diagonals into
// a per-diagonal history and raises its progress once with release
// semantics; the next tile waits once a group with acquire semantics.
// Blocks take their tile from an atomic ticket in pair, then tile order,
// so a tile waits only on one that runs already.
//
// The H0 walks.  extf's walk depends on values (it compares v[lt] with
// u[lt + 1]), so it runs inside the forward: the tile that holds the
// walk's next cell takes the step and keeps (H0, lt, max, max_t, max_q)
// in registers; when lt reaches the tile's last position it leaves that
// state in a per-diagonal record, and the next tile takes the walk over
// there (at lt = t0 - 1, with v[t0 - 1] from the history).  A step is
// taken in registers, in the groups where the walk may step in the tile
// (a few of each tile's): each lane decides it as if lt were its position
// and a ballot gives the walk's choice.  The X-drop is decided at its
// diagonal: the tile writes the record and raises the pair's stop word,
// which, in a launch with an X-drop, every tile of the pair reads once a
// group and while it waits, and exits on; so a pair that X-drops early
// costs a few groups, not its whole matrix.
//
// gg2's walk follows geometry alone: it stays at lt while lt is in [st0,
// en0] and reads v[lt], else reads u[lt + 1] and steps on
// (ksw2_gg2_sse.c:102-106).  So lt is st0(r) until the band runs off the
// target end (qlen > tlen + w), and from there one more a diagonal, and
// the byte each diagonal reads is known in closed form (gg2_read;
// ops/gg2.py:gg2_walk_reads).  Past u the reads run on through the
// reference's one block of u, v, x, y and s (stride round_up(tlen, 16), s
// 16 bytes longer; 0 past the block: spec/diagdiff.py:_blk_u8).  Each read
// is taken by the tile that owns its position: from its registers at that
// diagonal, from its last registers when the diagonal is past the tile's
// last one, and 0 before its first; a tile adds its reads to the pair's
// score with one atomicAdd (H0 = the reads less (nd + 1)(q + e)).
//
// What bounds it on an H100: the serial chain of a pair's diagonals
// (qlen + tlen - 1, ~100k on a 50 kb pair) through one tile's groups, plus
// the pipeline's fill, one lag a tile, against ~7 integer operations a
// cell for extf and ~13 (+ 11 for the byte) for gg2 (chip_smoke.py: OPS,
// BYTE_OPS) and gg2's bytes.  A chunk step is a chain of dependent selects
// and byte wraps (~140-180 cycles at tiles of 32, chip_smoke.py
// --breakdown lg), so the narrowest tiles spread a long pair over the
// most SMs and run the shortest chain.  A tile lags the one before by one
// group for gg2 but by ~4 for extf, from the first groups of the tile at
// the front of the fill, for a reason not yet found (PERF.md section 7).
#include <climits>
#include <type_traits>

#include "common.cuh"

using namespace ksw2t;
using namespace ksw2t::tiles;

namespace {

constexpr int NEG = -0x40000000;   // NEG_INF of core/flags.py
constexpr unsigned FULL = 0xffffffffu;

// The kernel's forms: linear gap (kernel 15) and global (kernel 16).
constexpr int MODE_EXTF = 0, MODE_GG2 = 1;

struct LgArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const int* table;        // GG2: the m x m score matrix
  const int* tbase;        // (B + 1) first tile of each pair
  const long long* dbase;  // (B) EXTF: first walk record
  const long long* bbase;  // (B) first history entry
  const long long* pbase;  // (B) GG2: first store byte
  int B, Lq, Lt, m, mch, mis, q, e, xdrop;
  int* ticket;
  int* progress;           // per tile: its last published diagonal
  void* bnd;               // the history: v (EXTF, uint8), x | v << 8 (GG2)
  int* wlt;                // EXTF per diagonal: lt after the step when it is
                           // the stepping tile's last position, else -1
  int4* wst;               // EXTF per diagonal: (H0, max, max_t, max_q)
  int* stop;               // EXTF per pair: raised on an X-drop
  int* out;                // EXTF (B, 9) records; GG2 (B) scores, zeroed
  uint8_t* p;              // GG2: the flat store, zeroed
};

// The block index (u at 0, v at NS, x, y, then s) of the byte gg2's H0 walk
// reads on diagonal r of a pair with tlen >= 1 (ops/gg2.py:
// gg2_walk_reads): v[0] at r = 0; with an empty query every band is empty
// and lt = r - 1, so u[r]; once the band has run off the target end
// (r >= 2 tlen + w - 1) u[lt + 1] with lt = r - tlen - w; before, lt is
// st0(r - 1): v[lt] where st0 stays, else u[st0(r)].
__device__ __forceinline__ int gg2_read(int r, int qlen, int tlen, int w,
                                        int NS, int st0, int st0p) {
  if (r == 0) return NS;
  if (qlen <= 0) return r;
  if (r >= 2 * tlen + w - 1) return r - tlen - w + 1;
  return st0 == st0p ? NS + st0p : st0;
}

// An int8 value in the top byte of an int32 (v << 24): the planes' form.
// Sums and differences in that form wrap as the reference's epi8 ones do
// (taken in unsigned arithmetic, where wrapping is defined), signed
// compares are the int8 ones, and unsigned compares the epu8 ones.
__device__ __forceinline__ int top(int v) { return (int)((unsigned)v << 24); }
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int u8(int v) { return (int)((unsigned)v >> 24); }

template <int NC>
__device__ __forceinline__ int plane_pick(int pl, int li, const int (&U)[NC],
                                          const int (&V)[NC],
                                          const int (&Xp)[NC],
                                          const int (&Y)[NC],
                                          const int (&S)[NC]) {
  int a[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    a[c] = pl == 0 ? U[c] : pl == 1 ? V[c] : pl == 2 ? Xp[c]
         : pl == 3 ? Y[c] : S[c];
  return tile_pick<NC>(a, li);
}

template <int MODE, int NC>
__global__ void __launch_bounds__(32) lg_fwd_kernel(const LgArgs A) {
  constexpr bool GG = MODE == MODE_GG2;
  constexpr int TP = 32 * NC;
  constexpr int QW = (TP + KD - 1 + 31) / 32;   // query bases a lane loads
  using Ent = typename std::conditional<GG, uint16_t, uint8_t>::type;
  // a group's query window and direction bytes (GG2), the tile before's
  // entries [r_lo - 1, r_hi], this tile's edge entries and, EXTF, the
  // walk's lt after each diagonal before the group's
  __shared__ uint8_t qwin[TP + KD];
  __shared__ __align__(16) uint8_t stage[GG ? KD : 1][GG ? TP : 16];
  __shared__ Ent sprev[KD + 1];
  __shared__ int4 sdiag[KD];   // st0, en0, fill end (EXTF) or the walk's
                               // read here (GG2), colv << 24 | prevok
  __shared__ int2 sbnd[KD];    // position t0 - 1 before the diagonal (x, v;
                               // EXTF: v and v after it), top-byte form
  __shared__ Ent sedge[KD];
  __shared__ int swlt[KD];
  extern __shared__ int stab[];   // GG2: the m x m matrix
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
  const int nd = qlen + tlen - 1;
  const int e = A.e, qe = A.q + A.e;
  if (GG ? tlen <= 0 : qlen <= 0 || tlen <= 0) {
    // EXTF: ksw_reset_extz; GG2: no cell, every read 0, H0 = -(nd + 1)(q +
    // e) (0 with no diagonal)
    if (k == 0 && lane == 0) {
      if (GG) {
        if (nd >= 1) atomicAdd(A.out + b, -(nd + 1) * qe);
      } else {
        int* o = A.out + (size_t)b * 9;
        o[0] = 0; o[1] = -1; o[2] = -1; o[3] = NEG; o[4] = -1;
        o[5] = NEG; o[6] = -1; o[7] = NEG; o[8] = 0;
      }
    }
    return;
  }
  const int rlim = GG ? nd : first_empty_diag(qlen, tlen, w);
  const int rA = tile_first(t0, w), rB = tile_last(t0, TP, qlen, w, rlim);
  const long long spin_limit = SPIN_BASE + SPIN_DIAG * rlim;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  const int NS = (tlen + 15) & ~15;        // GG2: the block's stride
  const int ncol = ((min(w + 1, tlen) + 15) / 16 + 1) * 16;
  const long long db = GG ? 0 : A.dbase[b];
  // EXTF with an X-drop: the pair's stop word (no other run raises it)
  const int* stopw = GG || A.xdrop < 0 ? nullptr : A.stop + b;
  // the cell's constants in top-byte form
  const int twoS = top(GG ? 2 * qe : 2 * e), qS = top(A.q);
  const int mchS = top(A.mch), misS = top(A.mis);
  if (GG)
    for (int i = lane; i < A.m * A.m; i += 32) stab[i] = top(A.table[i]);

  // lane l's state: position t0 + 32 c + l in chunk c's registers, planes
  // in top-byte form
  int U[NC], V[NC], Xp[NC], Y[NC], S[NC], TG[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int t = t0 + 32 * c + lane;
    U[c] = V[c] = Xp[c] = Y[c] = S[c] = 0;
    TG[c] = t < tlen ? tg[t] : 0;
  }

  // the tile before this one: its history and the diagonals it computes
  const Ent* prevb = nullptr;
  int pA = 0, pB = -1;
  if (k > 0) {
    prevb = static_cast<const Ent*>(A.bnd) + A.bbase[b] +
            (long long)(k - 1) * rlim;
    pA = tile_first(t0 - TP, w);
    pB = tile_last(t0 - TP, TP, qlen, w, rlim);
  }
  Ent* myb = k + 1 < ntiles
                 ? static_cast<Ent*>(A.bnd) + A.bbase[b] + (long long)k * rlim
                 : nullptr;
  int seen = -1;                           // the tile before's progress
  // EXTF: the walk, held by this tile from the diagonal it enters (hold)
  // to the one it leaves (gone); GG2: this tile's share of its reads
  bool hold = false, gone = false;
  int H0 = 0, lt = 0, mx = 0, mt = -1, mq = -1;
  int acc = 0;
  uint8_t* pp = GG ? A.p + A.pbase[b] : nullptr;

  for (int r_lo = rA; r_lo <= rB;) {
    const int r_hi = min(r_lo - r_lo % KD + KD - 1, rB);
    const int nr = r_hi - r_lo + 1;
    // EXTF: the pair's stop word, read once a group: another tile has
    // X-dropped the pair
    int quit = 0;
    if (stopw != nullptr && lane == 0) quit = ld_relaxed(stopw);
    // what the group needs besides the tile before, issued before the
    // wait so that its loads overlap it: the query bases its cells read
    // (r - t for r in the group) and, a lane a diagonal, its band row
    const int qb = r_lo - X;
    int qv[QW];
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const int qi = qb + lane + 32 * i;
      qv[i] = lane + 32 * i < TP + KD - 1 && qi >= 0 && qi < qlen ? qy[qi]
                                                                 : 0;
    }
    int4 dgv = make_int4(0, 0, 0, 0);
    bool edge_in = false;                  // t0 in the rounded band
    if (lane < nr) {
      const int r = r_lo + lane;
      const BandRow bd = band_row(r, qlen, tlen, w);
      bool prevok = false;
      int st0p = 0;
      if (r > 0) {
        const BandRow bp = band_row(r - 1, qlen, tlen, w);
        prevok = bd.st > 0 && bp.st <= bd.st - 1 && bd.st - 1 <= bp.en;
        st0p = bp.st0;
      }
      int z;
      if (GG) {
        // the row width (never: n_col holds w + 1 positions and 16 more)
        if (bd.st <= bd.en && bd.en - bd.st + 1 > ncol) __trap();
        // the walk's read: plane << 8 | local position, when it is here
        int f = gg2_read(r, qlen, tlen, w, NS, bd.st0, st0p), pl = 0;
        while (pl < 4 && f >= NS) {
          f -= NS;
          ++pl;
        }
        z = (pl < 4 || f < NS + 16) && f >= t0 && f <= X
                ? pl << 8 | (f - t0) : -1;
      } else {
        // the 16-byte score fill's end (ksw2_extf2_sse.c:66-72)
        z = bd.st0 + ((bd.en0 - bd.st0) & ~15) + 15;
      }
      // the first column's v (t == r): q for gg2 (0 at r = 0), 0 for extf
      const int colv = GG && r ? qS : 0;
      dgv = make_int4(bd.st0, bd.en0, z, colv | (prevok ? 1 : 0));
      edge_in = t0 >= bd.st && t0 <= bd.en;
    }
    int cb = 0, wl = -1;
    if (k > 0) {
      // one wait a group: lane 0 spins (acquire) until the tile before has
      // released every diagonal this group reads of it (EXTF: v after r
      // too, for the walk); it runs already (its ticket came first), so
      // the wait ends, and one past the pair's spin limit is a fault
      const int need = min(GG ? r_hi - 1 : r_hi, pB);
      if (need >= pA && need > seen) {
        int pv = seen;
        if (lane == 0) {
          const int* pg = A.progress + g - 1;
          const long long t_start = clock64();
          unsigned nap = 16;
          while ((pv = ld_acquire(pg)) < need) {
            if (stopw != nullptr && ld_relaxed(stopw)) {
              quit = 1;
              break;
            }
            if (clock64() - t_start > spin_limit) __trap();
            __nanosleep(nap);
            nap = min(2 * nap, SPIN_SLEEP_MAX);
          }
        }
        __syncwarp();                       // orders the reads below
        seen = __shfl_sync(FULL, pv, 0);
      }
      // [cb, ce]: the entries the group reads (e0 = min(r - 1, pB) and,
      // EXTF, e1 = min(r, pB)); after the tile before's last diagonal only
      // its last entry
      cb = max(min(r_lo - 1, pB), pA);
      const int ce = min(min(r_hi, pB), seen);
      for (int j = lane; j <= ce - cb; j += 32)
        sprev[j] = __ldcg(prevb + cb + j);
      // EXTF: where the walk stood after each diagonal before the group's,
      // when the tile before held it at its last position
      if (!GG && !hold && !gone && lane < nr && r_lo + lane > 0)
        wl = __ldcg(A.wlt + db + r_lo + lane - 1);
    }
    if (!GG && __shfl_sync(FULL, quit, 0)) return;
#pragma unroll
    for (int i = 0; i < QW; ++i)
      if (lane + 32 * i < TP + KD - 1) qwin[lane + 32 * i] = (uint8_t)qv[i];
    // whether the walk may step in this tile during the group (EXTF: it
    // holds the walk, or the walk starts here, or the tile before holds it
    // at its last position) or read here (GG2)
    const bool walk = GG ? __any_sync(FULL, dgv.z >= 0 && lane < nr)
                         : hold || r_lo == 0 ||
                               (k > 0 && __any_sync(FULL, wl == t0 - 1));
    if (lane < nr) {
      sdiag[lane] = dgv;
      if (!GG) swlt[lane] = wl;
    }
    __syncwarp();
    // position t0 - 1 before each diagonal (EXTF: and v after it): the
    // tile before's entry of min(r - 1, its last diagonal); 0 before its
    // first
    if (lane < nr) {
      const int r = r_lo + lane;
      int b0 = 0, b1 = 0;
      if (k > 0 && edge_in) {
        const int e0 = min(r - 1, pB), e1 = min(r, pB);
        if (e0 >= pA) b0 = sprev[e0 - cb];
        if (!GG && e1 >= pA) b1 = sprev[e1 - cb];
      }
      sbnd[lane] = GG ? make_int2(top(b0), top(b0 >> 8))
                      : make_int2(top(b0), top(b1));
    }
    __syncwarp();

    // the group's diagonals; WALK: the walk's step (EXTF) or one of its
    // reads (GG2) may fall in this tile during the group, which is so for
    // a few groups of each tile, and the other groups carry no walk code
    auto diagonals = [&](auto walk_) -> bool {
      constexpr bool WALK = decltype(walk_)::value;
      // unrolled: a diagonal's loads and score bytes overlap the chain of
      // the one before
#pragma unroll 4
      for (int rr = 0; rr < nr; ++rr) {
        const int r = r_lo + rr;
        const int4 dg = sdiag[rr];
        const int st0 = dg.x, en0 = dg.y, st = st0 & ~15, en = en0 | 15;
        const int colv = dg.w & ~1;
        const bool prevok = dg.w & 1;
        const int2 bw = sbnd[rr];
        // the old state of t - 1 for lane 0: the boundary, then each
        // chunk's lane 31 (a rotation by one lane gives it to lane 0)
        int cX = GG ? bw.x : 0, cV = GG ? bw.y : bw.x;
        // a tile inside [st0, en0] and past the first column has no cell at
        // an edge of the band or past the fill: most tile-diagonals
        const bool interior = st0 < t0 && X < en0 && r > X;
        // every chunk, straight-line: a cell outside the band keeps its
        // state (selects, not branches), so the chunks' chains interleave
        auto cells = [&](auto in_) {
          constexpr bool IN = decltype(in_)::value;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int l = 32 * c + lane;
            const int t = t0 + l;
            const int src = (lane + 31) & 31;
            const bool l0 = lane == 0;
            const int sV = __shfl_sync(FULL, V[c], src);
            const int sX = GG ? __shfl_sync(FULL, Xp[c], src) : 0;
            const int Vm = l0 ? cV : sV, Xm = l0 ? cX : sX;
            // lane 0 now holds lane 31's old state: the next chunk's t - 1
            cV = sV;
            cX = sX;

            const int T = TG[c];
            const int Q = qwin[rr + TP - 1 - l];
            // (gg2's rounded band and its fill may be empty)
            const bool inb = IN || (t >= st && t <= en);
            const bool edge = !IN && t == st && !prevok;
            const int V1 = edge ? (st == 0 ? colv : 0) : Vm;
            const int Uc = !IN && t == r ? colv : U[c];
            int un, vn;
            if (GG) {
              // ksw2_gg2_sse.c:60-95: the first-column presets u[r] = q (0
              // at r = 0), y[r] = 0, and x[st - 1], v[st - 1] only when the
              // previous band covered st - 1
              const bool fill = IN || (t >= st0 && t <= en0);
              const int Sv = fill ? stab[T * A.m + Q] : S[c];
              S[c] = Sv;
              const int X1 = edge ? 0 : Xm;
              const int Yc = !IN && t == r ? 0 : Y[c];
              const int zz = wadd(Sv, twoS);
              const int a = wadd(X1, V1), bb = wadd(Yc, Uc);
              int d = a > zz ? DIR_E : 0;
              int z = max(a, zz);
              d = bb > z ? DIR_F : d;
              z = (int)max((unsigned)z, (unsigned)bb);  // max_epu8, no clamp
              un = wsub(z, V1);
              vn = wsub(z, Uc);
              const int z2 = wsub(z, qS);
              const int a2 = wsub(a, z2), b2 = wsub(bb, z2);
              d |= (a2 > 0 ? DIR_E_CONT : 0) | (b2 > 0 ? DIR_F_CONT : 0);
              Xp[c] = inb ? max(a2, 0) : Xp[c];
              Y[c] = inb ? max(b2, 0) : Y[c];
              stage[rr][l] = (uint8_t)d;
            } else {
              // ksw2_extf2_sse.c:66-79: u[r] = 0 at the first column, v[st
              // - 1] only when the previous band covered st - 1
              const bool fill = IN || (t >= st0 && t <= dg.z);
              const int Sv = fill ? (T == Q ? mchS : misS) : S[c];
              S[c] = Sv;
              int z = max(wadd(Sv, twoS), V1);            // signed max
              z = (int)max((unsigned)z, (unsigned)Uc);    // max_epu8
              un = wsub(z, V1);
              vn = wsub(z, Uc);
            }
            U[c] = inb ? un : U[c];
            V[c] = inb ? vn : V[c];
          }
        };
        if (interior)
          cells(std::true_type{});
        else
          cells(std::false_type{});

        // the walk's step (EXTF) or read (GG2), when it may fall here
        if (WALK && GG) {
          if (dg.z >= 0)
            acc += u8(plane_pick<NC>(dg.z >> 8, dg.z & 255, U, V, Xp, Y, S));
        } else if (WALK) {
          // the H0 walk (ksw2_extf2_sse.c:80-91) on unsigned deltas less
          // e: the tile that holds the walk's next cell takes the step.
          // Each lane decides the step as if lt were its position (v there
          // against u one position on, a shuffle away) and the ballot of
          // those choices gives the walk's in registers, off the cells'
          // chain: the next diagonal's cells do not wait for it.
          unsigned stay[NC];
          int dl[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int p = t0 + 32 * c + lane;
            const int un = __shfl_sync(FULL, U[c], (lane + 1) & 31);
            // lane 31's next position is the next chunk's lane 0 (past the
            // tile: never read, the walk leaves first)
            const int unc =
                c + 1 < NC ? __shfl_sync(FULL, U[c + 1 < NC ? c + 1 : c], 0)
                           : 0;
            const int d0 = u8(V[c]) - e;
            const int d1 = u8(lane < 31 ? un : unc) - e;
            const bool c1 = st0 <= p && p <= en0;
            const bool c2 = st0 <= p + 1 && p + 1 <= en0;
            const bool s = c1 && (!c2 || d0 > d1);
            stay[c] = __ballot_sync(FULL, s);
            dl[c] = s ? d0 : d1;
          }
          bool stepped = false;
          if (r == 0) {                    // tile 0 only
            H0 = u8(__shfl_sync(FULL, V[0], 0)) - 2 * e;
            lt = 0;
            hold = stepped = true;
          } else {
            // the walk enters at lt = t0 - 1, the tile before's last
            // position, when lt + 1 is in the band
            if (k > 0 && !hold && !gone && swlt[rr] == t0 - 1 &&
                t0 >= st0 && t0 <= en0) {
              const int4 ws = __ldcg(A.wst + db + r - 1);
              H0 = ws.x;
              mx = ws.y;
              mt = ws.z;
              mq = ws.w;
              lt = t0 - 1;
              hold = true;
            }
            if (hold) {
              const bool c2 = st0 <= lt + 1 && lt + 1 <= en0;
              if (c2 && lt + 1 > X) {
                hold = false;              // the next tile takes it on
                gone = true;
              } else if (lt < t0) {
                // at t0 - 1: its v after r comes with the history
                const bool c1 = st0 <= lt && lt <= en0;
                const int d0 = u8(bw.y) - e;
                const int d1 = u8(__shfl_sync(FULL, U[0], 0)) - e;
                if (c1 && (!c2 || d0 > d1)) {
                  H0 += d0;
                } else {
                  H0 += d1;
                  ++lt;
                }
                stepped = true;
              } else {
                const int j = lt - t0;
                unsigned sm = stay[0];
#pragma unroll
                for (int c = 1; c < NC; ++c)
                  if (c == j >> 5) sm = stay[c];
                H0 += tile_pick<NC>(dl, j);
                lt += (sm >> (j & 31)) & 1 ? 0 : 1;
                stepped = true;
              }
            }
          }
          if (stepped) {
            bool drop = false;
            if (r > 0) {
              if (H0 > mx) {
                mx = H0;
                mt = lt;
                mq = r - lt;
              } else {
                drop = A.xdrop >= 0 && mx - H0 > A.xdrop;
              }
            }
            if (drop || r == rlim - 1) {
              if (lane == 0) {
                const int zd = drop || rlim < nd;
                int* o = A.out + (size_t)b * 9;
                o[0] = mx; o[1] = mt; o[2] = mq; o[3] = NEG; o[4] = -1;
                o[5] = NEG; o[6] = -1; o[7] = zd ? NEG : H0; o[8] = zd;
                if (drop) atomicExch(A.stop + b, 1);
              }
              if (drop) return true;       // every tile of the pair exits
            } else if (lt == X && lane == 0) {
              // the next tile may take the walk over at r + 1
              A.wst[db + r] = make_int4(H0, mx, mt, mq);
              A.wlt[db + r] = lt;
            }
          }
        }

        // lane 31 of the last chunk owns the tile's last position
        if (myb != nullptr && lane == 31)
          sedge[rr] = GG ? (Ent)(u8(Xp[NC - 1]) | u8(V[NC - 1]) << 8)
                         : (Ent)u8(V[NC - 1]);
      }
      return false;
    };
    if (walk ? diagonals(std::true_type{}) : diagonals(std::false_type{}))
      return;

    // the group's hand-off: its edge entries, then one release
    __syncwarp();
    if (myb != nullptr) {
      if (lane < nr) myb[r_lo + lane] = sedge[lane];
      __syncwarp();
      if (lane == 0) st_release(A.progress + g, r_hi);
    }
    if (GG) {
      // the group's direction bytes, off the chain: 16-byte groups lie
      // wholly inside or outside [st, en]
      for (int i = lane; i < nr * 2 * NC; i += 32) {
        const int j = i / (2 * NC), gs = t0 + 16 * (i % (2 * NC));
        const int4 dg = sdiag[j];
        const int st = dg.x & ~15, en = dg.y | 15;
        if (gs >= st && gs + 15 <= en)
          *reinterpret_cast<uint4*>(pp + (long long)(r_lo + j) * ncol +
                                    (gs - st)) =
              *reinterpret_cast<const uint4*>(&stage[j][gs - t0]);
      }
    }
    __syncwarp();
    r_lo = r_hi + 1;
  }

  if (GG) {
    // the reads past this tile's last diagonal: only where the walk runs
    // off (block index r + c0 from diagonal R0 on), from the last registers
    const int c0 = qlen <= 0 ? 0 : 1 - tlen - w;
    const int R0 = qlen <= 0 ? 1 : 2 * tlen + w - 1;
    int s = 0;
    if (R0 < nd) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int t = t0 + 32 * c + lane;
#pragma unroll
        for (int pl = 0; pl < 5; ++pl) {
          const int rf = pl * NS + t - c0;
          if (t < (pl < 4 ? NS : NS + 16) && rf >= R0 && rf > rB && rf < nd) {
            const int v = pl == 0 ? U[c] : pl == 1 ? V[c] : pl == 2 ? Xp[c]
                        : pl == 3 ? Y[c] : S[c];
            s += u8(v);
          }
        }
      }
    }
    acc += __reduce_add_sync(FULL, s);
    if (k == 0 && nd >= 1) acc -= (nd + 1) * qe;
    if (lane == 0 && acc != 0) atomicAdd(A.out + b, acc);
  }
}

template <int MODE>
cudaError_t launch(const LgArgs& a, int TP, int n_tiles, cudaStream_t stream) {
  // the dynamic part: the score matrix (GG2)
  const int smem = MODE == MODE_GG2 ? 4 * a.m * a.m : 0;
  if (TP == 64) {
    cudaError_t err = cudaFuncSetAttribute(
        lg_fwd_kernel<MODE, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    lg_fwd_kernel<MODE, 2><<<n_tiles, 32, smem, stream>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        lg_fwd_kernel<MODE, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    lg_fwd_kernel<MODE, 1><<<n_tiles, 32, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Kernel 15: the (B, 9) records `rec`; ticket (zeroed), progress (n_tiles,
// -1), bnd (uint8 history), wlt (-1) and wst (int4) a diagonal, stop (B,
// zeroed), laid out by ops/lg_tiles.py:lg_layout and ctl_offsets.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_extf_fwd(const void* qs, const void* ts,
                              const void* qlen, const void* tlen,
                              const void* w, const void* tbase,
                              const void* dbase, const void* bbase, int B,
                              int Lq, int Lt, int mch, int mis, int e,
                              int xdrop, int TP, int n_tiles, void* ticket,
                              void* progress, void* bnd, void* wlt,
                              void* wst, void* stop, void* rec,
                              void* stream) {
  if (B <= 0 || n_tiles <= 0 || (TP != 32 && TP != 64) || ticket == nullptr ||
      progress == nullptr || bnd == nullptr || wlt == nullptr ||
      wst == nullptr || stop == nullptr || rec == nullptr)
    return (int)cudaErrorInvalidValue;
  LgArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
           (const int*)tlen, (const int*)w, nullptr, (const int*)tbase,
           (const long long*)dbase, (const long long*)bbase, nullptr, B, Lq,
           Lt, 0, mch, mis, 0, e, xdrop, (int*)ticket, (int*)progress, bnd,
           (int*)wlt, (int4*)wst, (int*)stop, (int*)rec, nullptr};
  return (int)launch<MODE_EXTF>(a, TP, n_tiles, (cudaStream_t)stream);
}

// Kernel 16: the (B) corner scores `score` (zeroed) and the flat store `p`
// (zeroed; pair b's at pbase[b]); ticket (zeroed), progress (n_tiles, -1)
// and bnd (uint16 history), laid out by ops/lg_tiles.py:lg_layout and
// ctl_offsets.
extern "C" int ksw2t_gg2_fwd(const void* qs, const void* ts,
                             const void* qlen, const void* tlen,
                             const void* w, const void* table,
                             const void* tbase, const void* bbase,
                             const void* pbase, int B, int Lq, int Lt, int m,
                             int q, int e, int TP, int n_tiles, void* ticket,
                             void* progress, void* bnd, void* score, void* p,
                             void* stream) {
  if (B <= 0 || n_tiles <= 0 || (TP != 32 && TP != 64) || ticket == nullptr ||
      progress == nullptr || bnd == nullptr || score == nullptr ||
      p == nullptr || m <= 0)
    return (int)cudaErrorInvalidValue;
  LgArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
           (const int*)tlen, (const int*)w, (const int*)table,
           (const int*)tbase, nullptr, (const long long*)bbase,
           (const long long*)pbase, B, Lq, Lt, m, 0, 0, q, e, 0,
           (int*)ticket, (int*)progress, bnd, nullptr, nullptr, nullptr,
           (int*)score, (uint8_t*)p};
  return (int)launch<MODE_GG2>(a, TP, n_tiles, (cudaStream_t)stream);
}
