// Strips forward: the row-major extension DP (extz, extd and exts, exact
// max).
//
// Replaces ksw2_tpu/ops/wavefront_strips.py:_kernel_body (one-piece,
// `two` and `spl` forms, score and `cig`).  It computes what spec/
// strips.py:strips_forward, spec/strips_extd.py:strips_forward_extd and
// spec/strips_cigar.py (strips_exts_cigar for SPL) specify: per global
// diagonal r = i + j the packed (H, merge key) maximum D[r], the
// query-end H Dq[r], the last-row H hl[j], and with CIG the reference's
// direction byte for every cell, row-major, d8[b][i][j] (7-bit bytes for
// two-piece costs).
//
// Layout: a warp owns a strip of STRIP = 128 query columns of one pair,
// lane l columns 4l .. 4l + 3, and walks the pair's target rows with the
// strip's state in registers (H of the previous row, E, E2 or NI, the
// query symbols).  Within a row the F dependency is broken by the
// prefix-max substitution
//   F(i,j) = max(seed, max_{k<j} A(k)) - j*e,  A(k) = Hnof_c(i,k) + k*e - q
// (spec/strips.py:17-21): a lane folds its 4 columns, one warp scan
// (5 shuffles) combines the lanes, and `run`, the prefix through the
// strip's last column, is what the next strip needs.  So strip s computes
// row i once strip s - 1 has published its row-i edge: H(i, j0 - 1) and
// the run of each chain.  The edges go through a ring of K rows in the
// consumer's shared memory with one progress word a strip (release by
// the producer's lane 31, acquire by the consumer's lane 0) and one
// "read" word back, released every FREE rows, for the ring's reuse; there
// is no block barrier in the row loop, so the strips of a pair run as a
// pipeline a row apart.  H(i - 1, j0 - 1), the first column's diagonal
// input, is the edge of the row before.  Strip 0 takes the boundary
// column col_h / col_h2.  The words are accessed by shared-memory address
// (a release at cluster scope waits for the warp's outstanding writes, so
// one to another block covers PUB rows).
//
// Blocks: a host table (ops/strips.py:strips_layout) gives each warp of
// the launch its (pair, strip).  A pair's strips are consecutive warps of
// one cluster of `cl` blocks of `nw` warps; short pairs share a block,
// a long one spans the blocks of a cluster, and the edge from a block's
// last warp to the next block's first goes through distributed shared
// memory (the ring and its words live in the consumer's block).
//
// Diagonal maxima: each lane keeps the running maximum of the 4
// diagonals its cells touch (acc[c] is diagonal i + j0 + c at row i);
// after a row the window moves one diagonal left across the warp, and the
// diagonal leaving the strip's first column is final for this strip:
// 32 rows' of them are folded into D with one atomicMax a lane (one a
// row cost the score forms 8-12%).  The packed value
// H * KB + (KB - 1 - merge_key) is unique per cell, so the order of the
// strips' maxima does not change D; the key takes a short closed form in
// the strips whose columns are all >= 4 and inside the pair.  Dq and hl
// are single writes; the direction bytes of a lane's 4 cells go out as
// one 32-bit store, so a strip's row is 128 contiguous bytes of d8.
//
// Two-piece rows (TWO) chain three scans: A for F; F gives Hc1 =
// min(max(hnof, F), cv) and A2 = Hc1 + j*e2 - q2 for F2; H =
// min(max(Hc1, F2), cv).  The chains decouple because e >= e2 after the
// swap (spec/strips_extd.py).  With CIG a third scan over A3 = H + j*e - q
// gives Fb, the DP's own F for the bytes.  Splice rows (SPL) carry the
// intron state NI (no decay), take the row's donor and acceptor values,
// let cand3 = NI + acceptor(i) into hnof, have no per-cell clamp, and
// their bytes take code 3 and bit 0x20 (wavefront_strips.py:313-347).
//
// What bounds it on an H100: a strip-row's dependent chain in one warp
// (~1,300 cycles whale CIG: the cells' passes, 1-3 warp scans, the edge's
// hand-off), not the integer rate: a launch has about one warp a
// scheduler (chip_smoke.py --breakdown strips).  RIGHT is a template
// parameter: a runtime branch cost 8% of a CIG row.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace ksw2t;
namespace cg = cooperative_groups;

namespace {

constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int STRIP = 128;      // query columns a warp owns
constexpr int MAXW = 16;        // warps of a block (ops/strips.py MAX_WARPS)
constexpr int MAX_CLUSTER = 8;  // blocks of a cluster (the portable limit)
constexpr int K = 32;           // rows of an edge ring (a power of two)
constexpr int FREE = 8;         // rows the warp after reads between its
                                // releases of the ring's entries
constexpr int POLLS = 256;      // reads of a progress word before a wait
                                // starts to sleep
constexpr int PUB = 8;          // rows between releases to another block

struct Smem {
  int tab[64];         // score of (target symbol, query symbol), m <= 8
  int prog[MAXW];      // rows the warp before has put in ring[w]
  int cons[MAXW];      // rows the warp after has read of this warp's edge
  int4 ring[MAXW][K];  // (H, run, run2, run3) at the warp before's last
                       // column, row i in entry i % K
};

// The hand-off words and ring entries by their shared-memory addresses
// (32 bits; a peer block's through mapa), so that no access goes through
// a generic address.  `cluster` gives an access cluster scope: the other
// side is in another block of the cluster.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ int ld_acq(uint32_t a, bool cluster) {
  int v;
  if (cluster)
    asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(a)
                 : "memory");
  else
    asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(a)
                 : "memory");
  return v;
}

__device__ __forceinline__ void st_rel(uint32_t a, int v, bool cluster) {
  if (cluster)
    asm volatile("st.release.cluster.shared::cluster.b32 [%0], %1;" ::"r"(a),
                 "r"(v)
                 : "memory");
  else
    asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(a), "r"(v)
                 : "memory");
}

__device__ __forceinline__ void st_entry(uint32_t a, int4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// One lane spins (acquire) until the word at `a` >= need and returns
// what it read: POLLS reads back to back (the strip before is a row
// apart, and a sleep outlasts a row), then reads with sleeps between
// them.  A wait past `limit` cycles is a fault: trap, do not hang.
__device__ __forceinline__ int spin_until(uint32_t a, int need, bool cluster,
                                          long long limit) {
  int v = ld_acq(a, cluster);
  for (int k = 0; k < POLLS && v < need; ++k) v = ld_acq(a, cluster);
  if (v >= need) return v;
  const long long t0 = clock64();
  unsigned nap = 16;
  while ((v = ld_acq(a, cluster)) < need) {
    if (clock64() - t0 > limit) __trap();
    __nanosleep(nap);
    nap = min(2 * nap, tiles::SPIN_SLEEP_MAX);
  }
  return v;
}

// Inclusive prefix max over the warp's lanes.
__device__ __forceinline__ int warp_scan_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, n);
  }
  return v;
}

// The lane's prefix entering its first column: the warp scan of the lane
// maxima `lmax` seeded by `edge` (lane 0's), and in `out` the prefix
// through the lane's last column (lane 31's is the strip's).
__device__ __forceinline__ int chain_in(int lmax, int edge, int lane,
                                        int& out) {
  out = warp_scan_max(lane == 0 ? max(lmax, edge) : lmax, lane);
  const int prev = __shfl_up_sync(FULL, out, 1);
  return lane == 0 ? edge : prev;
}

template <bool CIG, bool TWO, bool SPL, bool RIGHT>
__global__ void __launch_bounds__(MAXW * 32)
strips_fwd_kernel(const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ ts,
                  const int* __restrict__ qlens,
                  const int* __restrict__ tlens,
                  const int* __restrict__ table,
                  const int16_t* __restrict__ dons,
                  const int16_t* __restrict__ accs,
                  const int2* __restrict__ wtab, int Lq, int tv, int m,
                  int q, int e, int q2, int e2, int lt, int ld, int mat0,
                  int kb, int nw, int cl, int* __restrict__ D,
                  int* __restrict__ Dq, int* __restrict__ hl,
                  uint8_t* __restrict__ d8) {
  static_assert(!(TWO && SPL), "two-piece and splice rows are exclusive");
  __shared__ Smem S;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rank = (int)(blockIdx.x % cl);
  const int g = rank * nw + w;  // the warp's place in its cluster
  const int2 ent = wtab[(size_t)(blockIdx.x / cl) * cl * nw + g];
  const int p = ent.x, s = ent.y;
  const int nd = Lq + tv;

  for (int k = threadIdx.x; k < m * m; k += blockDim.x) S.tab[k] = table[k];
  if (threadIdx.x < nw) {
    S.prog[threadIdx.x] = 0;
    S.cons[threadIdx.x] = 0;
  }
  int qlen = 0, tlen = 0, ns = 0;
  if (p >= 0) {
    // the pair's records start as "no value", shared among its strips
    qlen = qlens[p];
    tlen = tlens[p];
    ns = (qlen + STRIP - 1) / STRIP;
    for (int r = s * 32 + lane; r < nd; r += ns * 32) {
      D[(size_t)p * nd + r] = SENT;
      if (r < qlen - 1 || r >= qlen - 1 + tlen) Dq[(size_t)p * nd + r] = SENT;
    }
    for (int j = qlen + s * 32 + lane; j < Lq; j += ns * 32)
      hl[(size_t)p * Lq + j] = SENT;
  }
  if (cl > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  if (p >= 0) {
    const int gapoe = q + e, gapoe2 = q2 + e2;
    const int qlen1 = qlen - 1, tlen1 = tlen - 1;
    // H(i, -1) and H(-1, i) (SPL: e2 = 0)
    auto bnd = [&](int i) {
      return TWO || SPL ? col_h2(i, gapoe, e, e2, lt, ld)
                        : col_h(i, gapoe, e);
    };
    const long long limit = tiles::SPIN_BASE + tiles::SPIN_DIAG * tlen;
    const int j0 = s * STRIP + 4 * lane;

    // the edge in (from warp g - 1) and out (to warp g + 1)
    const bool has_in = s > 0, has_out = s < ns - 1;
    const bool in_remote = has_in && (g - 1) / nw != rank;
    const bool out_remote = has_out && (g + 1) / nw != rank;
    const int4* ring_in = S.ring[w];
    const uint32_t prog_in = smem_addr(&S.prog[w]);
    const uint32_t cons_in = smem_addr(&S.cons[w]);
    uint32_t cons_up = 0, ring_out = 0, prog_out = 0;
    const int pub_mask = out_remote ? PUB - 1 : 0;
    if (has_in) {  // the producer's `cons` word
      cons_up = smem_addr(&S.cons[(g - 1) % nw]);
      if (in_remote) cons_up = peer_addr(cons_up, (g - 1) / nw);
    }
    if (has_out) {
      ring_out = smem_addr(&S.ring[(g + 1) % nw][0]);
      prog_out = smem_addr(&S.prog[(g + 1) % nw]);
      if (out_remote) {
        ring_out = peer_addr(ring_out, (g + 1) / nw);
        prog_out = peer_addr(prog_out, (g + 1) / nw);
      }
    }

    // the lane's columns: query symbols, j*e (j*e2), the merge key's
    // distance to the query end, and the virtual row -1
    int qc[4] = {0, 0, 0, 0}, je[4], je2[4], a[4], jc[4];
    int H[4], E[4], E2[4], NI[4], acc[4];
    if (j0 < Lq) {
      const uchar4 v =
          *reinterpret_cast<const uchar4*>(qs + (size_t)p * Lq + j0);
      qc[0] = v.x;
      qc[1] = v.y;
      qc[2] = v.z;
      qc[3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      je[c] = j * e;
      je2[c] = j * e2;
      a[c] = qlen1 - j;
      jc[c] = min(j, 4);
      const int h0 = bnd(j);
      H[c] = h0;
      E[c] = h0 - gapoe;
      E2[c] = h0 - gapoe2;
      NI[c] = h0 - q2;
      acc[c] = SENT;
    }
    // the short merge key needs j >= 4 and every column in the pair: the
    // strips but the first and a partial last one (a choice for the whole
    // warp, so no lane takes a longer path alone)
    const bool short_key = s > 0 && STRIP * (s + 1) <= qlen;
    const int dq_c = qlen1 - j0;           // the query end's column, 0..3
    int prev_h = s == 0 ? 0 : bnd(s * STRIP - 1);  // H(i - 1, j0s - 1)
    int seen = 0, freed = 0;  // lane 0 / lane 31: cached progress words
    // 32 rows' target symbols (and SPL site values) a lane, the next 32
    // loaded while these are used
    auto sym = [&](int ii) {
      return ii < tlen ? (int)ts[(size_t)p * tv + ii] : 0;
    };
    auto site = [&](int ii) {
      return ii < tlen ? ((int)(uint16_t)dons[(size_t)p * tv + ii] |
                          ((int)accs[(size_t)p * tv + ii] << 16))
                       : 0;
    };
    int tch = 0, sch = 0, tnx = sym(lane), snx = SPL ? site(lane) : 0;
    // the diagonals that left the strip in the last 32 rows, row i0 + k's
    // in lane k, folded into D by one atomic a lane
    int leave = SENT;
    int* Dp = D + (size_t)p * nd;

    for (int i = 0; i < tlen; ++i) {
      if ((i & 31) == 0) {
        tch = tnx;
        tnx = sym(i + 32 + lane);
        if (SPL) {
          sch = snx;
          snx = site(i + 32 + lane);
        }
      }
      const int* trow = S.tab + __shfl_sync(FULL, tch, i & 31) * m;
      int vd = 0, va = 0;
      if (SPL) {
        const int v = __shfl_sync(FULL, sch, i & 31);
        vd = (int)(int16_t)(v & 0xffff);
        va = v >> 16;
      }
      // the edge: H(i, j0s - 1) and each chain's run through it
      int eh = 0, er1 = 0, er2 = 0, er3 = 0;
      if (!has_in) {
        eh = bnd(i);
        er1 = eh - gapoe;
        er2 = eh - gapoe2;
        er3 = er1;
      } else if (lane == 0) {
        if (seen <= i) seen = spin_until(prog_in, i + 1, in_remote, limit);
        const int4 v = ring_in[i & (K - 1)];
        eh = v.x;
        er1 = v.y;
        er2 = v.z;
        er3 = v.w;
        // a release waits for this lane's earlier global writes: free
        // the entries FREE rows at a time
        if ((i & (FREE - 1)) == FREE - 1 || i == tlen1)
          st_rel(cons_up, i + 1, in_remote);
      }
      const int hup = __shfl_up_sync(FULL, H[3], 1);
      const int Hd[4] = {lane == 0 ? prev_h : hup, H[0], H[1], H[2]};
      prev_h = eh;

      // pass 1: hnof, the clamp and A
      int Mv[4], hn[4], cv[4], A[4];
      int lmax = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Mv[c] = Hd[c] + trow[qc[c]];
        int h = max(Mv[c], E[c]);
        if (TWO) h = max(h, E2[c]);
        if (SPL) h = max(h, NI[c] + va);
        hn[c] = h;
        cv[c] = Hd[c] + mat0;
        A[c] = (SPL ? h : min(h, cv[c])) + je[c] - q;
        lmax = max(lmax, A[c]);
      }
      int out1, out2 = 0, out3 = 0;
      int run = chain_in(lmax, er1, lane, out1);
      uint32_t bytes = 0;

      if constexpr (!TWO) {
        // pass 2: F, the row's H, its bytes and the next row's state
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int F = run - je[c];
          const int Hn = SPL ? max(hn[c], F) : min(max(hn[c], F), cv[c]);
          run = max(run, A[c]);
          if (CIG) {
            // argmax from the unclamped candidates; continuation bits
            // against the clamped H (wavefront_strips.py:304-347)
            const int Ep = E[c];
            const int cand3 = NI[c] + va;
            const int z = max(Mv[c], Ep);
            int d;
            bool ca, cb, cd = false;
            if constexpr (RIGHT) {
              d = Mv[c] > Ep ? 0 : DIR_E;
              d = z > F ? d : DIR_F;
              if (SPL) d = max(z, F) > cand3 ? d : DIR_N;
              ca = Ep >= Hn - q;
              cb = F >= Hn - q;
              if (SPL) cd = NI[c] + q2 - Hn >= vd;
            } else {
              d = Ep > Mv[c] ? DIR_E : 0;
              d = F > z ? DIR_F : d;
              if (SPL) d = cand3 > max(z, F) ? DIR_N : d;
              ca = Ep > Hn - q;
              cb = F > Hn - q;
              if (SPL) cd = NI[c] + q2 - Hn > vd;
            }
            d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
                 (cd ? DIR_N_CONT : 0);
            bytes |= (uint32_t)d << (8 * c);
          }
          E[c] = max(E[c] - e, Hn - gapoe);
          if (SPL) NI[c] = max(NI[c], Hn + vd - q2);
          H[c] = Hn;
        }
      } else {
        // pass 2: F and Hc1 (kept in hn), A2 for the F2 chain
        int lmax2 = NEG;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int F = run - je[c];
          run = max(run, A[c]);
          hn[c] = min(max(hn[c], F), cv[c]);
          A[c] = hn[c] + je2[c] - q2;
          lmax2 = max(lmax2, A[c]);
        }
        int run2 = chain_in(lmax2, er2, lane, out2);
        // pass 3: F2 (kept in A with CIG) and the row's H; E and E2 here
        // in the score form, after the bytes with CIG
        int lmax3 = NEG;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int F2 = run2 - je2[c];
          run2 = max(run2, A[c]);
          const int Hn = min(max(hn[c], F2), cv[c]);
          H[c] = Hn;
          if (CIG) {
            A[c] = F2;
            lmax3 = max(lmax3, Hn + je[c] - q);
          } else {
            E[c] = max(E[c] - e, Hn - gapoe);
            E2[c] = max(E2[c] - e2, Hn - gapoe2);
          }
        }
        if constexpr (CIG) {
          int run3 = chain_in(lmax3, er3, lane, out3);
          // pass 4: the 7-bit bytes from Fb, F2, E and E2; argmax in the
          // candidate order M, E, F, E2, F2 on the unclamped values,
          // continuation bits against the clamped H
          // (wavefront_strips.py:289-340)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int Hn = H[c];
            const int Ep = E[c], E2p = E2[c], F2 = A[c];
            const int Fb = run3 - je[c];
            run3 = max(run3, Hn + je[c] - q);
            int d, z = max(Mv[c], Ep);
            bool ca, cb, ca2, cb2;
            if constexpr (RIGHT) {
              d = Mv[c] > Ep ? 0 : DIR_E;
              d = z > Fb ? d : DIR_F;
              z = max(z, Fb);
              d = z > E2p ? d : DIR_E2;
              z = max(z, E2p);
              d = z > F2 ? d : DIR_F2;
              ca = Ep >= Hn - q;
              cb = Fb >= Hn - q;
              ca2 = E2p >= Hn - q2;
              cb2 = F2 >= Hn - q2;
            } else {
              d = Ep > Mv[c] ? DIR_E : 0;
              d = Fb > z ? DIR_F : d;
              z = max(z, Fb);
              d = E2p > z ? DIR_E2 : d;
              z = max(z, E2p);
              d = F2 > z ? DIR_F2 : d;
              ca = Ep > Hn - q;
              cb = Fb > Hn - q;
              ca2 = E2p > Hn - q2;
              cb2 = F2 > Hn - q2;
            }
            d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
                 (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
            bytes |= (uint32_t)d << (8 * c);
            E[c] = max(Ep - e, Hn - gapoe);
            E2[c] = max(E2p - e2, Hn - gapoe2);
          }
        }
      }

      // the edge out: this strip's last column, once the warp after has
      // read the entry K rows back.  A release waits for the warp's
      // earlier writes, so the row's global writes follow it, and a
      // release to another block (cluster scope) covers PUB rows
      if (has_out && lane == 31) {
        if (freed <= i - K)
          freed = spin_until(cons_in, i - K + 1, out_remote, limit);
        st_entry(ring_out + 16 * (i & (K - 1)),
                 make_int4(H[3], out1, out2, out3));
        if ((i & pub_mask) == pub_mask || i == tlen1)
          st_rel(prog_out, i + 1, out_remote);
      }
      if (CIG && j0 < Lq)
        *reinterpret_cast<uint32_t*>(d8 + ((size_t)p * tv + i) * Lq + j0) =
            bytes;

      // the diagonal maxima: H * KB + (KB - 1 - merge_key).  With u =
      // i - st0 = min(i, qlen - 1 - j), v = en0 - i = min(tlen - 1 - i, j)
      // and cls = u & 3 the key is 0 at v = 0, else cls * tv + i + 1 when
      // cls + v >= 4, else 4 * tv + i + 1 (common.cuh:merge_key).  Before
      // the last 4 rows v = min(j, 4), and every j >= 4 takes cls
      if (i + 4 < tlen) {
        const int base = kb - 2 - i;
        if (short_key) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[c] = max(acc[c], H[c] * kb + base - (min(i, a[c]) & 3) * tv);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cls = min(i, a[c]) & 3;
            const int low = jc[c] == 0 ? kb - 1
                                       : base - (cls + jc[c] >= 4 ? cls : 4) *
                                                    tv;
            if (a[c] >= 0) acc[c] = max(acc[c], H[c] * kb + low);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j0 + c < qlen)
            acc[c] = max(acc[c], H[c] * kb + (kb - 1 -
                                              merge_key(i, i + j0 + c, qlen,
                                                        tlen, tv)));
      }
      if (dq_c >= 0 && dq_c < 4)
        Dq[(size_t)p * nd + i + qlen1] =
            dq_c == 0 ? H[0] : dq_c == 1 ? H[1] : dq_c == 2 ? H[2] : H[3];
      if (i < tlen1) {
        // diagonal i + j0s leaves the strip, the window moves
        const int left = __shfl_sync(FULL, acc[0], 0);
        if (lane == (i & 31)) leave = left;
        if ((i & 31) == 31 || i == tlen1 - 1) {
          if (lane <= (i & 31) && leave != SENT)
            atomicMax(Dp + (i & ~31) + lane + s * STRIP, leave);
          leave = SENT;
        }
        const int nx = __shfl_down_sync(FULL, acc[0], 1);
        acc[0] = acc[1];
        acc[1] = acc[2];
        acc[2] = acc[3];
        acc[3] = lane == 31 ? SENT : nx;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (acc[c] != SENT) atomicMax(Dp + i + j0 + c, acc[c]);
        if (j0 < Lq)
          *reinterpret_cast<int4*>(hl + (size_t)p * Lq + j0) = make_int4(
              j0 < qlen ? H[0] : SENT, j0 + 1 < qlen ? H[1] : SENT,
              j0 + 2 < qlen ? H[2] : SENT, j0 + 3 < qlen ? H[3] : SENT);
      }
    }
  }
  // no block of a cluster leaves while another may touch its rings
  if (cl > 1) cg::this_cluster().sync();
}

template <bool CIG, bool TWO, bool SPL, bool RIGHT>
cudaError_t launch(const uint8_t* qs, const uint8_t* ts, const int* qlen,
                   const int* tlen, const int* table, const int16_t* don,
                   const int16_t* acc, const int2* wtab, int nblocks,
                   int Lq, int tv, int m, int q, int e, int q2, int e2,
                   int lt, int ld, int mat0, int kb, int nw, int cl, int* D,
                   int* Dq, int* hl, uint8_t* d8, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(nw * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, strips_fwd_kernel<CIG, TWO, SPL, RIGHT>, qs,
                         ts, qlen, tlen, table, don, acc, wtab, Lq, tv, m, q,
                         e, q2, e2, lt, ld, mat0, kb, nw, cl, D, Dq, hl, d8);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ksw2t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Returns cudaGetLastError() after the launch (0 on success).  `don` and
// `acc` are the (B, tv) int16 site rows of a splice launch (spl), else
// null.  `wtab` holds (pair, strip) for each of the nblocks * nw warps
// (pair -1: idle), clusters of `cl` consecutive blocks.
extern "C" int ksw2t_strips_fwd(const void* qs, const void* ts,
                                const void* qlen, const void* tlen,
                                const void* table, const void* don,
                                const void* acc, const void* wtab,
                                int nblocks, int Lq, int tv, int m, int q,
                                int e, int q2, int e2, int lt, int ld,
                                int mat0, int kb, int right, int cig, int two,
                                int spl, int nw, int cl, void* D, void* Dq,
                                void* hl, void* d8, void* stream) {
  if (nblocks <= 0 || nw <= 0 || nw > MAXW || cl <= 0 ||
      cl > MAX_CLUSTER || nblocks % cl || Lq % 32 || m > 8 ||
      (two && spl) || (spl && (don == nullptr || acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  // RIGHT only changes the bytes: the score forms take one instance
  const int form = (spl ? 2 : two ? 1 : 0) * 3 + (cig ? (right ? 2 : 1) : 0);
  auto fn = form == 0 ? launch<false, false, false, false>
          : form == 1 ? launch<true, false, false, false>
          : form == 2 ? launch<true, false, false, true>
          : form == 3 ? launch<false, true, false, false>
          : form == 4 ? launch<true, true, false, false>
          : form == 5 ? launch<true, true, false, true>
          : form == 6 ? launch<false, false, true, false>
          : form == 7 ? launch<true, false, true, false>
                      : launch<true, false, true, true>;
  return (int)fn((const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
                 (const int*)tlen, (const int*)table, (const int16_t*)don,
                 (const int16_t*)acc, (const int2*)wtab, nblocks, Lq, tv, m,
                 q, e, q2, e2, lt, ld, mat0, kb, nw, cl, (int*)D, (int*)Dq,
                 (int*)hl, (uint8_t*)d8, (cudaStream_t)stream);
}
