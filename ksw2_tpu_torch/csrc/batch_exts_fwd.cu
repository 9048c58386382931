// Batched splice forward: the anti-diagonal exts DP of many pairs at once,
// one warp a pair (exact or approximate max, score and direction bytes).
//
// Replaces ksw2_tpu/ops/wavefront_batch_exts.py:_batch_exts_kernel.  It
// computes what spec/diagdiff.py:exts2 specifies (ksw2_exts2_sse.c) on
// targets of up to 1536: per anti-diagonal r = i + j over the 16-rounded
// [st, en] of the matrix (exts has no band) the Suzuki-Kasahara deltas u,
// v, x, y and the intron delta x2 (deletion side only) in wrapping int8;
// the intron candidate a2 + acceptor[t] beside a and b with no clamp of z;
// x2' = max(a2', donor[t]) - q2; the first-column switch ucol(r)
// (wavefront_batch_exts.py:142-150); H without offsets, seeded v - (q + e)
// at r = 0; the SSE 4-lane argmax tie order and ksw_apply_zdrop with no gap
// slope, or the O(1) H0 walk (APPROX, whose APPROX_DROP applies from r =
// 0); the mqe / mte captures and the score, written as the 9-field record
// of ops/records.py; with CIG the direction byte of every cell of [st, en]
// (codes 1..3, bits 0x08 / 0x10 / 0x20) into the rotated store
// p[b][r][t - st(r)] with n_col bytes a diagonal, which band_walk.cu
// walks with min_intron = long_thres.  The plain version is
// ops/batch_exts.py:batch_exts_forward_plain.
//
// Layout: kernel E's (batch_fwd.cu).  One warp per pair, several pairs a
// block, no block barrier.  A pair's state lives in its warp's
// shared-memory strip in the t coordinate: int8 u, v, x, y, x2, the score
// bytes, the target, the donor and acceptor bytes and the int32 H row,
// each TP = round_up(Lt + 16, 32) long (13 TP bytes a warp).  Lane l owns
// the positions t = 32 c + l and is the only thread that reads or writes
// them, so the strip needs no __syncwarp: a diagonal walks its chunks c in
// order, each lane reads its cell's old state, and the neighbour t - 1 of
// the previous diagonal (x, v, x2, and H for the en0 cell) comes from lane
// l - 1 by __shfl_up_sync, or for lane 0 from lane 31 of the previous
// chunk, carried in registers.  Positions outside [st, en] keep the
// reference's stale bytes.  The diagonal's maximum is a 64-bit (H, tie
// rank) key reduced by warp shuffles, so every lane holds the per-pair
// scalars in registers; a pair stops at its last diagonal or its Z-drop.
//
// What bounds it on an H100: the serial chain of diagonals of each pair
// (qlen + tlen - 1 of them), each a few chunk steps and 5 shuffle rounds
// of the argmax; a cell is ~50 integer operations of the recurrence
// (chip_smoke.py: OPS) plus the kernel's own loads, shuffles and key.
// With CIG the n_col bytes a diagonal are the only large memory traffic.
// Shared memory (13 TP bytes a warp) and registers bound the warps an SM
// holds.  This version is the simple one that is right.
#include <climits>

#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;    // NEG_INF of core/flags.py
constexpr int KT = 4096;            // tie-rank class stride (ops/band.py)
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

struct ExtsArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* table;
  const signed char* don;
  const signed char* acc;
  int B, Lq, Lt, m, q, e, q2, lt, ld, sc_mch, sc_mis, sc_N;
  int zdrop, right, generic, adrop, nd, ncol, TP;
  int* rec;
  uint8_t* p;
};

template <bool CIG, bool APPROX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
batch_exts_fwd_kernel(const ExtsArgs A) {
  constexpr int PL = 5;              // u, v, x, y, x2
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= A.B) return;              // a whole warp; no block barrier
  const int TP = A.TP;
  unsigned char* base = smem + (size_t)warp * TP * 13;
  int* Hr = reinterpret_cast<int*>(base);                    // [TP]
  signed char* pl = reinterpret_cast<signed char*>(Hr + TP);  // [PL][TP]
  signed char* sr = pl + PL * TP;                            // [TP]
  uint8_t* tgs = reinterpret_cast<uint8_t*>(sr + TP);        // [TP]
  signed char* dns = reinterpret_cast<signed char*>(tgs + TP);  // [TP]
  signed char* acs = dns + TP;                               // [TP]

  const int qlen = A.qlens[b], tlen = A.tlens[b];
  const int q = A.q, e = A.e, q2 = A.q2;
  const int qe = q + e;
  const int initq = w8(-qe), init2 = w8(-q2);
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  const signed char* dg = A.don + (size_t)b * A.Lt;
  const signed char* ag = A.acc + (size_t)b * A.Lt;
  uint8_t* prow = CIG ? A.p + (size_t)b * A.nd * A.ncol : nullptr;

  // the reference's init bytes; lane l touches only t = l mod 32
  for (int t = lane; t < TP; t += 32) {
    for (int k = 0; k < 4; ++k) pl[k * TP + t] = (signed char)initq;
    pl[4 * TP + t] = (signed char)init2;
    sr[t] = 0;
    Hr[t] = NEG;
    tgs[t] = t < tlen ? tg[t] : 0;
    dns[t] = t < A.Lt ? dg[t] : 0;
    acs[t] = t < A.Lt ? ag[t] : 0;
  }

  int last_st = -1, last_en = -1, H0 = 0, lt0 = 0;
  int mx = 0, mt = -1, mq = -1, mqe = NEG, mqet = -1, mte = NEG, mteq = -1;
  int score = NEG, zd = 0;
  const int ndb = qlen + tlen - 1;
  // ksw_apply_zdrop (ksw2.h:191-207) with no gap slope, as exts2 calls
  // it (ksw2_exts2_sse.c:395-398): true when the pair drops
  auto zdrop_apply = [&](int r, int Hm, int t) {
    if (Hm > mx) {
      mx = Hm;
      mt = t;
      mq = r - t;
      return false;
    }
    return A.zdrop >= 0 && t >= mt && r - t >= mq && mx - Hm > A.zdrop;
  };

  for (int r = 0; r < ndb; ++r) {
    const int st0 = max(0, r - qlen + 1);
    const int en0 = min(tlen - 1, r);
    const int st = st0 & ~15, en = en0 | 15;
    if (CIG && en - st + 1 > A.ncol) __trap();   // the store's row width
    // the boundary entering lane st (ksw2_exts2_sse.c:191-196) and the
    // first-column switch (the j == 0 cell at t == r)
    const bool prevok = st > 0 && last_st <= st - 1 && st - 1 <= last_en;
    const int ucol = w8(r == 0 ? -qe : r < A.lt ? -e : r == A.lt ? A.ld : 0);
    // the score fill: [st0, hi]; the other positions keep stale bytes
    const int hi = A.generic ? en0 : st0 + ((en0 - st0) & ~15) + 15;
    const int c_lo = max(st - 1, 0) >> 5, c_hi = max(en, hi) >> 5;

    long long best = LLONG_MIN;
    int hst = 0, hen = 0, d0 = 0, d1 = 0;
    int cX = 0, cV = 0, cX2 = 0, cH = 0;   // lane 31's old state, t - 1
    for (int c = c_lo; c <= c_hi; ++c) {
      const int t = (c << 5) + lane;
      if (t >= st0 && t <= hi) {
        const int T = tgs[t];
        const int Q = r - t >= 0 ? qy[r - t] : 0;
        int sv;
        if (A.generic) {
          sv = A.table[T * A.m + Q];
        } else {
          sv = T == Q ? A.sc_mch : A.sc_mis;
          if (T == A.m - 1 || Q == A.m - 1) sv = A.sc_N;
        }
        sr[t] = (signed char)w8(sv);
      }
      // this cell's state before the diagonal, and that of t - 1
      const int Uo = pl[t], Vo = pl[TP + t], Xo = pl[2 * TP + t],
                Yo = pl[3 * TP + t], X2o = pl[4 * TP + t];
      const int Ho = APPROX ? 0 : Hr[t];
      int Xm = __shfl_up_sync(FULL, Xo, 1);
      int Vm = __shfl_up_sync(FULL, Vo, 1);
      int X2m = __shfl_up_sync(FULL, X2o, 1);
      int Hm = APPROX ? 0 : __shfl_up_sync(FULL, Ho, 1);
      if (lane == 0) {
        Xm = cX;
        Vm = cV;
        X2m = cX2;
        Hm = cH;
      }
      cX = __shfl_sync(FULL, Xo, 31);
      cV = __shfl_sync(FULL, Vo, 31);
      cX2 = __shfl_sync(FULL, X2o, 31);
      if (!APPROX) cH = __shfl_sync(FULL, Ho, 31);

      int un = 0, vn = 0, h = 0;
      if (t >= st && t <= en) {
        const int S = sr[t], Dn = dns[t];
        int X1 = Xm, V1 = Vm, X21 = X2m;
        if (t == st && !prevok) {
          X1 = initq;
          V1 = st == 0 ? ucol : initq;
          X21 = init2;
        }
        const int U = t == r ? ucol : Uo;
        const int Y = t == r ? initq : Yo;
        int a = w8(X1 + V1), bb = w8(Y + U), a2 = w8(X21 + V1);
        const int cand[3] = {a, bb, w8(a2 + acs[t])};
        int z = S, d = 0;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          d = A.right ? (z > cand[k] ? d : k + 1) : (cand[k] > z ? k + 1 : d);
          z = max(z, cand[k]);
        }
        un = w8(z - V1);
        vn = w8(z - U);
        const int t1 = w8(z - q);
        a = w8(a - t1);
        bb = w8(bb - t1);
        a2 = w8(a2 - z + q2);
        const bool ca = A.right ? a >= 0 : a > 0;
        const bool cb = A.right ? bb >= 0 : bb > 0;
        const bool cd = A.right ? a2 >= Dn : a2 > Dn;
        d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
             (cd ? DIR_N_CONT : 0);
        pl[t] = (signed char)un;
        pl[TP + t] = (signed char)vn;
        pl[2 * TP + t] = (signed char)w8(max(a, 0) - qe);
        pl[3 * TP + t] = (signed char)w8(max(bb, 0) - qe);
        pl[4 * TP + t] = (signed char)w8(max(a2, Dn) - q2);
        if (CIG) prow[(size_t)r * A.ncol + (t - st)] = (uint8_t)d;

        if (!APPROX && t >= st0 && t <= en0) {
          // the H row (spec/common.py:exact_max_scan with sub = 0)
          if (r == 0)
            h = vn - qe;
          else if (t < en0 || en0 == 0)
            h = Ho + vn;
          else
            h = Hm + un;
          Hr[t] = h;
          // the SSE scan's tie rank: the en0 cell, then 4 lane classes
          // over [st0, en1), then the scalar tail; smaller ranks win
          const int rel = t - st0;
          const int en1 = st0 + ((en0 - st0) & ~3);
          const int rank = t == en0 ? 0
                           : t < en1 ? (rel & 3) * KT + rel + 1
                                     : 4 * KT + rel + 1;
          best = max(best, (long long)h * 4294967296LL +
                               (long long)(0x7fffffff - rank));
        }
      }
      // the diagonal's boundary cells, from the lanes that own them
      if (!APPROX) {
        if (c == st0 >> 5) hst = __shfl_sync(FULL, h, st0 & 31);
        if (c == en0 >> 5) hen = __shfl_sync(FULL, h, en0 & 31);
      } else {
        if (c == lt0 >> 5) d0 = __shfl_sync(FULL, vn, lt0 & 31);
        if (c == (lt0 + 1) >> 5) d1 = __shfl_sync(FULL, un, (lt0 + 1) & 31);
      }
    }

    // every lane updates its own copy of the per-pair scalars
    bool drop = false;
    int fin;
    if (!APPROX) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best = max(best, __shfl_xor_sync(FULL, best, o));
      const int maxH = (int)(best >> 32);
      const int rank = 0x7fffffff - (int)(best & 0xffffffffLL);
      const int maxt = rank == 0       ? en0
                       : rank <= 4 * KT ? st0 + (rank - 1) % KT
                                        : st0 + rank - 1 - 4 * KT;
      if (en0 == tlen - 1 && hen > mte) {
        mte = hen;
        mteq = r - en;
      }
      if (r - st0 == qlen - 1 && hst > mqe) {
        mqe = hst;
        mqet = st0;
      }
      drop = zdrop_apply(r, maxH, maxt);
      fin = hen;
    } else {
      if (r == 0) {                  // lt0 == 0: d0 is vn at t == 0
        H0 = d0 - qe;
      } else {
        const bool c1 = st0 <= lt0 && lt0 <= en0;
        const bool c2 = st0 <= lt0 + 1 && lt0 + 1 <= en0;
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
      if (A.adrop) drop = zdrop_apply(r, H0, lt0);
      fin = H0;
    }
    if (drop) {
      zd = 1;
      break;
    }
    if (r == ndb - 1 && en0 == tlen - 1) score = fin;
    last_st = st;
    last_en = en;
  }
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

template <bool CIG, bool APPROX>
cudaError_t launch(const ExtsArgs& a, int warps, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      batch_exts_fwd_kernel<CIG, APPROX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + warps - 1) / warps;
  batch_exts_fwd_kernel<CIG, APPROX><<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_batch_exts_fwd(
    const void* qs, const void* ts, const void* qlen, const void* tlen,
    const void* table, const void* don, const void* acc, int B, int Lq,
    int Lt, int m, int q, int e, int q2, int lt, int ld, int sc_mch,
    int sc_mis, int sc_N, int zdrop, int right, int generic, int approx,
    int adrop, int cig, int nd, int ncol, int TP, int warps, void* rec,
    void* p, void* stream) {
  if (B <= 0 || warps <= 0 || warps > MAX_WARPS || TP % 32 ||
      TP < Lt + 16 || ncol % 16 || (cig && p == nullptr))
    return (int)cudaErrorInvalidValue;
  ExtsArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
             (const int*)tlen, (const int*)table, (const signed char*)don,
             (const signed char*)acc, B, Lq, Lt, m, q, e, q2, lt, ld, sc_mch,
             sc_mis, sc_N, zdrop, right, generic, adrop, nd, ncol, TP,
             (int*)rec, (uint8_t*)p};
  // a warp's strip (ops/batch_exts.py:warp_smem_bytes mirrors it): H
  // int32, the five delta planes, the score bytes, the target, the donor
  // and acceptor bytes
  const size_t smem = (size_t)warps * TP * 13;
  cudaStream_t st = (cudaStream_t)stream;
  if (cig)
    return (int)(approx ? launch<true, true>(a, warps, smem, st)
                        : launch<true, false>(a, warps, smem, st));
  return (int)(approx ? launch<false, true>(a, warps, smem, st)
                      : launch<false, false>(a, warps, smem, st));
}
