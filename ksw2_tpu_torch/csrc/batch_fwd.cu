// Batched forward: the anti-diagonal difference DP of many short pairs at
// once, one warp a pair (extz and extd, exact or approximate max, score
// and direction bytes).
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
// Layout: one warp per pair, several pairs a block, no block barrier.  A
// pair's state lives in its warp's shared-memory strip in the t
// coordinate, as the reference's own arrays do: int8 u, v, x, y (x2, y2),
// the score bytes s, the target and the int32 H row, each TP =
// round_up(Lt + 16, 32) long (the 16-rounded band and the score fill's
// stale overshoot).  Lane `l` owns the positions t = 32 c + l and is the
// only thread that ever reads or writes them, so the strip needs no
// __syncwarp: a diagonal walks its chunks c in order, each lane reads
// its cell's old state, and the neighbour t - 1 of the previous diagonal
// (x, v, x2, and H for the en0 cell) comes from lane l - 1 by
// __shfl_up_sync, or for lane 0 from lane 31 of the previous chunk,
// carried in registers.  Every read is of the state before this
// diagonal's writes, so the update is in place, and positions outside
// the band keep the reference's stale bytes (the edge byte at st - 1,
// the score bytes left in [st, st0) and past the 16-byte fill).  The
// diagonal's maximum is a 64-bit (H, tie rank) key in the SSE merge
// order, reduced by warp shuffles, so every lane holds the per-pair
// scalars (max, Z-drop state, the H0 walk) in registers; each pair stops
// at its own first empty-band diagonal (the closed form of
// batch_pallas.py:42-48) or its Z-drop.
//
// What bounds it on an H100: the serial chain of diagonals of each pair
// (qlen + tlen - 1 of them, a few hundred on short reads), each a few
// chunk steps and 5 shuffle rounds of the argmax.  A cell costs ~105
// integer operations as written here (~135 two-piece): the recurrence's
// ~45 (~65; chip_smoke.py: OPS, the bound) plus this kernel's own
// overhead, the score fill, the old state's loads, the neighbour
// shuffles and the 64-bit tie key.  With CIG the n_col bytes a diagonal
// are the only large memory traffic.  Shared
// memory (TP x 10 bytes a warp, 12 two-piece) bounds the warps an SM
// holds: about 40 at Lt = 512, 6 at Lt = 3072; registers (58-77 a
// thread) bound them to 24-32.  This version is the simple one that is
// right; registers for the t <= 512 strips, DPX byte SIMD and staging
// the byte rows are later work.
#include <climits>

#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;    // NEG_INF of core/flags.py
constexpr int KT = 4096;            // tie-rank class stride (ops/band.py)
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

struct BatchArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const int* table;
  int B, Lq, Lt, m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N;
  int zdrop, right, generic, adrop, nd, ncol, TP;
  int* rec;
  uint8_t* p;
};

template <bool TWO, bool CIG, bool APPROX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
batch_fwd_kernel(const BatchArgs A) {
  constexpr int PL = TWO ? 6 : 4;    // u, v, x, y (, x2, y2)
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= A.B) return;              // a whole warp; no block barrier
  const int TP = A.TP;
  unsigned char* base = smem + (size_t)warp * TP * (PL + 6);
  int* Hr = reinterpret_cast<int*>(base);                    // [TP]
  signed char* pl = reinterpret_cast<signed char*>(Hr + TP);  // [PL][TP]
  signed char* sr = pl + PL * TP;                            // [TP]
  uint8_t* tgs = reinterpret_cast<uint8_t*>(sr + TP);        // [TP]

  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int q = A.q, e = A.e, q2 = A.q2, e2 = A.e2;
  const int qe = q + e, qe2 = q2 + e2;
  const int ez = TWO ? e2 : e;       // Z-drop gap slope
  const int init = TWO ? w8(-qe) : 0;
  const int init2 = w8(-qe2);
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  uint8_t* prow = CIG ? A.p + (size_t)b * A.nd * A.ncol : nullptr;

  // the reference's init bytes; lane l touches only t = l mod 32
  for (int t = lane; t < TP; t += 32) {
    for (int k = 0; k < 4; ++k) pl[k * TP + t] = (signed char)init;
    if (TWO) {
      pl[4 * TP + t] = (signed char)init2;
      pl[5 * TP + t] = (signed char)init2;
    }
    sr[t] = 0;
    Hr[t] = NEG;
    tgs[t] = t < tlen ? tg[t] : 0;
  }

  int last_st = -1, last_en = -1, H0 = 0, lt0 = 0;
  int mx = 0, mt = -1, mq = -1, mqe = NEG, mqet = -1, mte = NEG, mteq = -1;
  int score = NEG, zd = 0;
  const int ndb = qlen + tlen - 1;
  // the first diagonal whose band is empty (batch_pallas.py:42-48)
  const int rlim = min(min(ndb, 2 * qlen + w - 1),
                       min(2 * tlen + w - 1, w == 0 ? 1 : ndb));
  // ksw_apply_zdrop (ksw2.h:191-207): true when the pair drops
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

  for (int r = 0; r < rlim; ++r) {
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    const int st = st0 & ~15, en = en0 | 15;
    if (CIG && en - st + 1 > A.ncol) __trap();   // the store's row width
    // the boundary entering lane st (ksw2_extz2_sse.c:152-158) and the
    // first-column values (the j == 0 cell at t == r)
    const bool prevok = st > 0 && last_st <= st - 1 && st - 1 <= last_en;
    const int colv =
        TWO ? (r == 0 ? -qe : (r < A.lt ? -e : (r == A.lt ? A.ld : -e2)))
            : (r ? q : 0);
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
                Yo = pl[3 * TP + t];
      const int X2o = TWO ? pl[4 * TP + t] : 0;
      const int Y2o = TWO ? pl[5 * TP + t] : 0;
      const int Ho = APPROX ? 0 : Hr[t];
      int Xm = __shfl_up_sync(FULL, Xo, 1);
      int Vm = __shfl_up_sync(FULL, Vo, 1);
      int X2m = TWO ? __shfl_up_sync(FULL, X2o, 1) : 0;
      int Hm = APPROX ? 0 : __shfl_up_sync(FULL, Ho, 1);
      if (lane == 0) {
        Xm = cX;
        Vm = cV;
        X2m = cX2;
        Hm = cH;
      }
      cX = __shfl_sync(FULL, Xo, 31);
      cV = __shfl_sync(FULL, Vo, 31);
      if (TWO) cX2 = __shfl_sync(FULL, X2o, 31);
      if (!APPROX) cH = __shfl_sync(FULL, Ho, 31);

      int un = 0, vn = 0, h = 0;
      if (t >= st && t <= en) {
        const int S = sr[t];
        int X1 = Xm, V1 = Vm, X21 = X2m;
        if (t == st) {
          X1 = prevok ? Xm : init;
          V1 = prevok ? Vm : (st == 0 ? w8(colv) : init);
          X21 = prevok ? X2m : init2;
        }
        const int U = t == r ? w8(colv) : Uo;
        const int Y = t == r ? init : Yo;
        int a = w8(X1 + V1), bb = w8(Y + U);
        int d = 0, z, xn, yn;
        if (!TWO) {
          const int zz = w8(S + 2 * qe);
          d = A.right ? (zz > a ? 0 : DIR_E) : (a > zz ? DIR_E : 0);
          z = max(zz, a);
          d = A.right ? (z > bb ? d : DIR_F) : (bb > z ? DIR_F : d);
          z = w8(max(z & 255, bb & 255));                 // max_epu8
          z = w8(min(z & 255, (A.sc_mch + 2 * qe) & 255));  // min_epu8
          un = w8(z - V1);
          vn = w8(z - U);
          const int z2 = w8(z - q);
          a = w8(a - z2);
          bb = w8(bb - z2);
          const bool ta = A.right ? a >= 0 : a > 0;
          const bool tb = A.right ? bb >= 0 : bb > 0;
          d |= (ta ? DIR_E_CONT : 0) | (tb ? DIR_F_CONT : 0);
          xn = a > 0 ? a : 0;
          yn = bb > 0 ? bb : 0;
        } else {
          const int Y2 = t == r ? init2 : Y2o;
          int a2 = w8(X21 + V1), b2 = w8(Y2 + U);
          z = S;
          const int cand[4] = {a, bb, a2, b2};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            d = A.right ? (z > cand[k] ? d : k + 1)
                        : (cand[k] > z ? k + 1 : d);
            z = max(z, cand[k]);
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
          const bool cb = A.right ? bb >= 0 : bb > 0;
          const bool ca2 = A.right ? a2 >= 0 : a2 > 0;
          const bool cb2 = A.right ? b2 >= 0 : b2 > 0;
          d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
               (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
          xn = w8(max(a, 0) - qe);
          yn = w8(max(bb, 0) - qe);
          pl[4 * TP + t] = (signed char)w8(max(a2, 0) - qe2);
          pl[5 * TP + t] = (signed char)w8(max(b2, 0) - qe2);
        }
        pl[t] = (signed char)un;
        pl[TP + t] = (signed char)vn;
        pl[2 * TP + t] = (signed char)xn;
        pl[3 * TP + t] = (signed char)yn;
        if (CIG) prow[(size_t)r * A.ncol + (t - st)] = (uint8_t)d;

        if (!APPROX && t >= st0 && t <= en0) {
          // the H row (spec/common.py:exact_max_scan)
          const int vv = TWO ? vn : (vn & 255), uu = TWO ? un : (un & 255);
          const int sub = TWO ? 0 : qe;
          if (r == 0)
            h = vv - (TWO ? A.qe_pre : 2 * qe);
          else if (t < en0 || en0 == 0)
            h = Ho + vv - sub;
          else
            h = Hm + uu - sub;
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
        H0 = TWO ? d0 - A.qe_pre : (d0 & 255) - 2 * qe;
      } else {
        const bool c1 = st0 <= lt0 && lt0 <= en0;
        const bool c2 = st0 <= lt0 + 1 && lt0 + 1 <= en0;
        if (!TWO) {
          d0 = (d0 & 255) - qe;
          d1 = (d1 & 255) - qe;
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
      if (A.adrop && (TWO || r > 0)) drop = zdrop_apply(r, H0, lt0);
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

template <bool TWO, bool CIG, bool APPROX>
cudaError_t launch(const BatchArgs& a, int warps, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      batch_fwd_kernel<TWO, CIG, APPROX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + warps - 1) / warps;
  batch_fwd_kernel<TWO, CIG, APPROX><<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool TWO>
cudaError_t launch_two(const BatchArgs& a, int cig, int approx, int warps,
                       size_t smem, cudaStream_t stream) {
  if (cig)
    return approx ? launch<TWO, true, true>(a, warps, smem, stream)
                  : launch<TWO, true, false>(a, warps, smem, stream);
  return approx ? launch<TWO, false, true>(a, warps, smem, stream)
                : launch<TWO, false, false>(a, warps, smem, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_batch_fwd(
    const void* qs, const void* ts, const void* qlen, const void* tlen,
    const void* w, const void* table, int B, int Lq, int Lt, int m, int q,
    int e, int q2, int e2, int qe_pre, int lt, int ld, int sc_mch,
    int sc_mis, int sc_N, int zdrop, int right, int generic, int approx,
    int adrop, int cig, int two, int nd, int ncol, int TP, int warps,
    void* rec, void* p, void* stream) {
  if (B <= 0 || warps <= 0 || warps > MAX_WARPS || TP % 32 ||
      TP < Lt + 16 || ncol % 16 || (cig && p == nullptr))
    return (int)cudaErrorInvalidValue;
  BatchArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
              (const int*)tlen, (const int*)w, (const int*)table, B, Lq, Lt,
              m, q, e, q2, e2, qe_pre, lt, ld, sc_mch, sc_mis, sc_N, zdrop,
              right, generic, adrop, nd, ncol, TP, (int*)rec, (uint8_t*)p};
  // a warp's strip (ops/batch.py:warp_smem_bytes mirrors it): H int32,
  // the delta planes, the score bytes and the target
  const size_t smem = (size_t)warps * TP * ((two ? 6 : 4) + 6);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(two ? launch_two<true>(a, cig, approx, warps, smem, st)
                   : launch_two<false>(a, cig, approx, warps, smem, st));
}
