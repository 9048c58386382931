// Halo round: K diagonals of one shard of ONE pair whose target axis is
// split over the devices of a mesh (ksw2_tpu_torch/parallel/halo.py).
//
// Replaces no TPU kernel: ksw2_tpu/parallel/halo.py:_halo_body is a
// fori_loop under shard_map, with one lax.ppermute of a (K, 3) package of
// boundary (x, v, H) values a round.  Plain PyTorch would launch ~40 small
// operations a diagonal, and the 50 kb pair has ~100k diagonals, so a
// round is this one launch.  The plain version is
// parallel/halo.py:halo_round_plain.
//
// The cell is kernel 12's one-piece cell (extz_fwd.cu): the deltas u, v,
// x, y in wrapping int8 over the 16-rounded band [st, en] of diagonal r
// (ksw2_extz2_sse.c:107-205), the score byte filled over [st0, st0 +
// ((en0 - st0) & ~15) + 15] and kept stale elsewhere, the st - 1 edge
// override when st - 1 was outside diagonal r - 1's rounded band, the
// first column's u = q at t == r, and the int32 H row over [st0, en0].
// The max is deferred: each position keeps its best H (HM) and that H's
// diagonal (RD), and the query-end cell's H (MQ); the host takes the max
// with the SSE merge order's tie key from the gathered planes
// (halo.py:_finalize).
//
// Layout: one block of T = min(C, 1024) threads over the shard's C
// positions t0 .. t0 + C - 1; the state (U, V, X, Y, S, H, HM, RD, MQ as
// int32 planes of C) stays in global memory between diagonals and rounds.
// A diagonal walks the band's positions in this shard in chunks of T, a
// thread a position; position t reads t - 1's old x, v and H, which the
// chunk's threads first publish in shared memory (three buffers in turn,
// so one barrier a chunk suffices); the chunk's first thread takes them
// from the chunk before, or, for the band's first position in the shard,
// from the position below it in global memory (outside the band, not
// written this diagonal) or from the package in (the shard before's last
// position after diagonal r - 1).  Before each diagonal thread 0 writes
// the package out: the last position's x, v, H after diagonal r - 1.
//
// What bounds it on an H100: one block, so one SM's instruction rate
// over the band's cells (~40 integer operations a cell) and its loads
// and stores of ~9 planes a cell through L1 / L2, plus a barrier a chunk
// and one a diagonal; the shards of a mesh run on SMs of their own.  A
// multi-SM round on kernel 12's register tiles is later work.
#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;   // NEG_INF of core/flags.py
constexpr int MAX_THREADS = 1024;
constexpr int NBUF = 3;
enum { PU, PV, PX, PY, PS, PH, PHM, PRD, PMQ };

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

struct HaloArgs {
  const uint8_t* qs;  // (qlen) the whole query
  const uint8_t* ts;  // (C) the shard's target positions, 0 past tlen
  int* st;            // (9, C) the state planes
  const int* pin;     // (>= nk, 3) package in; null on the first shard
  int* pout;          // (>= nk, 3) package out
  int qlen, tlen, w, t0, C, r0, nk, q, e, mch, mis, scN, m;
};

__global__ void __launch_bounds__(MAX_THREADS)
    halo_round_kernel(const HaloArgs A) {
  __shared__ int sx[NBUF][MAX_THREADS], sv[NBUF][MAX_THREADS],
      sh[NBUF][MAX_THREADS];
  const int T = blockDim.x, tid = threadIdx.x, C = A.C;
  int* U = A.st + PU * C;
  int* V = A.st + PV * C;
  int* X = A.st + PX * C;
  int* Y = A.st + PY * C;
  int* S = A.st + PS * C;
  int* H = A.st + PH * C;
  int* HM = A.st + PHM * C;
  int* RD = A.st + PRD * C;
  int* MQ = A.st + PMQ * C;
  const int qe = A.q + A.e;
  const int clamp = (A.mch + 2 * qe) & 255;
  int g = 0;  // chunks so far: the exchange buffer in turn
  for (int k = 0; k < A.nk; ++k) {
    const int r = A.r0 + k;
    if (tid == 0) {
      A.pout[3 * k] = X[C - 1];
      A.pout[3 * k + 1] = V[C - 1];
      A.pout[3 * k + 2] = H[C - 1];
    }
    const BandRow bd = band_row(r, A.qlen, A.tlen, A.w);
    bool prevok = false;
    if (r > 0 && bd.st > 0) {
      const BandRow bp = band_row(r - 1, A.qlen, A.tlen, A.w);
      prevok = bp.st <= bd.st - 1 && bd.st - 1 <= bp.en;
    }
    const int colv = r > 0 ? A.q : 0;
    const int hi_s = bd.st0 + ((bd.en0 - bd.st0) & ~15) + 15;
    const int lo = max(bd.st, A.t0) - A.t0;
    const int hi = min(bd.en, A.t0 + C - 1) - A.t0;
    const int hi2 = min(max(bd.en, hi_s), A.t0 + C - 1) - A.t0;
    // the old x, v, H of position lo - 1: below the band in this shard,
    // else the package in (unused at t = 0)
    int bx = 0, bv = 0, bH = NEG;
    if (lo > 0 && lo <= hi2) {
      bx = X[lo - 1];
      bv = V[lo - 1];
      bH = H[lo - 1];
    } else if (lo == 0 && A.pin != nullptr) {
      bx = A.pin[3 * k];
      bv = A.pin[3 * k + 1];
      bH = A.pin[3 * k + 2];
    }
    for (int base = lo; base <= hi2; base += T, ++g) {
      const int i = base + tid;
      const bool ok = i <= hi2;
      const int b = g % NBUF;
      int ox = 0, ov = 0, oH = NEG;
      if (ok) {
        ox = X[i];
        ov = V[i];
        oH = H[i];
      }
      sx[b][tid] = ox;
      sv[b][tid] = ov;
      sh[b][tid] = oH;
      __syncthreads();
      int Xm, Vm, Hm;
      if (tid > 0) {
        Xm = sx[b][tid - 1];
        Vm = sv[b][tid - 1];
        Hm = sh[b][tid - 1];
      } else if (base == lo) {
        Xm = bx;
        Vm = bv;
        Hm = bH;
      } else {
        const int pb = (g + NBUF - 1) % NBUF;
        Xm = sx[pb][T - 1];
        Vm = sv[pb][T - 1];
        Hm = sh[pb][T - 1];
      }
      if (ok) {
        const int t = A.t0 + i;
        int Sv = S[i];
        if (t >= bd.st0 && t <= hi_s) {
          const int Tb = A.ts[i];
          const int qi = r - t;
          const int Qb = qi >= 0 ? A.qs[min(qi, A.qlen - 1)] : 0;
          int s = Tb == Qb ? A.mch : A.mis;
          s = Tb == A.m - 1 || Qb == A.m - 1 ? A.scN : s;
          Sv = w8(s);
          S[i] = Sv;
        }
        if (i <= hi) {
          const bool edge = t == bd.st && !prevok;
          const int X1 = edge ? 0 : Xm;
          const int V1 = edge ? (bd.st == 0 ? colv : 0) : Vm;
          const int Uc = t == r ? colv : U[i];
          const int Yc = t == r ? 0 : Y[i];
          int a = w8(X1 + V1), bb = w8(Yc + Uc);
          int z = max(w8(Sv + 2 * qe), a);
          z = max(z & 255, bb & 255);  // max_epu8
          z = w8(min(z, clamp));       // min_epu8
          const int un = w8(z - V1), vn = w8(z - Uc);
          const int z2 = w8(z - A.q);
          a = w8(a - z2);
          bb = w8(bb - z2);
          U[i] = un;
          V[i] = vn;
          X[i] = a > 0 ? a : 0;
          Y[i] = bb > 0 ? bb : 0;
          if (t >= bd.st0 && t <= bd.en0) {
            const int h = r == 0 ? (vn & 255) - 2 * qe
                          : t < bd.en0 || bd.en0 == 0
                              ? oH + (vn & 255) - qe
                              : Hm + (un & 255) - qe;
            H[i] = h;
            if (h > HM[i]) {
              HM[i] = h;
              RD[i] = r;
            }
            if (t == bd.st0 && r - bd.st0 == A.qlen - 1) MQ[i] = h;
          }
        }
      }
    }
    // the diagonal's writes before the next diagonal's reads
    __syncthreads();
  }
}

}  // namespace

extern "C" int ksw2t_halo_round(const void* qs, const void* ts, void* st,
                                const void* pin, void* pout, int qlen,
                                int tlen, int w, int t0, int C, int r0, int nk,
                                int q, int e, int mch, int mis, int scN, int m,
                                int threads, void* stream) {
  if (C <= 0 || qlen <= 0 || tlen <= 0 || nk <= 0 || threads <= 0 ||
      threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  HaloArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (int*)st,
             (const int*)pin, (int*)pout, qlen, tlen, w, t0, C, r0, nk, q, e,
             mch, mis, scN, m};
  halo_round_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
