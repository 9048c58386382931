// Batched local alignment (affine Smith-Waterman), one warp a pair
// (kernel 18).
//
// Replaces ksw2_tpu/ops/batch_local.py:_local_kernel (counted as
// batch_local_fwd).  It computes what that kernel computes, in absolute
// int32 over anti-diagonals r = i + j, t the target position:
//
//   H(r)[t] = max(0, H(r-2)[t-1] + s, E(r)[t], F(r)[t])
//   E(r)[t] = max(H(r-1)[t-1] - q, E(r-1)[t-1]) - e     (consumes target)
//   F(r)[t] = max(H(r-1)[t]   - q, F(r-1)[t])   - e     (consumes query)
//
// with H = 0 and E = F = NEG outside the pair's band [max(0, r - qlen +
// 1), min(tlen - 1, r)] and at t = -1.  The score s reads three entries of
// the matrix, as the JAX kernel does (batch_local.py:88-91): sc_mch when
// the raw symbols are equal, sc_mis otherwise, sc_N when either is m - 1.
// Each target position keeps its first strict best (BH, and the diagonal
// BR where it was reached); the result is V = max BH, te = the smallest t
// with BH = V and qe = BR[te] - te, which is the oracle's row-major first
// best (spec/local.py), or (0, -1, -1) when no cell scores above 0.  The
// plain version is ops/batch_local.py:local_forward_plain.
//
// Layout: one warp a pair, targets of up to 128 positions (the JAX
// contract, batch_local.py:200); lane l owns t = 4l .. 4l + 3 in
// registers (H of the last two diagonals, E, F, the query symbol, BH,
// BR), so a diagonal needs no memory traffic and no barrier.  The t - 1
// neighbours of a lane's first cell come from lane l - 1's last cell by
// __shfl_up_sync (H(r-1), H(r-2), E(r-1) and the query symbol, which
// moves one position a diagonal, as the JAX kernel's roll does); lane 0
// takes the boundary (0, 0, NEG) and the query symbol q[r].  The query
// is read 32 symbols a chunk, one a lane, with the next chunk's load in
// flight while the current one is used (__shfl_sync picks q[r]).  H is
// one DPX instruction (__vimax3_s32_relu = max(a, b, c, 0)).  The end is
// a 5-round butterfly over the 64-bit key (BH << 8 | 255 - t): the
// largest H, then the smallest t.  A pair runs exactly qlen + tlen - 1
// diagonals; the TPU layout (pairs padded to 8 rows and diagonals to
// chunks of 128, RMAX splits, the injection plane) is not ported.
//
// What bounds it on an H100: integer issue.  The recurrence needs ~13
// operations a cell (chip_smoke.py: OPS) and the kernel issues ~30 with
// the three-entry score, the band mask and the argmax; a diagonal's four shuffles are a chain
// the other warps of the SM hide.  Memory traffic is the sequences and
// 12 bytes of result a pair.
#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -1000000000;     // batch_local.py:_NEG
constexpr int LT_MAX = 128;          // targets a launch takes
constexpr int CELLS = 4;             // target positions a lane
constexpr int WARPS = 4;             // pairs a block
constexpr unsigned FULL = 0xffffffffu;

struct LocalArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  int B, Lq, Lt, m, mch, mis, scN, q, e;
  int* res;                          // (B, 3): score, te, qe
};

__global__ void __launch_bounds__(WARPS * 32)
local_fwd_kernel(const LocalArgs A) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= A.B) return;              // a whole warp
  const int qlen = A.qlens[b], tlen = A.tlens[b];
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const int t0 = lane * CELLS;
  int T[CELLS], H1[CELLS], H2[CELLS], E[CELLS], F[CELLS], Q[CELLS];
  int BH[CELLS], BR[CELLS];
  bool tN[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    T[k] = t0 + k < tlen ? (int)tg[t0 + k] : 0;
    tN[k] = T[k] == A.m - 1;
    H1[k] = H2[k] = 0;
    E[k] = F[k] = NEG;
    Q[k] = 0;
    BH[k] = 0;
    BR[k] = -1;
  }
  auto qload = [&](int c) {
    const int j = 32 * c + lane;
    return j < qlen ? (int)qy[j] : 0;
  };
  int qcur = qload(0), qnxt = qload(1);
  const int nd = qlen + tlen - 1;
  for (int r = 0; r < nd; ++r) {
    const int st0 = max(0, r - qlen + 1), en0 = min(tlen - 1, r);
    int hl1 = __shfl_up_sync(FULL, H1[CELLS - 1], 1);
    int hl2 = __shfl_up_sync(FULL, H2[CELLS - 1], 1);
    int el = __shfl_up_sync(FULL, E[CELLS - 1], 1);
    int ql = __shfl_up_sync(FULL, Q[CELLS - 1], 1);
    const int qr = __shfl_sync(FULL, qcur, r & 31);
    if (lane == 0) {
      hl1 = 0;
      hl2 = 0;
      el = NEG;
      ql = qr;
    }
    int Hn[CELLS], En[CELLS], Fn[CELLS], Qn[CELLS];
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int h1s = k ? H1[k - 1] : hl1;
      const int h2s = k ? H2[k - 1] : hl2;
      const int es = k ? E[k - 1] : el;
      Qn[k] = k ? Q[k - 1] : ql;
      int s = Qn[k] == T[k] ? A.mch : A.mis;
      if (tN[k] || Qn[k] == A.m - 1) s = A.scN;
      const int en = max(h1s - A.q, es) - A.e;
      const int fn = max(H1[k] - A.q, F[k]) - A.e;
      const int hn = __vimax3_s32_relu(h2s + s, en, fn);
      const bool band = t0 + k >= st0 && t0 + k <= en0;
      Hn[k] = band ? hn : 0;
      En[k] = band ? en : NEG;
      Fn[k] = band ? fn : NEG;
      if (Hn[k] > BH[k]) {           // outside the band Hn = 0 <= BH
        BH[k] = Hn[k];
        BR[k] = r;
      }
    }
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      H2[k] = H1[k];
      H1[k] = Hn[k];
      E[k] = En[k];
      F[k] = Fn[k];
      Q[k] = Qn[k];
    }
    if ((r & 31) == 31) {            // the next diagonal opens a chunk
      qcur = qnxt;
      qnxt = qload((r >> 5) + 2);
    }
  }
  // the largest H, then the smallest t: key = BH << 8 | (255 - t)
  long long key = -1;
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const long long kk = ((long long)BH[k] << 8) | (255 - (t0 + k));
    if (BH[k] > 0 && kk > key) key = kk;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long other = __shfl_xor_sync(FULL, key, o);
    if (other > key) key = other;
  }
  int V = 0, te = -1, qe = -1;
  if (key > 0) {                     // uniform across the warp
    V = (int)(key >> 8);
    te = 255 - (int)(key & 255);
    int br = BR[0];
#pragma unroll
    for (int k = 1; k < CELLS; ++k)
      if ((te & (CELLS - 1)) == k) br = BR[k];
    qe = __shfl_sync(FULL, br, te / CELLS) - te;
  }
  if (lane == 0) {
    int* out = A.res + (size_t)b * 3;
    out[0] = V;
    out[1] = te;
    out[2] = qe;
  }
}

}  // namespace

// One warp a pair, WARPS pairs a block.  qs (B, Lq) and ts (B, Lt <= 128)
// uint8 symbols, qlen and tlen (B,) int32 (0 <= qlen <= Lq, 0 <= tlen <=
// Lt), res (B, 3) int32.  Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int ksw2t_batch_local_fwd(const void* qs, const void* ts,
                                     const void* qlen, const void* tlen,
                                     int B, int Lq, int Lt, int m, int mch,
                                     int mis, int scN, int q, int e,
                                     void* res, void* stream) {
  if (B <= 0 || Lq < 0 || Lt < 0 || Lt > LT_MAX)
    return (int)cudaErrorInvalidValue;
  LocalArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
              (const int*)tlen, B, Lq, Lt, m, mch, mis, scN, q, e,
              (int*)res};
  local_fwd_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
