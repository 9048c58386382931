// Batched local alignment (affine Smith-Waterman), one warp a pair
// (kernel 18).
//
// Replaces ksw2_tpu/ops/batch_local.py:_local_kernel (counted as
// batch_local_fwd).  It computes what that kernel computes, the
// recurrence in absolute int32 (i the query position, t the target
// position):
//
//   H(i, t) = max(0, H(i-1, t-1) + s, E(i, t), F(i, t))
//   E(i, t) = max(H(i, t-1) - q, E(i, t-1)) - e         (consumes target)
//   F(i, t) = max(H(i-1, t) - q, F(i-1, t)) - e         (consumes query)
//
// with H = 0 and E = F = NEG outside the pair (i < 0, i >= qlen, t < 0,
// t >= tlen).  The score s reads three entries of the matrix, as the JAX
// kernel does (batch_local.py:88-91): sc_mch when the raw symbols are
// equal, sc_mis otherwise, sc_N when either is m - 1.  Each target
// position keeps its first strict best in the order of the anti-diagonals
// r = i + t (BH, and the row BI where it was reached); the result is V =
// max BH, te = the smallest t with BH = V and qe = BI[te], which is the
// oracle's row-major first best (spec/local.py), or (0, -1, -1) when no
// cell scores above 0.  The plain version is ops/batch_local.py:
// local_forward_plain.
//
// Layout: one warp a pair, targets of up to 128 positions (the JAX
// contract, batch_local.py:200); lane l holds t = 4l .. 4l + 3 in
// registers (H and F of the previous query row, the target symbols, BH,
// BI) and the warp sweeps the query rows i = 0 .. qlen - 1, so every
// lane-cell inside the target is live on every step (an anti-diagonal
// sweep runs qlen + tlen - 1 steps, half of them masked on a square
// pair).  For a fixed t the rows come in the order of the diagonals (i
// increasing), so each position's first strict best is the one the
// anti-diagonal order gives.  One row:
//
// * H(i-1, t-1) from the lane's own previous-row registers, for its first
//   cell from lane l - 1 by one __shfl_up_sync (lane 0 takes 0);
// * F = max(H(i-1, t) + a, F(i-1, t) - e) with a = -(q + e): one
//   __viaddmax_s32;
// * the partial H' = max(0, H(i-1, t-1) + s, F): one __vimax_s32_relu;
// * E runs along the row, a prefix max-plus scan over H':
//   E(t) = max(H'(t-1) + a, E(t-1) + c) with c = max(-q, 0) - e (H(t-1)
//   = max(H'(t-1), E(t-1)), so E(t-1) - q only wins when q < 0), E(0) =
//   a from the boundary H(i, -1) = 0.  A lane runs its 4 cells with no
//   carry in, the warp scans the lanes' carries out in 5 __shfl_up_sync
//   rounds with the decay 4 c a lane, and each cell takes the carry into
//   its lane decayed by its distance: exact for any q and e;
// * H = max(H', E); BH and BI by __vibmax_s32 (max and its predicate).
//
// Cells at t >= tlen compute values nothing reads (E and H' flow to
// larger t, F stays in its column) and are left out of the argmax.  The
// row's query symbol is one broadcast, loaded 32 rows a chunk with the
// next chunk's load in flight.  The end is a 5-round butterfly over the
// 64-bit key (BH << 8 | 255 - t): the largest H, then the smallest t.
// Warp w takes pair w.  The TPU layout (pairs padded to 8 rows and
// diagonals to chunks of 128, RMAX splits, the injection plane) is not
// ported.
//
// What bounds it on an H100: integer issue on many pairs, a row's chain on
// few.  The recurrence needs ~13 operations a cell (chip_smoke.py: OPS);
// a row here is ~16 a cell on the integer pipe (the score's compare and
// select, F's decay, E's lane pass and fix-up, the best's max and select)
// and ~1 a cell for the scan and broadcasts, on all 128 lane-cells
// whatever tlen.  A row's chain (7 shuffles and ~15 dependent operations)
// bounds a launch where a scheduler holds one or two warps.  Memory
// traffic is the sequences and 12 bytes of result a pair.
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
  // the gap costs: a opens (H - q - e), c extends E along the row, ne
  // extends F down the column
  const int a = -(A.q + A.e), c = max(-A.q, 0) - A.e, ne = -A.e;
  // a cell's target symbol (-1 for N: never a query symbol) and its score
  // when the symbols differ (sc_N for an N target)
  int T[CELLS], MS[CELLS];
  // H of the previous row, F, the best and its row
  int Hp[CELLS], F[CELLS], BH[CELLS], BI[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int s = t0 + k < tlen ? (int)tg[t0 + k] : 0;
    T[k] = s == A.m - 1 ? -1 : s;
    MS[k] = s == A.m - 1 ? A.scN : A.mis;
    Hp[k] = 0;
    F[k] = NEG;
    BH[k] = 0;
    BI[k] = -1;
  }
  // the lanes' scan: the decay of a carry over 4, 8, .. 64 positions
  int dec[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) dec[j] = (CELLS << j) * c;
  auto qload = [&](int ch) {
    const int j = 32 * ch + lane;
    return j < qlen ? (int)qy[j] : 0;
  };
  int qcur = qload(0), qnxt = qload(1);
  for (int i = 0; i < qlen; ++i) {
    const int Q = __shfl_sync(FULL, qcur, i & 31);
    int dl = __shfl_up_sync(FULL, Hp[CELLS - 1], 1);   // H(i-1, t0 - 1)
    if (lane == 0) dl = 0;
    int S[CELLS];
#pragma unroll
    for (int k = 0; k < CELLS; ++k) S[k] = T[k] == Q ? A.mch : MS[k];
    if (Q == A.m - 1) {              // a query N: the whole row (uniform)
#pragma unroll
      for (int k = 0; k < CELLS; ++k) S[k] = A.scN;
    }
    int Hq[CELLS];                   // H' = max(0, diagonal + s, F)
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int dg = k ? Hp[k - 1] : dl;
      F[k] = __viaddmax_s32(Hp[k], a, F[k] + ne);
      Hq[k] = __vimax_s32_relu(dg + S[k], F[k]);
    }
    // E: the lane's cells with no carry in, then its carry out
    int eL[CELLS];
    eL[0] = 0;                       // unused: cell 0 takes the carry alone
    eL[1] = Hq[0] + a;
#pragma unroll
    for (int k = 2; k < CELLS; ++k)
      eL[k] = __viaddmax_s32(Hq[k - 1], a, eL[k - 1] + c);
    int X = __viaddmax_s32(Hq[CELLS - 1], a, eL[CELLS - 1] + c);
    if (lane == 0) X = max(X, a + dec[0]);   // E(0) = a from t = -1
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int y = __shfl_up_sync(FULL, X, 1 << j);
      if (lane >= (1 << j)) X = __viaddmax_s32(y, dec[j], X);
    }
    int Ein = __shfl_up_sync(FULL, X, 1);    // E(t0)
    if (lane == 0) Ein = a;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int E = k ? __viaddmax_s32(Ein, k * c, eL[k]) : Ein;
      const int H = max(Hq[k], E);
      bool keep;
      BH[k] = __vibmax_s32(BH[k], H, &keep);   // keep: BH >= H
      BI[k] = keep ? BI[k] : i;
      Hp[k] = H;
    }
    if ((i & 31) == 31) {            // the next row opens a chunk
      qcur = qnxt;
      qnxt = qload((i >> 5) + 2);
    }
  }
  // the largest H, then the smallest t: key = BH << 8 | (255 - t)
  long long key = -1;
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const long long kk = ((long long)BH[k] << 8) | (255 - (t0 + k));
    if (BH[k] > 0 && t0 + k < tlen && kk > key) key = kk;
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
    int bi = BI[0];
#pragma unroll
    for (int k = 1; k < CELLS; ++k)
      if ((te & (CELLS - 1)) == k) bi = BI[k];
    qe = __shfl_sync(FULL, bi, te / CELLS);
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
