// Rows forward: the one-piece extension DP for short pairs (q, t <= 128).
//
// Replaces ksw2_tpu/ops/wavefront_rows.py:_row_kernel_body (row-major
// extz, score-only).  It computes the same streams as strips_fwd.cu's
// one-piece score form, at the launch's canonical tv (<= 128): per global
// diagonal r = i + j the packed (H, merge key) maximum D[r], the
// query-end H Dq[r] and the last-row H hl[j], so ops/strips.py:
// replay_records serves both routes.  The TPU kernel's (128, B) planes,
// with pairs on lanes, and its own packing and replay are not ported.
//
// Layout: one warp per pair, WARPS pairs per block.  Small blocks spread a
// launch of a few hundred pairs over all SMs: on an H100 (700 W) the
// 502-pair short launch took 93 us at 8 pairs per block (63 blocks), 87 at
// 4, 76 at 2 and 74 at 1; 2 keeps 64 warps per SM possible, where 1-warp
// blocks would stop at the 32-blocks-per-SM limit.  Lane l owns the four
// consecutive query columns 4l .. 4l+3, and H and E of those columns
// live in registers.  H(i-1, j-1) across a lane edge comes from the left
// lane by __shfl_up_sync.  The F prefix max (spec/strips.py:17-21) runs
// serially over the lane's four columns, then as a five-step shuffle
// scan over the lanes.  D is a per-warp shared array of Lq + tv ints:
// each diagonal is touched at most once per row and the rows of a pair
// run in order within its warp, so the kernel needs no block barrier
// after the table load and no atomics, only __syncwarp.
//
// What bounds it on an H100: the latency of each row's dependent chain
// (about 0.6 us: score-table and D loads from shared memory, six
// shuffles, the merge key), so a pair of t rows is a chain of t steps;
// the card fills only when a launch holds thousands of pairs (132 SMs x
// many warps).  A pair costs one warp, not a block of barriers, which is
// what the strips kernel spends on these pairs.
#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 2;          // pairs per block
constexpr int COLS = 4;           // query columns per lane
constexpr int LQ_MAX = 32 * COLS;

__global__ void __launch_bounds__(32 * WARPS)
rows_fwd_kernel(const uint8_t* __restrict__ qs,
                const uint8_t* __restrict__ ts,
                const int* __restrict__ qlens, const int* __restrict__ tlens,
                const int* __restrict__ table, int B, int Lq, int tv, int m,
                int q, int e, int mat0, int kb, int* __restrict__ D,
                int* __restrict__ Dq, int* __restrict__ hl) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nd = Lq + tv;
  int* tab = smem;                          // [64] score table (m <= 8)
  int* Ds = smem + 64 + w * nd;             // [nd] this warp's diagonals
  for (int k = threadIdx.x; k < m * m; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;

  const int qlen = qlens[b], tlen = tlens[b];
  const int gapoe = q + e;
  int* Dqg = Dq + (size_t)b * nd;
  int* hlg = hl + (size_t)b * Lq;
  const uint8_t* trow = ts + (size_t)b * tv;
  for (int r = lane; r < nd; r += 32) {
    Ds[r] = SENT;
    if (r < qlen - 1 || r >= qlen - 1 + tlen) Dqg[r] = SENT;
  }
  for (int j = lane; j < Lq; j += 32)
    if (j >= qlen) hlg[j] = SENT;

  const int jb = COLS * lane;               // the lane's first column
  int H[COLS], E[COLS], qv[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int j = jb + k;
    H[k] = col_h(j, gapoe, e);              // virtual row: H(-1, j)
    E[k] = H[k] - gapoe;
    qv[k] = j < Lq ? qs[(size_t)b * Lq + j] : 0;
  }
  __syncwarp();

  for (int i = 0; i < tlen; ++i) {
    const int* sc = tab + trow[i] * m;
    int left = __shfl_up_sync(FULL, H[COLS - 1], 1);
    if (lane == 0) left = i == 0 ? 0 : col_h(i - 1, gapoe, e);
    int Hd[COLS], hnof[COLS], A[COLS];
    int tot = NEG;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      Hd[k] = k == 0 ? left : H[k - 1];
      hnof[k] = max(Hd[k] + sc[qv[k]], E[k]);
      A[k] = min(hnof[k], Hd[k] + mat0) + (jb + k) * e - q;
      tot = max(tot, A[k]);
    }
    // exclusive prefix max of the lane totals over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, tot, o);
      if (lane >= o) tot = max(tot, n);
    }
    int run = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) run = NEG;
    run = max(run, col_h(i, gapoe, e) - gapoe);   // F(i, 0)
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int j = jb + k;
      const int F = run - j * e;
      const int h = min(max(hnof[k], F), Hd[k] + mat0);
      run = max(run, A[k]);
      E[k] = max(E[k] - e, h - gapoe);
      H[k] = h;
      if (j < qlen) {
        const int r = i + j;
        const int packed =
            h * kb + (kb - 1 - merge_key(i, r, qlen, tlen, tv));
        Ds[r] = max(Ds[r], packed);
        if (j == qlen - 1) Dqg[r] = h;
        if (i == tlen - 1) hlg[j] = h;
      }
    }
    __syncwarp();
  }
  int* Dg = D + (size_t)b * nd;
  for (int r = lane; r < nd; r += 32) Dg[r] = Ds[r];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_rows_fwd(const void* qs, const void* ts,
                              const void* qlen, const void* tlen,
                              const void* table, int B, int Lq, int tv,
                              int m, int q, int e, int mat0, int kb, void* D,
                              void* Dq, void* hl, void* stream) {
  if (B <= 0 || Lq <= 0 || Lq > LQ_MAX || tv > LQ_MAX || m > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (64 + (size_t)WARPS * (Lq + tv)) * sizeof(int);
  rows_fwd_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, smem,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
      (const int*)tlen, (const int*)table, B, Lq, tv, m, q, e, mat0, kb,
      (int*)D, (int*)Dq, (int*)hl);
  return (int)cudaGetLastError();
}
