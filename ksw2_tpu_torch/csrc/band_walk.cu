// Band walker: ksw_backtrack over the band forward's rotated byte store,
// and, in its flat form, over gg2's flat store.
//
// Replaces ksw2_tpu/ops/traceback_band.py:_band_tb_kernel (one reverse
// sweep that walks every pair's traceback on the band bytes, with the
// device RLE of band_batch.py:device_walk_*).  It runs the reference's
// backtrack (ksw2.h:129-161) with is_rot = 1 from each pair's start cell
// over the store band_fwd.cu writes, p[b][r][t - st(r)]: r = i + j, the
// byte at p[b][r][i - st(r)], and the band-edge force states, 2 when
// i < st(r) and 1 when i > en(r).  st(r) and en(r), the 16-rounded band
// bounds, are recomputed in closed form from (r, qlen, tlen, w), so no
// offset arrays are stored.  The per-byte state step and the run writer
// are strips_walk.cu's (common.cuh); with min_intron > 0 state 3 emits N
// (the splice bytes of batch_exts_fwd.cu, min_intron_len = long_thres,
// traceback_band.py:46, 128).  It emits BAM runs `len << 4 | op`
// in walk order plus (i_end, j_end, run count) into qlen + tlen + 2
// entries per pair, so it cannot overflow; the host adds the tail runs,
// merges and reverses (ops/strips_walker.py:finish_runs_batch).
//
// The flat form walks the bytes gg2_fwd.cu writes (both forms) in the
// reference's layout: pair b's rows from pbase[b], row r n_col = ((min(w +
// 1, tlen) + 15) / 16 + 1) * 16 bytes, cell i at r * n_col + i - st(r),
// and a zero row after the last.  It runs ksw_backtrack as
// ksw_gg2_sse calls it (ksw2_gg2_sse.c:124): is_rot = 1, off = st(r) and
// off_end NULL, so only the lower force state (2 when i < st(r)) applies,
// and a walk that leaves the band upward reads on into the next rows'
// bytes as the reference's does; past the pair's store it reads 0
// (spec/backtrack.py:_read).  It replaces the host walk of the JAX
// package's gg2 routes (batch_pallas.py:1966-1974, gg2.py:114-138).
//
// What bounds it on an H100: one thread per pair walks a chain of
// dependent one-byte loads, up to qlen + tlen of them, scattered over a
// store of n_diag * n_col bytes a pair (15 MB for a 10 kb pair at
// w = 751) that does not stay in the 50 MB L2 for a whole batch.  So it
// is bound by memory latency, not by bandwidth or arithmetic; the design
// only keeps pairs walking in parallel, one per thread.  Making it faster
// (prefetching the next diagonals' bytes, a warp per pair) is later work.
#include "common.cuh"

using namespace ksw2t;

namespace {

__global__ void band_walk_kernel(const uint8_t* __restrict__ p,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ qlens,
                                 const int* __restrict__ tlens,
                                 const int* __restrict__ ws, int B, int nd,
                                 int ncol, int wr, int min_intron,
                                 int* __restrict__ res,
                                 int* __restrict__ runs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* d = p + (size_t)b * nd * ncol;
  const int qlen = qlens[b], tlen = tlens[b], w = ws[b];
  RunWriter rw(runs + (size_t)b * wr);
  int i = starts[2 * b], j = starts[2 * b + 1];
  int state = 0;
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    const int st = max(max(0, r - qlen + 1), (r - w + 1) >> 1) & ~15;
    const int en = min(min(tlen - 1, r), (r + w) >> 1) | 15;
    int force = i < st ? DIR_F : -1;
    if (i > en) force = DIR_E;
    const int tmp = force < 0 ? d[(size_t)r * ncol + (i - st)] : 0;
    state = backtrack_step(state, tmp, force);
    const int o = state_op(state, min_intron);
    step_back(o, i, j);
    rw.push(o);
  }
  rw.flush();
  res[3 * b] = i;
  res[3 * b + 1] = j;
  res[3 * b + 2] = rw.k;
}

__global__ void flat_walk_kernel(const uint8_t* __restrict__ p,
                                 const long long* __restrict__ pbase,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ qlens,
                                 const int* __restrict__ tlens,
                                 const int* __restrict__ ws, int B, int wr,
                                 int* __restrict__ res,
                                 int* __restrict__ runs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* d = p + pbase[b];
  const int qlen = qlens[b], tlen = tlens[b], w = ws[b];
  const long long ncol = ((min(w + 1, tlen) + 15) / 16 + 1) * 16;
  const long long size = (long long)(qlen + tlen) * ncol;   // + zero row
  RunWriter rw(runs + (size_t)b * wr);
  int i = starts[2 * b], j = starts[2 * b + 1];
  int state = 0;
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    const int st = max(max(0, r - qlen + 1), (r - w + 1) >> 1) & ~15;
    const int force = i < st ? DIR_F : -1;
    const long long k = r * ncol + (i - st);
    const int tmp = force < 0 && k < size ? d[k] : 0;
    state = backtrack_step(state, tmp, force);
    const int o = state_op(state, 0);
    step_back(o, i, j);
    rw.push(o);
  }
  rw.flush();
  res[3 * b] = i;
  res[3 * b + 1] = j;
  res[3 * b + 2] = rw.k;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_band_walk(const void* p, const void* starts,
                               const void* qlen, const void* tlen,
                               const void* w, int B, int nd, int ncol,
                               int wr, int min_intron, void* res, void* runs,
                               void* stream) {
  if (B <= 0 || ncol % 16) return (int)cudaErrorInvalidValue;
  constexpr int threads = 32;
  band_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const int*)starts, (const int*)qlen,
      (const int*)tlen, (const int*)w, B, nd, ncol, wr, min_intron,
      (int*)res, (int*)runs);
  return (int)cudaGetLastError();
}

// Flat form: gg2's store (see above).  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int ksw2t_flat_walk(const void* p, const void* pbase,
                               const void* starts, const void* qlen,
                               const void* tlen, const void* w, int B, int wr,
                               void* res, void* runs, void* stream) {
  if (B <= 0 || wr <= 0) return (int)cudaErrorInvalidValue;
  constexpr int threads = 32;
  flat_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const long long*)pbase, (const int*)starts,
      (const int*)qlen, (const int*)tlen, (const int*)w, B, wr, (int*)res,
      (int*)runs);
  return (int)cudaGetLastError();
}
