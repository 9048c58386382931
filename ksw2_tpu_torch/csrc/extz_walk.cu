// Single-pair walker (kernel 17): ksw_backtrack over the compact byte
// store of the single-pair forward (extz_fwd.cu).
//
// Replaces ksw2_tpu/ops/traceback_device.py:_tb_kernel (the reverse-block
// walk over the streamed direction matrix).  It runs the reference's
// backtrack (ksw2.h:129-161) with is_rot = 1 from each pair's start cell:
// r = i + j, the byte of cell i at pbase[b] + off(r) + (i - st(r)), with
// st(r), en(r) the 16-rounded band bounds and off(r) the store's row
// offset, both in closed form (common.cuh: band_row, store_row_off; off
// moves with r one row width at a time).  The band-edge force states are
// 2 when i < st(r) and, with upper_force (extz), 1 when i > en(r); with
// upper_force = 0 (gg2's NULL off_end) a walk that goes above the band
// would read past its row, so it stops there and sets the escape flag, and
// the caller must not use its runs.  min_intron > 0 walks state 3 as N.
// The per-byte state step and the run writer are common.cuh's, as in
// band_walk.cu.  It writes BAM runs `len << 4 | op` in walk order and
// (i_end, j_end, run count, escaped) into qlen + tlen + 2 entries a pair,
// so it cannot overflow; the host adds the tail runs, merges and reverses
// (ops/strips_walker.py:finish_runs_batch).
//
// What bounds it on an H100: one thread a pair walks a chain of up to
// qlen + tlen dependent one-byte loads from a store that does not stay in
// the 50 MB L2 (2.5 GB for an unbanded 50 kb pair): memory latency, not
// bandwidth or arithmetic.  All pairs of a bucket walk at once, one a
// thread; prefetching the next rows is later work.
#include "common.cuh"

using namespace ksw2t;

namespace {

__global__ void extz_walk_kernel(const uint8_t* __restrict__ p,
                                 const long long* __restrict__ pbase,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ qlens,
                                 const int* __restrict__ tlens,
                                 const int* __restrict__ ws, int B, int wr,
                                 int min_intron, int upper_force,
                                 int* __restrict__ res,
                                 int* __restrict__ runs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* d = p + pbase[b];
  const int qlen = qlens[b], tlen = tlens[b], w = ws[b];
  RunWriter rw(runs + (size_t)b * wr);
  int i = starts[2 * b], j = starts[2 * b + 1];
  int state = 0, esc = 0;
  int r = i + j;
  long long off = i >= 0 && j >= 0 ? store_row_off(r, qlen, tlen, w) : 0;
  while (i >= 0 && j >= 0) {
    const BandRow bd = band_row(r, qlen, tlen, w);
    int force = i < bd.st ? DIR_F : -1;
    if (i > bd.en) {
      if (!upper_force) {
        esc = 1;
        break;
      }
      force = DIR_E;
    }
    const int tmp = force < 0 ? d[off + (i - bd.st)] : 0;
    state = backtrack_step(state, tmp, force);
    const int o = state_op(state, min_intron);
    step_back(o, i, j);
    rw.push(o);
    if (i >= 0 && j >= 0) {
      for (const int nr = i + j; r > nr;) {
        --r;
        off -= store_row_width(r, qlen, tlen, w);
      }
    }
  }
  rw.flush();
  res[4 * b] = i;
  res[4 * b + 1] = j;
  res[4 * b + 2] = rw.k;
  res[4 * b + 3] = esc;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_extz_walk(const void* p, const void* pbase,
                               const void* starts, const void* qlen,
                               const void* tlen, const void* w, int B, int wr,
                               int min_intron, int upper_force, void* res,
                               void* runs, void* stream) {
  if (B <= 0 || wr <= 0) return (int)cudaErrorInvalidValue;
  constexpr int threads = 32;
  extz_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const long long*)pbase, (const int*)starts,
      (const int*)qlen, (const int*)tlen, (const int*)w, B, wr, min_intron,
      upper_force, (int*)res, (int*)runs);
  return (int)cudaGetLastError();
}
