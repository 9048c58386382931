// Strips walker: ksw_backtrack over the forward's direction bytes.
//
// Replaces ksw2_tpu/ops/strips_walker.py:_walk_kernel (3-state one-piece
// and 5-state two-piece and splice bytes, the `nop` form included).  It
// runs the reference's backtrack state machine (ksw2.h:129-161, is_rot =
// 0; the strips store is effectively unbanded, so there are no band-edge
// force states) from each pair's start cell over the row-major byte store
// d8[b][i][j] that strips_fwd.cu writes; states 3 and 4 and their 0x20 /
// 0x40 continuation bits take the same path as 1 and 2, and state 3
// emits N instead of D when min_intron > 0 (splice bytes, min_intron_len
// = long_thres, strips_walker.py:1075-1081).  It emits BAM runs
// `len << 4 | op` in walk order plus (i_end, j_end, run count).  The host
// then adds the tail D and I runs, merges and reverses
// (ops/strips_walker.py:finish_runs_batch).
//
// Layout: one thread per pair.  The walk is a chain of dependent one-byte
// loads, at most qlen + tlen of them, so it is bound by memory latency and
// not by bandwidth or arithmetic; pairs walk in parallel, one per thread.
// A run is consumed whole before it is written: the thread extends the
// open (op, len) run while the op repeats and stores it when the op
// changes, so the runs buffer holds at most one entry per step and is
// sized qlen + tlen + 2 per pair; it cannot overflow.
#include "common.cuh"

using namespace ksw2t;

namespace {

__global__ void strips_walk_kernel(const uint8_t* __restrict__ d8,
                                   const int* __restrict__ starts, int B,
                                   int tv, int Lq, int wr, int min_intron,
                                   int* __restrict__ res,
                                   int* __restrict__ runs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* d = d8 + (size_t)b * tv * Lq;
  RunWriter rw(runs + (size_t)b * wr);
  int i = starts[2 * b], j = starts[2 * b + 1];
  int state = 0;
  while (i >= 0 && j >= 0) {
    state = backtrack_step(state, d[(size_t)i * Lq + j], -1);
    const int o = state_op(state, min_intron);
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
extern "C" int ksw2t_strips_walk(const void* d8, const void* starts, int B,
                                 int tv, int Lq, int wr, int min_intron,
                                 void* res, void* runs, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  constexpr int threads = 32;
  strips_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)d8, (const int*)starts, B, tv, Lq, wr, min_intron,
      (int*)res, (int*)runs);
  return (int)cudaGetLastError();
}
