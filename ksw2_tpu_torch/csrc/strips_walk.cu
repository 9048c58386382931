// Strips walker (kernel B): ksw_backtrack over the strips forward's
// row-major direction bytes.
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
// `len << 4 | op` in walk order plus (i_end, j_end, run count) into Lq +
// tv + 2 entries a pair, so it cannot overflow.  The host then adds the
// tail D and I runs, merges and reverses
// (ops/strips_walker.py:finish_runs_batch).
//
// The walk is walk.cuh's ROWMAJOR form: a block of two warps a pair, the
// stager warp copying windows of the store into shared memory (the cells
// fewer than 64 anti-diagonals from the window's anchor: store row i0 - k
// at j in [j0 - 63 + k, j0], 16-byte cp.async chunks; rows of Lq % 16 ==
// 0 bytes and pair bases of tv Lq bytes keep them aligned), the walker
// warp taking up to four steps a block, its lanes' guesses at the block's
// movements read and stepped all at once; the ops go to a scratch and
// become runs at the walk's end.  No read of a walk from a cell the
// forward computed leaves its window (tests/test_torch_walk_launch.py);
// one that did would read the store itself, a step of its own.
//
// What bounds it on an H100: each pair's walk is one chain of blocks of
// one warp's dependent instructions (~185 cycles a step on the other
// forms, `chip_smoke.py --breakdown walk`), and a launch takes its
// longest walk.  Not memory latency, as before (one dependent byte load
// from the device's memory a step, ~670 cycles), and not bandwidth or
// arithmetic.
#include "walk.cuh"

using namespace ksw2t;

// `ops` is scratch of B * wr bytes (the walks' ops before their runs).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_strips_walk(const void* d8, const void* starts, int B,
                                 int tv, int Lq, int wr, int min_intron,
                                 void* res, void* runs, void* ops,
                                 void* stream) {
  if (B <= 0 || tv <= 0 || Lq <= 0 || Lq % 16 || wr < Lq + tv + 2)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(d8) & 15)
    return (int)cudaErrorMisalignedAddress;
  walk::Args a{(const uint8_t*)d8, nullptr, (const int*)starts, nullptr,
               nullptr, nullptr, B, tv, Lq, wr, min_intron, 0, (int*)res,
               (int*)runs, (uint8_t*)ops};
  return walk::launch<walk::ROWMAJOR>(a, (cudaStream_t)stream);
}
