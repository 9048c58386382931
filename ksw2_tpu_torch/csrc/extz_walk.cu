// Single-pair walker (kernel 17): ksw_backtrack over the compact byte
// store of the single-pair forward (extz_fwd.cu).
//
// Replaces ksw2_tpu/ops/traceback_device.py:_tb_kernel (the reverse-block
// walk over the streamed direction matrix).  It runs the reference's
// backtrack (ksw2.h:129-161) with is_rot = 1 from each pair's start cell:
// r = i + j, the byte of cell i at pbase[b] + off(r) + (i - st(r)), with
// st(r), en(r) the 16-rounded band bounds and off(r) the store's row
// offset (common.cuh: band_row, store_row_width, store_row_off).  The
// band-edge force states are 2 when i < st(r) and, with upper_force
// (extz), 1 when i > en(r); with upper_force = 0 (gg2's NULL off_end) a
// walk that goes above the band would read past its row, so it stops
// there, before any read, and sets the escape flag, and the caller must
// not use its runs.  min_intron > 0 walks state 3 as N.  It writes BAM
// runs `len << 4 | op` in walk order and (i_end, j_end, run count,
// escaped) into qlen + tlen + 2 entries a pair, so it cannot overflow;
// the host adds the tail runs, merges and reverses
// (ops/strips_walker.py:finish_runs_batch).
//
// The walk is walk.cuh's COMPACT form: a block of two warps a pair, the
// stager warp copying windows of 64 rows of the store into shared memory
// (16-byte cp.async chunks, the rows' offsets from a warp prefix sum of
// their widths), the walker warp taking up to four steps a block, its
// lanes' guesses at the block's movements read and stepped all at once.
//
// What bounds it on an H100: each pair's walk is one chain of blocks of
// one warp's dependent instructions (~200 cycles a step on the 50 kb
// pair's ~55k steps, `chip_smoke.py --breakdown walk`); the window's
// copies land long before the walk needs them.  Not memory latency, as
// before (one dependent byte from the device's memory a step), and not
// bandwidth or arithmetic.
#include "walk.cuh"

using namespace ksw2t;

// Returns cudaGetLastError() after the launch (0 on success).
// `ops` is scratch of B * wr bytes (the walks' ops before their runs).
extern "C" int ksw2t_extz_walk(const void* p, const void* pbase,
                               const void* starts, const void* qlen,
                               const void* tlen, const void* w, int B, int wr,
                               int min_intron, int upper_force, void* res,
                               void* runs, void* ops, void* stream) {
  if (B <= 0 || wr <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(p) & 15)
    return (int)cudaErrorMisalignedAddress;
  walk::Args a{(const uint8_t*)p, (const long long*)pbase, (const int*)starts,
               (const int*)qlen, (const int*)tlen, (const int*)w, B, 0, 0,
               wr, min_intron, upper_force, (int*)res, (int*)runs,
               (uint8_t*)ops};
  return walk::launch<walk::COMPACT>(a, (cudaStream_t)stream);
}
