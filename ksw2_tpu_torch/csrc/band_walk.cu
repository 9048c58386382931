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
// offset arrays are stored.  The per-byte state step is common.cuh's;
// with min_intron > 0 state 3 emits N (the splice bytes of kernel 6,
// batch_fwd.cu's or band_fwd.cu's SPL form, min_intron_len = long_thres,
// traceback_band.py:46, 128).  It emits BAM runs `len << 4 | op` in walk order plus (i_end,
// j_end, run count) into qlen + tlen + 2 entries per pair, so it cannot
// overflow; the host adds the tail runs, merges and reverses
// (ops/strips_walker.py:finish_runs_batch).
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
// Both forms are walk.cuh's (ROTATED, FLAT): a block of two warps a pair,
// the stager warp copying windows of 64 rows of the store into shared
// memory, the walker warp taking up to four steps a block, its lanes'
// guesses at the block's movements read and stepped all at once.  Only
// the flat form's reads past a row's n_col bytes (and past its store) go
// to global memory, a step of their own.
//
// What bounds it on an H100: each pair's walk is one chain of blocks of
// one warp's dependent instructions (~150-200 cycles a step,
// `chip_smoke.py --breakdown walk`), and a launch takes its longest walk;
// the windows' copies land before they are needed.  Not memory latency,
// as before (one dependent byte a step), and not bandwidth or arithmetic.
#include "walk.cuh"

using namespace ksw2t;

// `ops` is scratch of B * wr bytes (the walks' ops before their runs).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_band_walk(const void* p, const void* starts,
                               const void* qlen, const void* tlen,
                               const void* w, int B, int nd, int ncol,
                               int wr, int min_intron, void* res, void* runs,
                               void* ops, void* stream) {
  if (B <= 0 || ncol % 16) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(p) & 15)
    return (int)cudaErrorMisalignedAddress;
  walk::Args a{(const uint8_t*)p, nullptr, (const int*)starts,
               (const int*)qlen, (const int*)tlen, (const int*)w, B, nd,
               ncol, wr, min_intron, 1, (int*)res, (int*)runs,
               (uint8_t*)ops};
  return walk::launch<walk::ROTATED>(a, (cudaStream_t)stream);
}

// Flat form: gg2's store (see above).  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int ksw2t_flat_walk(const void* p, const void* pbase,
                               const void* starts, const void* qlen,
                               const void* tlen, const void* w, int B, int wr,
                               void* res, void* runs, void* ops,
                               void* stream) {
  if (B <= 0 || wr <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(p) & 15)
    return (int)cudaErrorMisalignedAddress;
  walk::Args a{(const uint8_t*)p, (const long long*)pbase,
               (const int*)starts, (const int*)qlen, (const int*)tlen,
               (const int*)w, B, 0, 0, wr, 0, 0, (int*)res, (int*)runs,
               (uint8_t*)ops};
  return walk::launch<walk::FLAT>(a, (cudaStream_t)stream);
}
