// Definitions shared by the strips forward (strips_fwd.cu), the rows
// forward (rows_fwd.cu) and the strips walker (strips_walk.cu): the
// record sentinel, the virtual column boundaries, the SSE merge-order
// tie key and the direction-byte codes.  Their Python twins live in
// ksw2_tpu_torch/ops/strips.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ksw2t {

// "no value" in the packed record streams: -(2**31) + 1
constexpr int SENT = -2147483647;

// Direction byte (ksw2.h:129-161): bits 0-2 hold the state that won the
// cell (0 = diagonal, 1 = E / deletion, 2 = F / insertion; two-piece
// adds 3 = E2 / long deletion, 4 = F2 / long insertion); bits 3 and 4
// say that E and F continue into the cell above / left, bits 5 and 6
// the same for E2 and F2 (ksw2_extd2_sse.c:191-322).
constexpr int DIR_E = 1;
constexpr int DIR_F = 2;
constexpr int DIR_E2 = 3;
constexpr int DIR_F2 = 4;
constexpr int DIR_E_CONT = 0x08;
constexpr int DIR_F_CONT = 0x10;
constexpr int DIR_E2_CONT = 0x20;
constexpr int DIR_F2_CONT = 0x40;

// H(i, -1): the reference's virtual-column boundary -(q + e + e*i).
__device__ __forceinline__ int col_h(int i, int gapoe, int e) {
  return -(gapoe + e * i);
}

// Two-piece H(i, -1) (and H(-1, i)): steps of -e until long_thres, the
// step long_diff at it, -e2 after (ksw2_extd2_sse.c:156-163).
__device__ __forceinline__ int col_h2(int i, int gapoe, int e, int e2,
                                      int lt, int ld) {
  return i < lt ? -(gapoe + e * i)
                : -(gapoe + e * (lt - 1)) + ld - e2 * (i - lt);
}

// ksw_extz2_sse's exact-max merge-order rank of cell (i, r - i) on
// diagonal r (spec/strips.py:merge_key): the en0 cell first, then the
// SSE vector region [st0, en1) by (lane class, i), then the scalar tail.
// Smaller ranks win score ties.
__device__ __forceinline__ int merge_key(int i, int r, int qlen, int tlen,
                                         int tv) {
  const int st0 = max(0, r - qlen + 1);
  const int en0 = min(tlen - 1, r);
  if (i == en0) return 0;
  const int en1 = st0 + ((en0 - st0) & -4);
  return i < en1 ? ((i - st0) & 3) * tv + i + 1 : 4 * tv + i + 1;
}

}  // namespace ksw2t

extern "C" const char* ksw2t_error_string(int err);
