// Banded global alignment forward (gg2_sse): the batched form, one warp a
// pair (kernel 8), and the single-pair form, one block a pair (kernel 16).
//
// Replaces ksw2_tpu/ops/wavefront_batch_gg2.py:_batch_gg2_kernel
// (batched, counted as batch_gg2_fwd) and ksw2_tpu/ops/wavefront_gg2.py:
// _gg2_kernel_body (single pair, counted as gg2_fwd).  Both compute what
// spec/diagdiff.py:gg2_sse specifies (ksw2_gg2_sse.c): per anti-diagonal
// r = i + j the deltas u, v, x, y in wrapping int8 over the 16-rounded
// band [st, en], the score bytes gathered from the matrix over [st0, en0]
// (gg2 always scores through it, ksw2_gg2_sse.c:60-66), no unsigned
// clamp, the direction byte of every cell of [st, en], and the O(1) H0
// walk that reconstructs the corner score.  No band stops the sweep: a
// rounded band that is empty skips the update and leaves its byte row
// zero, and the walk still advances (global alignment reaches the
// corner).
//
// The bytes go to the reference's flat layout (ksw2_gg2_sse.c:41-47):
// pair b's rows start at pbase[b], row r is n_col = ((min(w + 1, tlen) +
// 15) / 16 + 1) * 16 bytes, cell i sits at r * n_col + i - st(r), and one
// zero row follows the last (the caller zeroes the store).  gg2's
// backtrack has no upper clamp (NULL off_end), so a walk that leaves the
// band upward reads the next row's bytes, as the reference's does;
// band_walk.cu's flat form walks this store.
//
// The single-pair form keeps the reference's one allocation of u, v, x, y
// and s (ksw2_gg2_sse.c:32-34): a zeroed global block a pair, the five
// arrays at a stride of tlen_ * 16 bytes and s 16 bytes longer.  When
// qlen > tlen + w the bands go empty and the H0 walk runs past u into v,
// x, y and s; reading that block gives the reference's bytes exactly
// (spec/diagdiff.py:_blk_u8; past the block it reads 0).  The batched form
// takes only pairs with qlen <= tlen + w (the JAX route's rule), keeps its
// strips in shared memory, and reads v[lt] and u[lt + 1] in its own strips
// clamped to TP - 1, which such pairs never reach.
//
// Layout and barriers are batch_extf_fwd.cu's: one warp a pair (batched)
// or one block a pair (single), the band cut into one segment a warp,
// lane l owning t = lo + 32 c + l, the old x[t - 1] and v[t - 1] from
// lane l - 1 by __shfl_up_sync, a segment's first from a read before the
// group barrier, in-place writes after it, and the walk after a second
// barrier, computed by every thread.  One block a pair also keeps the
// contiguous block exact, which tiles over many SMs could not.
//
// What bounds it on an H100: the serial chain of qlen + tlen - 1
// diagonals, each a few chunk steps and two barriers; a cell costs ~60
// integer operations as written here against the recurrence's ~30 and the
// byte's ~11 (chip_smoke.py: OPS, BYTE_OPS), and each cell writes its
// direction byte once, which is the only large memory traffic (0.55 GB
// for an unbanded 16.5 kb pair, ~0.2 ms at the card's rate).  This is the
// simple version that is right; DPX byte SIMD is later work.
#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int MAX_WARPS = 8;        // pairs a block, batched form
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

struct Gg2Args {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const int* table;
  const long long* pbase;
  int B, Lq, Lt, m, q, e, TP;
  long long blk;           // single-pair form: bytes of a pair's block
  int* score;
  uint8_t* p;
  signed char* scratch;    // single-pair form: B x blk bytes, zeroed
};

template <bool SINGLE>
__global__ void __launch_bounds__(SINGLE ? 1024 : MAX_WARPS * 32)
gg2_fwd_kernel(const Gg2Args A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int W = SINGLE ? (int)(blockDim.x >> 5) : 1;
  const int g = SINGLE ? (int)(threadIdx.x >> 5) : 0;
  const int b = SINGLE ? (int)blockIdx.x
                       : (int)(blockIdx.x * (blockDim.x >> 5) +
                               (threadIdx.x >> 5));
  if (b >= A.B) return;              // a whole warp (batched form)
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  // the single-pair block's stride is the reference's tlen_ * 16; the
  // batched strips' is TP
  const int NS = SINGLE ? (tlen + 15) & ~15 : A.TP;
  signed char* u = SINGLE ? A.scratch + (size_t)b * A.blk
                          : reinterpret_cast<signed char*>(smem) +
                                (size_t)(threadIdx.x >> 5) * 5 * A.TP;
  signed char* v = u + NS;
  signed char* x = v + NS;
  signed char* y = x + NS;
  signed char* s = y + NS;
  auto gsync = [&]() {
    if (SINGLE)
      __syncthreads();
    else
      __syncwarp();
  };
  // unsigned byte k of array `region` (0 = u, 1 = v) as the H0 walk reads
  // it: through the contiguous block (single) or in the strip (batched)
  auto rd = [&](int region, int k) -> int {
    if (SINGLE) {
      const long long f = (long long)region * NS + k;
      return f < 5LL * NS + 16 ? (int)(uint8_t)u[f] : 0;
    }
    return (int)(uint8_t)(region ? v : u)[min(k, A.TP - 1)];
  };

  const int q = A.q, qe = A.q + A.e;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  if (!SINGLE) {                     // the reference's zeroed arrays
    for (int t = lane; t < 5 * A.TP; t += 32) u[t] = 0;
    __syncwarp();
  }
  const int wc = min(w + 1, tlen);
  const int ncol = ((wc + 15) / 16 + 1) * 16;
  uint8_t* prow = A.p + A.pbase[b];

  const int nd = qlen + tlen - 1;
  int last_st = -1, last_en = -1, H0 = 0, lt = 0;
  for (int r = 0; r < nd; ++r) {
    const BandRow bd = band_row(r, qlen, tlen, w);
    const int st0 = bd.st0, en0 = bd.en0, st = bd.st, en = bd.en;
    if (st <= en) {
      if (en - st + 1 > ncol) __trap();   // the row width (never: w + 1)
      // x[st - 1], v[st - 1] enter lane st (ksw2_gg2_sse.c:48-53)
      int X1 = 0, V1 = 0;
      if (st > 0) {
        if (last_st <= st - 1 && st - 1 <= last_en) {
          X1 = x[st - 1];
          V1 = v[st - 1];
        }
      } else {
        V1 = w8(r ? q : 0);
      }
      const int seg = (((en - st + 1) + W - 1) / W + 31) & ~31;
      const int lo = st + g * seg, sh = min(lo + seg - 1, en);
      int cX = X1, cV = V1;          // old x, v of t - 1 for lane 0
      if (g > 0 && lo <= en) {
        cX = x[lo - 1];
        cV = v[lo - 1];
      }
      gsync();
      uint8_t* pr = prow + (long long)r * ncol;
      for (int c0 = lo; c0 <= sh; c0 += 32) {
        const int t = c0 + lane;
        const bool in = t <= sh;
        int Uo = 0, Vo = 0, Xo = 0, Yo = 0;
        if (in) {
          if (t >= st0 && t <= en0)
            s[t] = (signed char)A.table[tg[t] * A.m + qy[r - t]];
          Uo = u[t];
          Vo = v[t];
          Xo = x[t];
          Yo = y[t];
        }
        int Xm = __shfl_up_sync(FULL, Xo, 1);
        int Vm = __shfl_up_sync(FULL, Vo, 1);
        if (lane == 0) {
          Xm = cX;
          Vm = cV;
        }
        cX = __shfl_sync(FULL, Xo, 31);
        cV = __shfl_sync(FULL, Vo, 31);
        if (in) {
          // the first-column presets u[r] = q (0 at r = 0), y[r] = 0
          const int ut = t == r ? w8(r ? q : 0) : Uo;
          const int yt = t == r ? 0 : Yo;
          const int zz = w8(s[t] + 2 * qe);
          const int a = w8(Xm + Vm), bb = w8(yt + ut);
          int d = a > zz ? 1 : 0;
          int z = a > zz ? a : zz;
          if (bb > z) d = 2;
          if ((bb & 255) > (z & 255)) z = bb;   // unsigned max, no clamp
          u[t] = (signed char)(z - Vm);
          v[t] = (signed char)(z - ut);
          const int z2 = w8(z - q);
          const int a2 = w8(a - z2), b2 = w8(bb - z2);
          d |= a2 > 0 ? DIR_E_CONT : 0;
          d |= b2 > 0 ? DIR_F_CONT : 0;
          x[t] = (signed char)(a2 > 0 ? a2 : 0);
          y[t] = (signed char)(b2 > 0 ? b2 : 0);
          pr[t - st] = (uint8_t)d;
        }
      }
      gsync();
    }
    // the O(1) H0 walk along the band (ksw2_gg2_sse.c:102-106); the next
    // diagonal's first barrier orders these reads before its writes
    if (r == 0) {
      H0 = rd(1, 0) - 2 * qe;
      lt = 0;
    } else if (lt >= st0 && lt <= en0) {
      H0 += rd(1, lt) - qe;
    } else {
      ++lt;
      H0 += rd(0, lt) - qe;
    }
    last_st = st;
    last_en = en;
  }
  if (lane == 0 && g == 0) A.score[b] = H0;
}

}  // namespace

// Batched form (kernel 8): one warp a pair, `warps` pairs a block, the
// strips (5 x TP bytes a warp) in shared memory; p the flat store of
// every pair, pair b's at pbase[b] (zeroed by the caller).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_batch_gg2_fwd(const void* qs, const void* ts,
                                   const void* qlen, const void* tlen,
                                   const void* w, const void* table,
                                   const void* pbase, int B, int Lq, int Lt,
                                   int m, int q, int e, int TP, int warps,
                                   void* score, void* p, void* stream) {
  if (B <= 0 || warps <= 0 || warps > MAX_WARPS || TP % 32 ||
      TP < Lt + 16 || p == nullptr)
    return (int)cudaErrorInvalidValue;
  Gg2Args a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
            (const int*)tlen, (const int*)w, (const int*)table,
            (const long long*)pbase, B, Lq, Lt, m, q, e, TP, 0,
            (int*)score, (uint8_t*)p, nullptr};
  const size_t smem = (size_t)warps * 5 * TP;
  cudaError_t err = cudaFuncSetAttribute(
      gg2_fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gg2_fwd_kernel<false><<<(B + warps - 1) / warps, warps * 32, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Single-pair form (kernel 16): one block of `warps` warps a pair, the
// reference's u, v, x, y, s block of each pair at b * blk in `scratch`
// (zeroed by the caller; blk >= 5 * round_up(tlen, 16) + 16).
extern "C" int ksw2t_gg2_fwd(const void* qs, const void* ts,
                             const void* qlen, const void* tlen,
                             const void* w, const void* table,
                             const void* pbase, int B, int Lq, int Lt, int m,
                             int q, int e, long long blk, int warps,
                             void* scratch, void* score, void* p,
                             void* stream) {
  if (B <= 0 || warps <= 0 || warps > 32 || p == nullptr ||
      scratch == nullptr || blk < 5LL * ((Lt + 15) & ~15) + 16)
    return (int)cudaErrorInvalidValue;
  Gg2Args a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
            (const int*)tlen, (const int*)w, (const int*)table,
            (const long long*)pbase, B, Lq, Lt, m, q, e, 0, blk,
            (int*)score, (uint8_t*)p, (signed char*)scratch};
  gg2_fwd_kernel<true><<<B, warps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
