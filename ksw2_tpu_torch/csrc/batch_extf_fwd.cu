// Linear-gap extension forward (extf2), batched: one warp a pair (kernel
// 7, counted as batch_extf_fwd).
//
// Replaces ksw2_tpu/ops/wavefront_batch_extf.py:_batch_extf_kernel.  It
// computes what spec/diagdiff.py:extf2 specifies (ksw2_extf2_sse.c): per
// anti-diagonal r = i + j the Suzuki-Kasahara deltas u, v in wrapping int8
// over the 16-rounded band [st, en], the score bytes filled over [st0,
// st0 + 16 floor((en0 - st0) / 16) + 15] by raw symbol equality (N matches
// N, as in the reference), z = max(s + 2e, v[t-1]) signed then unsigned
// max with u[t], and the O(1) H0 walk with the X-drop break
// (ksw2_extf2_sse.c:80-91).  A pair stops at its first empty band (the
// closed form of batch_pallas.py:42-48) or at an X-drop; both set
// zdropped ("not completed", ksw2_extf2_sse.c:49).  Score only: the
// output is the 9-field record of ops/records.py (mqe and mte are
// NEG_INF, their coordinates -1).  The plain version is
// ops/batch_extf.py:extf_forward_plain; the single-pair kernel 15 is
// lg_fwd.cu.
//
// Layout: a pair's u, v and s planes are strips in the t coordinate of TP
// bytes in shared memory, as the reference's own arrays are.  Lane l owns
// t = st + 32 c + l over the band [st, max(en, fill end)], reads its
// cell's old state, and takes the old v[t - 1] from lane l - 1 by
// __shfl_up_sync (lane 0 from lane 31 of the previous chunk, carried in
// registers).  The first old v[st - 1] is read before a warp barrier, and
// the writes are in place after it, so positions outside the band keep
// the reference's stale bytes.  The H0 walk reads v[lt] and u[lt + 1]
// after the second barrier; every lane computes it, so the per-pair
// scalars stay in registers and the loop's exit is uniform.
//
// What bounds it on an H100: the serial chain of diagonals (qlen + tlen -
// 1 of them), each a few chunk steps and two warp barriers; a cell costs
// ~40 integer operations as written here against the recurrence's ~7
// (chip_smoke.py: OPS, the bound).  No direction bytes are written, so
// memory traffic is the sequences and the records.  DPX byte SIMD is later
// work.
#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;    // NEG_INF of core/flags.py
constexpr int MAX_WARPS = 8;        // pairs a block, batched form
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

struct ExtfArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  int B, Lq, Lt, mch, mis, e, xdrop, TP;
  int* rec;
};

__global__ void __launch_bounds__(MAX_WARPS * 32)
extf_fwd_kernel(const ExtfArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int b = (int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
  if (b >= A.B) return;              // a whole warp
  const int TP = A.TP;
  signed char* u = reinterpret_cast<signed char*>(smem) +
                   (size_t)(threadIdx.x >> 5) * 3 * TP;
  signed char* v = u + TP;
  signed char* s = v + TP;

  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int e = A.e;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  int* out = A.rec + (size_t)b * 9;
  if (qlen <= 0 || tlen <= 0) {      // ksw_reset_extz: nothing to align
    if (lane == 0) {
      out[0] = 0; out[1] = -1; out[2] = -1; out[3] = NEG; out[4] = -1;
      out[5] = NEG; out[6] = -1; out[7] = NEG; out[8] = 0;
    }
    return;
  }
  for (int t = lane; t < 3 * TP; t += 32) u[t] = 0;   // the reference's
  __syncwarp();                                        // zeroed arrays

  const int ndb = qlen + tlen - 1;
  const int rlim = first_empty_diag(qlen, tlen, w);
  int last_st = -1, last_en = -1, H0 = 0, lt = 0;
  int mx = 0, mt = -1, mq = -1, zd = rlim < ndb ? 1 : 0;
  for (int r = 0; r < rlim; ++r) {
    const BandRow bd = band_row(r, qlen, tlen, w);
    const int st0 = bd.st0, en0 = bd.en0, st = bd.st, en = bd.en;
    // the 16-byte score fill's end (ksw2_extf2_sse.c:66-72)
    const int hi = st0 + ((en0 - st0) & ~15) + 15;
    const int top = max(en, hi);
    // v[st - 1] enters lane st when the previous band covered it
    const int V1 = (st > 0 && last_st <= st - 1 && st - 1 <= last_en)
                       ? (int)v[st - 1] : 0;
    int cV = V1;                     // old v[t - 1] of lane 0
    __syncwarp();
    for (int c0 = st; c0 <= top; c0 += 32) {
      const int t = c0 + lane;
      const bool in = t <= top;
      int Uo = 0, Vo = 0;
      if (in) {
        if (t >= st0 && t <= hi) {
          const int T = t < tlen ? tg[t] : 0;
          const int Q = r - t >= 0 && r - t < qlen ? qy[r - t] : 0;
          s[t] = (signed char)(T == Q ? A.mch : A.mis);
        }
        Uo = u[t];
        Vo = v[t];
      }
      int Vm = __shfl_up_sync(FULL, Vo, 1);
      if (lane == 0) Vm = cV;
      cV = __shfl_sync(FULL, Vo, 31);
      if (in && t <= en) {
        const int ut = t == r ? 0 : Uo;    // u[r] = 0 when en >= r
        int z = w8(s[t] + 2 * e);
        if (Vm > z) z = Vm;                 // signed max
        if ((ut & 255) > (z & 255)) z = ut; // unsigned max
        u[t] = (signed char)(z - Vm);
        v[t] = (signed char)(z - ut);
      }
    }
    __syncwarp();
    // the O(1) H0 walk and the X-drop (ksw2_extf2_sse.c:80-91)
    if (r == 0) {
      H0 = (int)(uint8_t)v[0] - 2 * e;
      lt = 0;
    } else {
      const bool c1 = lt >= st0 && lt <= en0;
      const bool c2 = lt + 1 >= st0 && lt + 1 <= en0;
      if (c1 && c2) {
        const int d0 = (int)(uint8_t)v[lt] - e;
        const int d1 = (int)(uint8_t)u[lt + 1] - e;
        if (d0 > d1) {
          H0 += d0;
        } else {
          H0 += d1;
          ++lt;
        }
      } else if (c1) {
        H0 += (int)(uint8_t)v[lt] - e;
      } else {
        ++lt;
        H0 += (int)(uint8_t)u[lt] - e;
      }
      if (H0 > mx) {
        mx = H0;
        mt = lt;
        mq = r - lt;
      } else if (A.xdrop >= 0 && mx - H0 > A.xdrop) {
        zd = 1;
        break;
      }
    }
    // the next diagonal's first barrier orders these reads before its
    // writes
    last_st = st;
    last_en = en;
  }
  if (lane == 0) {
    out[0] = mx; out[1] = mt; out[2] = mq; out[3] = NEG; out[4] = -1;
    out[5] = NEG; out[6] = -1; out[7] = zd ? NEG : H0; out[8] = zd;
  }
}

}  // namespace

// Kernel 7: one warp a pair, `warps` pairs a block, the strips (3 x TP
// bytes a warp) in shared memory.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ksw2t_batch_extf_fwd(const void* qs, const void* ts,
                                    const void* qlen, const void* tlen,
                                    const void* w, int B, int Lq, int Lt,
                                    int mch, int mis, int e, int xdrop,
                                    int TP, int warps, void* rec,
                                    void* stream) {
  if (B <= 0 || warps <= 0 || warps > MAX_WARPS || TP % 32 ||
      TP < Lt + 16)
    return (int)cudaErrorInvalidValue;
  ExtfArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
             (const int*)tlen, (const int*)w, B, Lq, Lt, mch, mis, e, xdrop,
             TP, (int*)rec};
  const size_t smem = (size_t)warps * 3 * TP;
  cudaError_t err = cudaFuncSetAttribute(
      extf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  extf_fwd_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
