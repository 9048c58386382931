// Linear-gap extension forward (extf2): the batched form, one warp a pair
// (kernel 7), and the single-pair form, one block a pair (kernel 15).
//
// Replaces ksw2_tpu/ops/wavefront_batch_extf.py:_batch_extf_kernel
// (batched, counted as batch_extf_fwd) and ksw2_tpu/ops/wavefront_extf.py:
// _extf_kernel_body (single pair, counted as extf_fwd).  Both compute what
// spec/diagdiff.py:extf2 specifies (ksw2_extf2_sse.c): per anti-diagonal
// r = i + j the Suzuki-Kasahara deltas u, v in wrapping int8 over the
// 16-rounded band [st, en], the score bytes filled over [st0, st0 +
// 16 floor((en0 - st0) / 16) + 15] by raw symbol equality (N matches N,
// as in the reference), z = max(s + 2e, v[t-1]) signed then unsigned max
// with u[t], and the O(1) H0 walk with the X-drop break
// (ksw2_extf2_sse.c:80-91).  A pair stops at its first empty band (the
// closed form of batch_pallas.py:42-48) or at an X-drop; both set
// zdropped ("not completed", ksw2_extf2_sse.c:49).  Score only: the
// output is the 9-field record of ops/records.py (mqe and mte are
// NEG_INF, their coordinates -1).  The plain version is
// ops/batch_extf.py:extf_forward_plain.
//
// Layout: a pair's u, v and s planes are strips in the t coordinate of
// TP bytes, as the reference's own arrays are; in shared memory for the
// batched form, in a zeroed global scratch (one TP x 3 slice a pair) for
// the single-pair form, whose strips outgrow shared memory on long
// targets.  A group of warps walks a diagonal: the band [st, max(en,
// fill end)] is cut into one segment a warp, each a multiple of 32
// positions; inside a segment lane l owns t = lo + 32 c + l, reads its
// cell's old state, and takes the old v[t - 1] from lane l - 1 by
// __shfl_up_sync (lane 0 from lane 31 of the previous chunk, carried in
// registers).  A segment's first old v[lo - 1] is read before a group
// barrier, and the writes are in place after it, so positions outside
// the band keep the reference's stale bytes.  The batched form's group is
// one warp (__syncwarp); the single-pair form's is the block
// (__syncthreads), 2 barriers a diagonal.  The H0 walk reads v[lt] and
// u[lt + 1] after the second barrier; every thread computes it, so the
// per-pair scalars stay in registers and the loop's exit is uniform.
//
// Why one block a pair for the single-pair form and not kernel 12's tiles
// over many SMs: the X-drop break is a scalar decision on every diagonal
// that needs the whole diagonal's update; inside one block it costs a
// barrier, across tiles it needs kernel 12's run-ahead and in-order
// replay.  One block holds up to 1024 threads, so an unbanded 50 kb pair
// runs ~25 chunk steps a warp a diagonal.
//
// What bounds it on an H100: the serial chain of diagonals (qlen + tlen -
// 1 of them), each a few chunk steps and two barriers; a cell costs ~40
// integer operations as written here against the recurrence's ~12
// (chip_smoke.py: OPS, the bound).  No direction bytes are written, so
// memory traffic is the sequences and the records.  This is the simple
// version that is right; the single-pair form's strips could move to
// shared memory for t <= ~70 kb, and DPX byte SIMD is later work.
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
  signed char* scratch;    // single-pair form: 3 x TP bytes a pair, zeroed
};

// SINGLE: one block a pair, strips in global scratch, block barriers;
// else one warp a pair, strips in shared memory, warp barriers.
template <bool SINGLE>
__global__ void __launch_bounds__(SINGLE ? 1024 : MAX_WARPS * 32)
extf_fwd_kernel(const ExtfArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int W = SINGLE ? (int)(blockDim.x >> 5) : 1;
  const int g = SINGLE ? (int)(threadIdx.x >> 5) : 0;
  const int b = SINGLE ? (int)blockIdx.x
                       : (int)(blockIdx.x * (blockDim.x >> 5) +
                               (threadIdx.x >> 5));
  if (b >= A.B) return;              // a whole warp (batched form)
  const int TP = A.TP;
  signed char* u =
      SINGLE ? A.scratch + (size_t)b * 3 * TP
             : reinterpret_cast<signed char*>(smem) +
                   (size_t)(threadIdx.x >> 5) * 3 * TP;
  signed char* v = u + TP;
  signed char* s = v + TP;
  auto gsync = [&]() {
    if (SINGLE)
      __syncthreads();
    else
      __syncwarp();
  };

  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int e = A.e;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  int* out = A.rec + (size_t)b * 9;
  if (qlen <= 0 || tlen <= 0) {      // ksw_reset_extz: nothing to align
    if (lane == 0 && g == 0) {
      out[0] = 0; out[1] = -1; out[2] = -1; out[3] = NEG; out[4] = -1;
      out[5] = NEG; out[6] = -1; out[7] = NEG; out[8] = 0;
    }
    return;
  }
  if (!SINGLE) {                     // the reference's zeroed arrays
    for (int t = lane; t < 3 * TP; t += 32) u[t] = 0;
    __syncwarp();
  }

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
    const int seg = (((top - st + 1) + W - 1) / W + 31) & ~31;
    const int lo = st + g * seg, sh = min(lo + seg - 1, top);
    int cV = V1;                     // old v[t - 1] of lane 0
    if (g > 0 && lo <= top) cV = v[lo - 1];
    gsync();
    for (int c0 = lo; c0 <= sh; c0 += 32) {
      const int t = c0 + lane;
      const bool in = t <= sh;
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
    gsync();
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
  if (lane == 0 && g == 0) {
    out[0] = mx; out[1] = mt; out[2] = mq; out[3] = NEG; out[4] = -1;
    out[5] = NEG; out[6] = -1; out[7] = zd ? NEG : H0; out[8] = zd;
  }
}

}  // namespace

// Batched form (kernel 7): one warp a pair, `warps` pairs a block, the
// strips (3 x TP bytes a warp) in shared memory.  Returns
// cudaGetLastError() after the launch (0 on success).
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
             TP, (int*)rec, nullptr};
  const size_t smem = (size_t)warps * 3 * TP;
  cudaError_t err = cudaFuncSetAttribute(
      extf_fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  extf_fwd_kernel<false><<<(B + warps - 1) / warps, warps * 32, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Single-pair form (kernel 15): one block of `warps` warps a pair, the
// strips in `scratch` (B x 3 x TP bytes, zeroed by the caller).
extern "C" int ksw2t_extf_fwd(const void* qs, const void* ts,
                              const void* qlen, const void* tlen,
                              const void* w, int B, int Lq, int Lt, int mch,
                              int mis, int e, int xdrop, int TP, int warps,
                              void* scratch, void* rec, void* stream) {
  if (B <= 0 || warps <= 0 || warps > 32 || TP % 32 || TP < Lt + 16 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  ExtfArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
             (const int*)tlen, (const int*)w, B, Lq, Lt, mch, mis, e, xdrop,
             TP, (int*)rec, (signed char*)scratch};
  extf_fwd_kernel<true><<<B, warps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
