// Banded global alignment forward (gg2_sse), batched: one warp a pair
// (kernel 8, counted as batch_gg2_fwd).
//
// Replaces ksw2_tpu/ops/wavefront_batch_gg2.py:_batch_gg2_kernel.  It
// computes what spec/diagdiff.py:gg2_sse specifies (ksw2_gg2_sse.c): per
// anti-diagonal r = i + j the deltas u, v, x, y in wrapping int8 over the
// 16-rounded band [st, en], the score bytes gathered from the matrix over
// [st0, en0] (gg2 always scores through it, ksw2_gg2_sse.c:60-66), no
// unsigned clamp, the direction byte of every cell of [st, en], and the
// O(1) H0 walk that reconstructs the corner score.  No band stops the
// sweep: a rounded band that is empty skips the update and leaves its byte
// row zero, and the walk still advances (global alignment reaches the
// corner).  The plain version is ops/batch_gg2.py:gg2_forward_plain
// without overrun; the single-pair kernel 16 is lg_fwd.cu.
//
// The bytes go to the reference's flat layout (ksw2_gg2_sse.c:41-47):
// pair b's rows start at pbase[b], row r is n_col = ((min(w + 1, tlen) +
// 15) / 16 + 1) * 16 bytes, cell i sits at r * n_col + i - st(r), and one
// zero row follows the last (the caller zeroes the store).  gg2's
// backtrack has no upper clamp (NULL off_end), so a walk that leaves the
// band upward reads the next row's bytes, as the reference's does;
// band_walk.cu's flat form walks this store.
//
// Two forms, chosen on the host from the launch's widest row n_col and m
// (ops/batch_gg2.py:gg2_form), never at run time:
//
// The register form (gg2_reg_kernel) keeps a pair's u, v, x, y and score
// bytes in one warp's registers, a block a pair: reg_window.cuh's unit
// window with one slot, W = 256 target positions in units of 8, unit u
// held by lane u (E's register layout at CPL 8), while n_col + 48 <= W
// (every main-path launch is n_col 128 at -w 100).  [st, en] is whole
// units; every lane computes its 8 cells, last first, each reading t -
// 1's old x and v from its own registers (one rotation a plane a
// diagonal for cell 0), and keeps them where its unit lies in the band
// (selects: the loop has no divergent branch).  The scores come from the
// matrix in shared memory over [st0, en0] only; the other cells keep the
// stale bytes of earlier diagonals, as the reference's s array does.  No
// clamp: z takes the unsigned max of b and nothing after it, and the
// direction byte takes b on the signed compare.  A lane in the band
// writes its 8 direction bytes with one 8-byte store.  The H0 walk is
// data-independent here: under the route's rule qlen <= tlen + w it
// reads v[st0] where st0 stays and u[st0] where st0 moves on (u[r] with
// an empty query; ops/gg2.py:gg2_walk_reads), so the lane that holds that
// byte adds it, after the diagonal's update, to a private sum, and one
// __reduce_add_sync at the end gives H0: no shuffle and no barrier a
// diagonal.  A pair with qlen > tlen + w traps
// (ops/batch_gg2.py:gg2_batch_align refuses it).
//
// The strip form (gg2_fwd_kernel) takes the wider launches: a pair's u,
// v, x, y and s planes are strips in the t coordinate of TP bytes in
// shared memory.  Lane l owns t = st + 32 c + l, takes the old x[t - 1]
// and v[t - 1] from lane l - 1 by __shfl_up_sync, the first from a read
// before the warp barrier, writes in place after it, and the walk runs
// after a second barrier, computed by every lane.  The walk reads v[lt]
// and u[lt + 1] in its own strips, clamped to TP - 1, which the route's
// pairs never reach.
//
// What bounds them on an H100: the serial chain of qlen + tlen - 1
// diagonals, one warp's instructions a diagonal (chip_smoke.py
// --breakdown gg2 at n_col 128: the strip form ~2,240 stamped cycles, 3.4
// chunk steps of ~550; the register form ~820, of which the 8 cells'
// ~240 instructions take ~340 and the score fill's 8 shared-memory
// lookups ~210), with one warp on a scheduler for the CLI's launches; a
// cell is ~13 integer operations of the recurrence and ~11 of the byte
// (chip_smoke.py: OPS, BYTE_OPS), and each cell writes its direction byte
// once, which is the only large memory traffic.
#include <climits>

#include "reg_window.cuh"

// clock stamps of the register form's parts, empty here: chip_smoke.py
// --breakdown gg2 builds a copy that defines them
#ifndef REG_STAMPS
#define REG_STAMP_INIT()
#define REG_STAMP(part)
#define REG_STAMP_FLUSH(diags)
#endif

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
  int B, Lq, Lt, m, q, e, TP, ncol;
  int* score;
  uint8_t* p;
};

__global__ void __launch_bounds__(MAX_WARPS * 32)
gg2_fwd_kernel(const Gg2Args A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int b = (int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
  if (b >= A.B) return;              // a whole warp
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  const int NS = A.TP;
  signed char* u = reinterpret_cast<signed char*>(smem) +
                   (size_t)(threadIdx.x >> 5) * 5 * A.TP;
  signed char* v = u + NS;
  signed char* x = v + NS;
  signed char* y = x + NS;
  signed char* s = y + NS;
  // unsigned byte k of array `region` (0 = u, 1 = v) as the H0 walk reads
  // it, in the strip
  auto rd = [&](int region, int k) -> int {
    return (int)(uint8_t)(region ? v : u)[min(k, A.TP - 1)];
  };

  const int q = A.q, qe = A.q + A.e;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  for (int t = lane; t < 5 * A.TP; t += 32) u[t] = 0;   // the reference's
  __syncwarp();                                          // zeroed arrays
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
      int cX = X1, cV = V1;          // old x, v of t - 1 for lane 0
      __syncwarp();
      uint8_t* pr = prow + (long long)r * ncol;
      for (int c0 = st; c0 <= en; c0 += 32) {
        const int t = c0 + lane;
        const bool in = t <= en;
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
      __syncwarp();
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
  if (lane == 0) A.score[b] = H0;
}


// The register form: see the head of the file.  One warp a block (b is
// the block), so every branch of the loop is warp-uniform.
__global__ void __launch_bounds__(32) gg2_reg_kernel(const Gg2Args A) {
  constexpr int NU = 1, W = 256 * NU;
  // the matrix biased by 2 (q + e), the cells' only use of a score
  __shared__ int stab[64];
  const int lane = threadIdx.x;
  for (int i = lane; i < A.m * A.m; i += 32)
    stab[i] = A.table[i] + 2 * (A.q + A.e);
  __syncwarp();
  const int b = blockIdx.x;
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  // the pair's row width; the route's rule, the form, the store's base
  const int ncol = ((min(w + 1, tlen) + 15) / 16 + 1) * 16;
  if (qlen > tlen + w || ncol > A.ncol || A.ncol + 48 > W ||
      (A.pbase[b] & 15))
    __trap();
  const int q = A.q, qe = A.q + A.e, mm = A.m * A.m - 1;
  const int qS = top(q);
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  uint8_t* prow = A.p + A.pbase[b];
  const int nd = qlen + tlen - 1;

  // unit (lane, 0): the planes u, v, x, y; a score byte never filled is
  // the reference's zero, biased
  UnitWindow<NU, 4> win;
  auto& U = win.P[0];
  auto& V = win.P[1];
  auto& X = win.P[2];
  auto& Y = win.P[3];
  auto& S4 = win.S4;
  const unsigned sb4[2] = {(unsigned)(2 * qe & 255) * 0x01010101u,
                           (unsigned)(2 * qe & 255) * 0x01010101u};
  int last_st = -1, last_en = -1, st0p = 0;
  int hsum = 0;                      // this lane's bytes of the H0 walk
  REG_STAMP_INIT();
  auto begin = [&](int, int) { REG_STAMP(4); };
  auto head = [&](int, int) {};
  auto cells = [&](int r, const BandRow& bd) {
    const int st0 = bd.st0, en0 = bd.en0, st = bd.st, en = bd.en;
    const int base = win.base;
    const int pu = base + 8 * lane;      // this lane's unit's first position
    REG_STAMP(0);
    // the score bytes (s + 2 (q + e)) over [st0, en0], from the matrix (the
    // index clamped as the plain version's); the others keep stale bytes
    {
      const unsigned fm = cell_mask<8>(st0 - pu, en0 - pu);
      unsigned sn[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ix = min(unit_byte(win.T4[0], k) * A.m +
                               unit_byte(win.Q4[0], k),
                           mm);
        sn[k >> 2] |= (unsigned)(stab[ix] & 255) << (8 * (k & 3));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned bm = byte_mask(fm >> (4 * i));
        S4[0][i] = (S4[0][i] & ~bm) | (sn[i] & bm);
      }
    }
    // the first-column presets u[r] = q (0 at r = 0), y[r] = 0
    const int colvS = top(r ? q : 0);
    if (st <= r && r <= en) {
      const int kc = r - pu;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k == kc) {
          U[0][k] = colvS;
          Y[0][k] = 0;
        }
    }
    // x[st - 1], v[st - 1] enter the cell at st (ksw2_gg2_sse.c:48-53); at
    // st = 0, v[-1] = q (0 at r = 0) and x[-1] = 0
    const bool prevok = st > 0 && last_st <= st - 1 && st - 1 <= last_en;
    int Xp[NU], Vp[NU];
    unit_prev<NU>(X, lane, Xp);
    unit_prev<NU>(V, lane, Vp);
    if (pu == st && !prevok) {
      Xp[0] = 0;
      Vp[0] = st == 0 ? colvS : 0;
    }
    REG_STAMP(1);
    // the cells, last first (cell k reads k - 1's old state), kept in the
    // lanes whose unit lies in the band (an empty band has none; selects,
    // no divergent branch), and their direction bytes: cell t at r * n_col
    // + t - st, 8-byte aligned (pbase and n_col multiples of 16, pu - st a
    // multiple of 8)
    const bool live = pu >= st && pu + 7 <= en;
    unsigned dw[2] = {0, 0};
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const int X1 = k ? X[0][k - 1] : Xp[0], V1 = k ? V[0][k - 1] : Vp[0];
      const int Uc = U[0][k], Yc = Y[0][k];
      int a = wadd(X1, V1), bb = wadd(Yc, Uc);
      const int zz = score_top(S4[0], k);        // s + 2 (q + e)
      int d = a > zz ? DIR_E : 0;
      int z = max(a, zz);
      d = bb > z ? DIR_F : d;                     // signed
      z = (int)max((unsigned)z, (unsigned)bb);   // max_epu8, no clamp
      const int z2 = wsub(z, qS);
      a = wsub(a, z2);
      bb = wsub(bb, z2);
      d |= (a > 0 ? DIR_E_CONT : 0) | (bb > 0 ? DIR_F_CONT : 0);
      U[0][k] = live ? wsub(z, V1) : Uc;
      V[0][k] = live ? wsub(z, Uc) : V[0][k];
      X[0][k] = live ? max(a, 0) : X[0][k];
      Y[0][k] = live ? max(bb, 0) : Yc;
      dw[k >> 2] |= (unsigned)d << (8 * (k & 3));
    }
    if (live)
      *reinterpret_cast<uint2*>(prow + (size_t)r * ncol + (pu - st)) =
          make_uint2(dw[0], dw[1]);
    REG_STAMP(2);
    // the H0 walk's byte (ksw2_gg2_sse.c:102-106), after the update: v[0]
    // at r = 0; u[r] with an empty query; else v[st0] where st0 stays,
    // u[st0] where it moves on; the lane that holds it adds it
    {
      const int pos = r == 0 ? 0 : qlen <= 0 ? r : st0;
      const bool fromv = r == 0 || (qlen > 0 && st0 == st0p);
      const int rel = pos - base;
      const int v = fromv ? sel_tree<8>(V[0], rel & 7)
                          : sel_tree<8>(U[0], rel & 7);
      hsum += lane == (rel >> 3) ? (int)((unsigned)v >> 24) : 0;
    }
    last_st = st;
    last_en = en;
    st0p = st0;
    REG_STAMP(3);
  };
  auto end = [&](int, int) { return false; };
  unit_sweep<NU, 4>(win, tg, A.Lt, qy, qlen, tlen, w, nd, lane, sb4, begin,
                    head, cells, end);
  REG_STAMP_FLUSH(nd);
  // H0 = v[0] - 2 (q + e) + the sum over r >= 1 of (byte - (q + e))
  const int H0 = __reduce_add_sync(FULL, hsum) - (nd + 1) * qe;
  if (lane == 0) A.score[b] = nd > 0 ? H0 : 0;
}

}  // namespace

// Kernel 8's strip form: one warp a pair, `warps` pairs a block, the strips (5 x TP
// bytes a warp) in shared memory; p the flat store of every pair, pair
// b's at pbase[b] (zeroed by the caller).  Returns cudaGetLastError()
// after the launch (0 on success).
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
            (const long long*)pbase, B, Lq, Lt, m, q, e, TP, 0, (int*)score,
            (uint8_t*)p};
  const size_t smem = (size_t)warps * 5 * TP;
  cudaError_t err = cudaFuncSetAttribute(
      gg2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gg2_fwd_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 8's register form: one warp a pair, a block each, on a launch
// that ops/batch_gg2.py:gg2_form gives it (ncol, the launch's widest row,
// + 48 <= 256, m <= 8); p and pbase as the strip form's.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_batch_gg2_reg_fwd(const void* qs, const void* ts,
                                       const void* qlen, const void* tlen,
                                       const void* w, const void* table,
                                       const void* pbase, int B, int Lq,
                                       int Lt, int m, int q, int e, int ncol,
                                       void* score, void* p, void* stream) {
  if (B <= 0 || m > 8 || ncol % 16 || ncol + 48 > 256 || p == nullptr)
    return (int)cudaErrorInvalidValue;
  Gg2Args a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
            (const int*)tlen, (const int*)w, (const int*)table,
            (const long long*)pbase, B, Lq, Lt, m, q, e, 0, ncol, (int*)score,
            (uint8_t*)p};
  gg2_reg_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
