// Strips forward: the row-major extension DP (extz, extd and exts, exact
// max).
//
// Replaces ksw2_tpu/ops/wavefront_strips.py:_kernel_body (one-piece,
// `two` and `spl` forms, score and `cig`).  It computes what spec/
// strips.py:strips_forward, spec/strips_extd.py:strips_forward_extd and
// spec/strips_cigar.py (strips_exts_cigar for SPL) specify: per global
// diagonal r = i + j the packed (H, merge key) maximum D[r], the
// query-end H Dq[r], the last-row H hl[j], and with CIG the reference's
// direction byte for every cell, row-major, d8[b][i][j] (7-bit bytes for
// two-piece costs).
//
// Layout: one thread block per pair, threads own contiguous chunks of
// query columns and the block loops over the target rows.  Within a row
// the F dependency is broken by the prefix-max substitution
//   F(i,j) = max(seed, max_{k<j} A(k)) - j*e,  A(k) = Hnof_c(i,k) + k*e - q
// (spec/strips.py:17-21): each thread scans its chunk, a warp shuffle
// scan plus a shared array of warp totals combines the chunks, and a
// second pass over the chunk writes the row.  The previous row's H is
// double-buffered in shared memory, E lives in shared memory (only its
// own column reads it), and D stays in shared memory for the whole pair:
// each diagonal is touched at most once per row and rows run in order,
// so a plain max needs no atomics.
//
// Two-piece rows (TWO) chain three passes, one block scan each: pass 1
// scans A for F; pass 2 forms F and Hc1 = min(max(hnof, F), cv), keeps
// Hc1 in shared memory and scans A2 = Hc1 + j*e2 - q2 for F2; pass 3
// forms F2 and H = min(max(Hc1, F2), cv).  The F and F2 chains decouple
// because e >= e2 after the swap (spec/strips_extd.py).  With CIG, pass 3
// also scans A3 = H + j*e - q, the third chain Fb that opens from the
// full clamped H and gives the bytes the DP's own F, and pass 4 writes
// the bytes from Fb, F2 (kept in the same scratch row), E and E2.  The
// boundary is the stepped col_h2 of common.cuh.
//
// Splice rows (SPL) are one-piece rows with the intron state NI, one
// int32 a column in shared memory like E: a vertical carry with no decay,
// so it needs no scan.  The donor and acceptor values depend only on the
// target row, so a row reads two scalars from the pair's rows; cand3 =
// NI + acceptor(i) enters hnof, there is no per-cell clamp (H = max(hnof,
// F)), NI' = max(NI, H + donor(i) - q2), and the byte takes code 3 and
// bit 0x20 (wavefront_strips.py:313-347).  The boundary is col_h2 with
// e2 = 0, flat after long_thres.
//
// What bounds it on an H100: each cell is ~20 integer operations (about
// twice that two-piece), so the kernel is bound by the serial chain of
// rows (a block scan with two barriers per chain, plus one barrier per
// row) and, with CIG, by the one-byte stores of the direction bytes.
// One block per pair leaves SMs idle when a launch has fewer pairs than
// the card has SMs (the whale bucket has 17).  Making it fast (several
// pairs per block, 16-byte byte stores, DPX max3) is later work; this
// version is the simple one that is right.
#include "common.cuh"

using namespace ksw2t;

namespace {

constexpr int NEG = -(1 << 30);
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

// Exclusive prefix max of one value per thread over the block, in thread
// order: a warp shuffle scan, then a scan of the warp totals in `wtot`
// (32 ints).  Every thread of the block must call it.
__device__ __forceinline__ int block_excl_max(int v, int lane, int warp,
                                              int nwarps, int* wtot) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, n);
  }
  int prev = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) prev = NEG;
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wtot[lane] : NEG;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w = max(w, n);
    }
    wtot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) prev = max(prev, wtot[warp - 1]);
  return prev;
}

template <bool CIG, bool TWO, bool SPL>
__global__ void __launch_bounds__(MAX_THREADS)
strips_fwd_kernel(const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ ts,
                  const int* __restrict__ qlens,
                  const int* __restrict__ tlens,
                  const int* __restrict__ table,
                  const int16_t* __restrict__ dons,
                  const int16_t* __restrict__ accs, int Lq, int tv, int m,
                  int q, int e, int q2, int e2, int lt, int ld, int mat0,
                  int kb, int right, int* __restrict__ D,
                  int* __restrict__ Dq, int* __restrict__ hl,
                  uint8_t* __restrict__ d8) {
  static_assert(!(TWO && SPL), "two-piece and splice rows are exclusive");
  constexpr int NSCAN = TWO ? (CIG ? 3 : 2) : 1;
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int qlen = qlens[b], tlen = tlens[b];
  const int nd = Lq + tv;
  const int gapoe = q + e, gapoe2 = q2 + e2;

  int* Ds = smem;                    // [nd] packed diagonal maxima
  int* Hb = Ds + nd;                 // [2][Lq] H of the previous/this row
  int* Es = Hb + 2 * Lq;             // [Lq] E entering the row
  int* tab = Es + Lq;                // [64] score table (m <= 8)
  int* wtot = tab + 64;              // [NSCAN][32] warp totals of the scans
  int* E2s = wtot + 32 * NSCAN;      // TWO: [Lq] E2 entering the row
  int* NIs = E2s;                    // SPL: [Lq] NI entering the row
  int* Xs = E2s + (TWO || SPL ? Lq : 0);  // TWO: [Lq] Hc1, then (CIG) F2
  uint8_t* qsm = reinterpret_cast<uint8_t*>(Xs + (TWO ? Lq : 0));  // [Lq]

  // H(i, -1) and H(-1, i) (SPL: e2 = 0)
  auto bnd = [&](int i) {
    return TWO || SPL ? col_h2(i, gapoe, e, e2, lt, ld)
                      : col_h(i, gapoe, e);
  };

  const uint8_t* trow = ts + (size_t)b * tv;
  int* Dg = D + (size_t)b * nd;
  int* Dqg = Dq + (size_t)b * nd;
  int* hlg = hl + (size_t)b * Lq;
  uint8_t* d8g = CIG ? d8 + (size_t)b * tv * Lq : nullptr;

  for (int r = tid; r < nd; r += nt) {
    Ds[r] = SENT;
    if (r < qlen - 1 || r >= qlen - 1 + tlen) Dqg[r] = SENT;
  }
  for (int j = tid; j < Lq; j += nt) {
    const int h0 = bnd(j);                    // virtual row: H(-1, j)
    Hb[j] = h0;
    Es[j] = h0 - gapoe;
    if (TWO) E2s[j] = h0 - gapoe2;
    if (SPL) NIs[j] = h0 - q2;
    qsm[j] = qs[(size_t)b * Lq + j];
    if (j >= qlen) hlg[j] = SENT;
  }
  for (int k = tid; k < m * m; k += nt) tab[k] = table[k];
  __syncthreads();

  const int chunk = (qlen + nt - 1) / nt;
  const int j0 = min(qlen, tid * chunk);
  const int j1 = min(qlen, j0 + chunk);

  for (int i = 0; i < tlen; ++i) {
    const int* Hp = Hb + (i & 1) * Lq;
    int* Hw = Hb + ((i + 1) & 1) * Lq;
    const int* sc = tab + trow[i] * m;
    const int hb = i == 0 ? 0 : bnd(i - 1);  // H(i-1, -1)
    const int ci = bnd(i);                    // H(i, -1)
    // SPL: this row's donor and acceptor values
    const int vd = SPL ? (int)dons[(size_t)b * tv + i] : 0;
    const int va = SPL ? (int)accs[(size_t)b * tv + i] : 0;

    // pass 1: the maximum of A over this thread's chunk
    int tmax = NEG;
    for (int j = j0; j < j1; ++j) {
      const int Hd = j == 0 ? hb : Hp[j - 1];
      int hnof = max(Hd + sc[qsm[j]], Es[j]);
      if (TWO) hnof = max(hnof, E2s[j]);
      if (SPL) hnof = max(hnof, NIs[j] + va);
      const int hnofc = SPL ? hnof : min(hnof, Hd + mat0);
      tmax = max(tmax, hnofc + j * e - q);
    }
    const int prev = block_excl_max(tmax, lane, warp, nwarps, wtot);

    // `run` is the F prefix seeded by H(i,-1) - (q+e)
    int run = max(ci - gapoe, prev);
    if constexpr (!TWO) {
      // pass 2: the row's cells
      for (int j = j0; j < j1; ++j) {
        const int Hd = j == 0 ? hb : Hp[j - 1];
        const int Mv = Hd + sc[qsm[j]];
        const int Ep = Es[j];
        const int NIp = SPL ? NIs[j] : 0;
        const int cand3 = NIp + va;            // SPL: the intron closes
        const int hnof = SPL ? max(max(Mv, Ep), cand3) : max(Mv, Ep);
        const int cv = Hd + mat0;              // the reference's clamp
        const int hnofc = SPL ? hnof : min(hnof, cv);
        const int F = run - j * e;
        const int H = SPL ? max(hnof, F) : min(max(hnof, F), cv);
        Es[j] = max(Ep - e, H - gapoe);
        if (SPL) NIs[j] = max(NIp, H + vd - q2);
        Hw[j] = H;
        run = max(run, hnofc + j * e - q);
        if (CIG) {
          // argmax from the unclamped candidates; continuation bits
          // against the clamped H (wavefront_strips.py:304-347)
          int d;
          bool ca, cb, cd = false;
          const int z = max(Mv, Ep);
          if (right) {
            d = Mv > Ep ? 0 : DIR_E;
            d = z > F ? d : DIR_F;
            if (SPL) d = max(z, F) > cand3 ? d : DIR_N;
            ca = Ep >= H - q;
            cb = F >= H - q;
            if (SPL) cd = NIp + q2 - H >= vd;
          } else {
            d = Ep > Mv ? DIR_E : 0;
            d = F > z ? DIR_F : d;
            if (SPL) d = cand3 > max(z, F) ? DIR_N : d;
            ca = Ep > H - q;
            cb = F > H - q;
            if (SPL) cd = NIp + q2 - H > vd;
          }
          d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
               (cd ? DIR_N_CONT : 0);
          d8g[(size_t)i * Lq + j] = (uint8_t)d;
        }
        const int r = i + j;
        const int packed =
            H * kb + (kb - 1 - merge_key(i, r, qlen, tlen, tv));
        Ds[r] = max(Ds[r], packed);
        if (j == qlen - 1) Dqg[r] = H;
        if (i == tlen - 1) hlg[j] = H;
      }
    } else {
      // pass 2: F, Hc1 (kept in Xs) and the F2 chain's chunk maximum
      int tmax2 = NEG;
      for (int j = j0; j < j1; ++j) {
        const int Hd = j == 0 ? hb : Hp[j - 1];
        const int hnof = max(max(Hd + sc[qsm[j]], Es[j]), E2s[j]);
        const int cv = Hd + mat0;
        const int F = run - j * e;
        const int Hc1 = min(max(hnof, F), cv);
        Xs[j] = Hc1;
        tmax2 = max(tmax2, Hc1 + j * e2 - q2);
        run = max(run, min(hnof, cv) + j * e - q);
      }
      const int prev2 = block_excl_max(tmax2, lane, warp, nwarps, wtot + 32);

      // pass 3: F2, the row's H and its records; E and E2 here in the
      // score form, after the bytes in the CIG form
      int run2 = max(ci - gapoe2, prev2);
      int tmax3 = NEG;
      for (int j = j0; j < j1; ++j) {
        const int Hd = j == 0 ? hb : Hp[j - 1];
        const int cv = Hd + mat0;
        const int Hc1 = Xs[j];
        const int F2 = run2 - j * e2;
        const int H = min(max(Hc1, F2), cv);
        run2 = max(run2, Hc1 + j * e2 - q2);
        Hw[j] = H;
        if (CIG) {
          Xs[j] = F2;
          tmax3 = max(tmax3, H + j * e - q);
        } else {
          Es[j] = max(Es[j] - e, H - gapoe);
          E2s[j] = max(E2s[j] - e2, H - gapoe2);
        }
        const int r = i + j;
        const int packed =
            H * kb + (kb - 1 - merge_key(i, r, qlen, tlen, tv));
        Ds[r] = max(Ds[r], packed);
        if (j == qlen - 1) Dqg[r] = H;
        if (i == tlen - 1) hlg[j] = H;
      }
      if constexpr (CIG) {
        const int prev3 =
            block_excl_max(tmax3, lane, warp, nwarps, wtot + 64);
        // pass 4: the 7-bit bytes from Fb, F2, E and E2; argmax in the
        // candidate order M, E, F, E2, F2 on the unclamped values,
        // continuation bits against the clamped H
        // (wavefront_strips.py:289-340)
        int run3 = max(ci - gapoe, prev3);
        for (int j = j0; j < j1; ++j) {
          const int Hd = j == 0 ? hb : Hp[j - 1];
          const int Mv = Hd + sc[qsm[j]];
          const int H = Hw[j];
          const int Ep = Es[j], E2p = E2s[j], F2 = Xs[j];
          const int Fb = run3 - j * e;
          run3 = max(run3, H + j * e - q);
          int d, z = max(Mv, Ep);
          bool ca, cb, ca2, cb2;
          if (right) {
            d = Mv > Ep ? 0 : DIR_E;
            d = z > Fb ? d : DIR_F;
            z = max(z, Fb);
            d = z > E2p ? d : DIR_E2;
            z = max(z, E2p);
            d = z > F2 ? d : DIR_F2;
            ca = Ep >= H - q;
            cb = Fb >= H - q;
            ca2 = E2p >= H - q2;
            cb2 = F2 >= H - q2;
          } else {
            d = Ep > Mv ? DIR_E : 0;
            d = Fb > z ? DIR_F : d;
            z = max(z, Fb);
            d = E2p > z ? DIR_E2 : d;
            z = max(z, E2p);
            d = F2 > z ? DIR_F2 : d;
            ca = Ep > H - q;
            cb = Fb > H - q;
            ca2 = E2p > H - q2;
            cb2 = F2 > H - q2;
          }
          d |= (ca ? DIR_E_CONT : 0) | (cb ? DIR_F_CONT : 0) |
               (ca2 ? DIR_E2_CONT : 0) | (cb2 ? DIR_F2_CONT : 0);
          d8g[(size_t)i * Lq + j] = (uint8_t)d;
          Es[j] = max(Ep - e, H - gapoe);
          E2s[j] = max(E2p - e2, H - gapoe2);
        }
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < nd; r += nt) Dg[r] = Ds[r];
}

template <bool CIG, bool TWO, bool SPL>
cudaError_t launch(const uint8_t* qs, const uint8_t* ts, const int* qlen,
                   const int* tlen, const int* table, const int16_t* don,
                   const int16_t* acc, int B, int Lq, int tv, int m, int q,
                   int e, int q2, int e2, int lt, int ld, int mat0, int kb,
                   int right, int threads, int* D, int* Dq, int* hl,
                   uint8_t* d8, cudaStream_t stream) {
  // the layout at the head of strips_fwd_kernel (ops/strips.py:
  // fwd_smem_bytes mirrors it)
  constexpr int NSCAN = TWO ? (CIG ? 3 : 2) : 1;
  const size_t rows = TWO ? 5 : (SPL ? 4 : 3);
  const size_t smem =
      ((size_t)Lq + tv + rows * Lq + 64 + 32 * NSCAN) * sizeof(int) +
      (size_t)Lq;
  cudaError_t err = cudaFuncSetAttribute(
      strips_fwd_kernel<CIG, TWO, SPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  strips_fwd_kernel<CIG, TWO, SPL><<<B, threads, smem, stream>>>(
      qs, ts, qlen, tlen, table, don, acc, Lq, tv, m, q, e, q2, e2, lt, ld,
      mat0, kb, right, D, Dq, hl, d8);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ksw2t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Returns cudaGetLastError() after the launch (0 on success).  `don` and
// `acc` are the (B, tv) int16 site rows of a splice launch (spl), else
// null.
extern "C" int ksw2t_strips_fwd(const void* qs, const void* ts,
                                const void* qlen, const void* tlen,
                                const void* table, const void* don,
                                const void* acc, int B, int Lq, int tv,
                                int m, int q, int e, int q2, int e2, int lt,
                                int ld, int mat0, int kb, int right, int cig,
                                int two, int spl, int threads, void* D,
                                void* Dq, void* hl, void* d8, void* stream) {
  if (B <= 0 || threads <= 0 || threads > MAX_THREADS || threads % 32 ||
      m > 8 || (two && spl) || (spl && (don == nullptr || acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto fn = spl   ? (cig ? launch<true, false, true>
                         : launch<false, false, true>)
            : two ? (cig ? launch<true, true, false>
                         : launch<false, true, false>)
                  : (cig ? launch<true, false, false>
                         : launch<false, false, false>);
  return (int)fn((const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
                 (const int*)tlen, (const int*)table, (const int16_t*)don,
                 (const int16_t*)acc, B, Lq, tv, m, q, e, q2, e2, lt, ld,
                 mat0, kb, right, threads, (int*)D, (int*)Dq, (int*)hl,
                 (uint8_t*)d8, (cudaStream_t)stream);
}
