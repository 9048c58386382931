// Rows forward (kernel 3): the one-piece extension DP for short pairs (q, t
// <= 128).
//
// Replaces ksw2_tpu/ops/wavefront_rows.py:_row_kernel_body (row-major
// extz, score-only).  It computes the same streams as strips_fwd.cu's
// one-piece score form, at the launch's canonical tv (<= 128): per global
// diagonal r = i + j the packed (H, merge key) maximum D[r], the
// query-end H Dq[r] and the last-row H hl[j], so ops/strips.py:
// replay_records serves both routes.  The TPU kernel's (128, B) planes,
// with pairs on lanes, and its own packing and replay are not ported.
//
// Layout: one warp a pair and a block (no warp of a block leaves early,
// so the step's shuffles need no divergence check).  Lane l owns the four
// query columns j = 4l .. 4l+3, and the lanes run as a pipeline a row
// apart: at step s lane l computes row i = s - l, so a pair takes tlen +
// (qlen - 1) / 4 steps (its last live lane's last row).  H and E of the
// lane's columns stay in its registers from its previous row.  From lane
// l - 1, one shuffle each a step: H at the lane's left edge (H(i, 4l -
// 1), the diagonal neighbour of the next row) and F entering column 4l
// in row i; the diagonal H(i - 1, 4l - 1) is the edge the lane got a
// step earlier.  Lane 0 takes the virtual column instead.  F runs
// serially over the lane's columns, F(j + 1) = max(F(j) - e, min(hnof(j),
// Hd(j) + mat0) - (q + e)): the same integers as the prefix max of
// spec/strips.py:17-21, since F(j) - e >= its earlier terms less e.  So
// a step's chain is one shuffle and four DPX steps, with no warp scan.
// A lane keeps its columns' scores against each of m <= 8 target
// symbols as bytes, two registers a column, and one prmt picks a cell's
// score; the target row sits four symbols a lane in one register, and a
// lane takes row i's symbol with one shuffle, off the chain.
//
// D off the chain: lane l's column k at step s lies on diagonal s + 3l +
// k, so the lane meets a diagonal in four consecutive steps, its columns
// 3, 2, 1, 0 in turn.  It keeps the packed maxima of the three diagonals
// it will meet again in registers that shift down a column a step, and
// the diagonal a step finishes (its column 0's) goes into the lane's own
// row of shared memory, one slot a step: a plain store, whose row pitch
// is odd, so a step's 32 stores meet no bank twice.  At the end diagonal
// r takes the maximum of slot r + 1 - 3l over the lanes l; nothing in the
// loop reads another lane's slots, and nothing is atomic.  A
// step's cells go into D one step late, after the next step's shuffles
// are issued, so their keys fill the shuffles' and the F chain's latency.
// The merge key of common.cuh:merge_key is i + 1 + tv m from a = i - st0
// = min(i, qlen - 1 - j) and b = en0 - i = min(tlen - 1 - i, j): m = a &
// 3 where (a & 3) >= 4 - min(b, 4) (the vector region), else 4 (the
// tail); the en0 cells (b == 0: column 0 and the last row) reach key 0
// through the base the step gives them.  The lane that holds the query's
// last column writes Dq a row; hl is the lanes' state after the last row.
// The pipeline's first 32 steps and its last rows (from tlen - 3 on)
// keep a lane's state outside its rows and test the rows' edges; the
// steps between them need neither.
//
// What bounds it on an H100: a launch of a few hundred pairs is one warp
// to a scheduler, so a step costs its ~115 warp instructions (the cells,
// the late cells' keys, three shuffles, two stores) and the latency they
// leave unfilled, ~190 cycles; 128 + 31 steps a pair (0.0197 ms for the
// 502 short pairs on an H100 at 700 W, chip_smoke.py --rows-times; the
// bound of the cells' operations is 0.0042).  Two warps a block, whose early return cost
// every shuffle a divergence check, and a shared atomic a step held an
// earlier form of this design at 0.028-0.030 ms; the parent design (one
// warp a pair taking a row at a time, with a five-round shuffle scan for
// F and shared-memory score and D traffic on the chain) spent ~0.6 us a
// row, 0.076 ms.
#include <climits>
#include <type_traits>

#include "common.cuh"

using namespace ksw2t;

// clock() stamps of a step's parts, empty here: chip_smoke.py
// --breakdown rows builds a copy that defines them
#ifndef ROWS_STAMPS
#define ROWS_STAMP_INIT()
#define ROWS_STAMP(part)
#define ROWS_STAMP_FLUSH(steps)
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int COLS = 4;           // query columns per lane
constexpr int LQ_MAX = 32 * COLS;

// Ints a lane's row of finished diagonals takes: a slot a step up to
// tv + Lq / 4 steps and 3 for the drain, odd so that the lanes of a step
// write 32 banks.
__host__ __device__ __forceinline__ int slot_pitch(int Lq, int tv) {
  return (tv + (Lq >> 2) + 4) | 1;
}

// The byte of (hi:lo) that sel's low nibble picks, sign-extended (prmt's
// sign mode: sel = c * 0x1111 + 0x8880 picks byte c).
__device__ __forceinline__ int prmt(unsigned lo, unsigned hi, int sel) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

__global__ void __launch_bounds__(32)
rows_fwd_kernel(const uint8_t* __restrict__ qs,
                const uint8_t* __restrict__ ts,
                const int* __restrict__ qlens, const int* __restrict__ tlens,
                const int* __restrict__ table, int B, int Lq, int tv, int m,
                int q, int e, int mat0, int kb, int* __restrict__ D,
                int* __restrict__ Dq, int* __restrict__ hl) {
  // [32][P]: each lane's finished diagonals, one a step
  extern __shared__ int part[];
  const int lane = threadIdx.x;
  const int nd = Lq + tv;
  const int P = slot_pitch(Lq, tv);
  // the lane's row as a shared-space address, for the step's store
  const unsigned prow =
      (unsigned)__cvta_generic_to_shared(part + lane * P);
  const int b = blockIdx.x;

  const int qlen = qlens[b], tlen = tlens[b];
  const int gapoe = q + e;
  int* Dqg = Dq + (size_t)b * nd;
  int* hlg = hl + (size_t)b * Lq;
  for (int r = lane; r < nd; r += 32)
    if (r < qlen - 1 || r >= qlen - 1 + tlen) Dqg[r] = SENT;
  for (int j = lane; j < Lq; j += 32)
    if (j >= qlen) hlg[j] = SENT;

  // the lane's columns: H(-1, j) and E(0, j), and each column's scores
  // against target symbols 0..7, byte c of (SH:SL) for symbol c
  const int jb = COLS * lane;
  int H[COLS], E[COLS];
  unsigned SL[COLS], SH[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int j = jb + k;
    H[k] = col_h(j, gapoe, e);
    E[k] = H[k] - gapoe;
    const int Q = j < Lq ? qs[(size_t)b * Lq + j] : 0;
    unsigned lo = 0, hi = 0;
    for (int c = 0; c < m; ++c) {
      const unsigned byte = (unsigned)(table[c * m + Q] & 255);
      if (c < 4)
        lo |= byte << (8 * c);
      else
        hi |= byte << (8 * (c - 4));
    }
    SL[k] = lo;
    SH[k] = hi;
  }
  // the target row, symbols 4l .. 4l + 3 in lane l's bytes
  unsigned T4 = 0;
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    if (jb + k < tlen) T4 |= (unsigned)ts[(size_t)b * tv + jb + k] << (8 * k);
  __syncwarp();

  const int kbm1 = kb - 1;
  const int cq = qlen - 1 - jb;             // qlen - 1 - j of column 0
  const int cqm = min(cq, COLS - 1);        // the lane's last live column
  const int nsteps = tlen + ((qlen - 1) >> 2);
  // 4 - min(j, 4): the tail threshold a column's j sets (lane 0's)
  int tj[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) tj[k] = 4 - min(jb + k, 4);
  // H(i - 1, jb - 1): the left lane's edge a step ago (lane 0: unused)
  int hprev = col_h(jb - 1, gapoe, e);
  // F entering column jb + 4, biased by q + e (F + q + e)
  int fout = 0;
  // the packed maxima of diagonals s - 1 + 3 lane + k (k = 1, 2, 3)
  // before step s takes in step s - 1's cells (ph, row s - 1 - lane)
  int acc1 = INT_MIN, acc2 = INT_MIN, acc3 = INT_MIN;
  int ph[COLS] = {0, 0, 0, 0};
  ROWS_STAMP_INIT();

  // step s - 1's cells into D, a step late (off the chain of step s): the
  // cells' packed (H, merge key) into the diagonals the lane holds, the
  // one they finish (s - 1 + 3 lane, column 0's) out with one atomic,
  // the others down a column.  The key is i + 1 + tv m: m = a & 3 in the
  // vector region ((a & 3) >= 4 - min(b, 4)), m = 4 in the tail; the en0
  // cells (b == 0: column 0 and the last row) reach key 0 through the
  // base c the step gives them.  EDGE steps have rows outside [0, tlen)
  // or within 3 of the last; the steps between them need neither test.
  auto pend = [&](int s, auto edge_) {
    constexpr bool EDGE = decltype(edge_)::value;
    const int pi = s - 1 - lane;
    const bool rowok = !EDGE || (unsigned)pi < (unsigned)tlen;
    const int lim = rowok ? cqm : -1;
    const int u = tlen - 1 - pi;
    const int c1 =
        kbm1 - (pi + 1) + (EDGE && u == 0 ? pi + 1 + 4 * tv : 0);
    const int c0 = lane == 0 ? kbm1 + 4 * tv : c1;
    int p[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int a3 = min(pi, cq - k) & 3;
      const int mk = a3 >= (EDGE ? max(4 - u, tj[k]) : tj[k]) ? a3 : 4;
      const int kc = (k == 0 ? c0 : c1) - tv * mk;
      p[k] = k <= lim ? ph[k] * kb + kc : INT_MIN;
    }
    const int done = max(acc1, p[0]);
    acc1 = max(acc2, p[1]);
    acc2 = max(acc3, p[2]);
    acc3 = p[3];
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(prow + 4 * s), "r"(done)
                 : "memory");
    const int hq = cq & 2 ? (cq & 1 ? ph[3] : ph[2]) : (cq & 1 ? ph[1] : ph[0]);
    if (rowok && (unsigned)cq < (unsigned)COLS) Dqg[pi + qlen - 1] = hq;
  };
  // step s: row s - lane of the lane's columns, then step s - 1's cells
  // into D.  EDGE steps (the pipeline's fill, its last 3 rows and its
  // drain) keep the state of a lane outside [0, tlen)
  auto step = [&](int s, auto edge_) {
    constexpr bool EDGE = decltype(edge_)::value;
    const int i = s - lane;
    // from the left lane: its edge H of row i and F entering column jb;
    // row i's target symbol from the lane that holds it
    const int hin = __shfl_up_sync(FULL, H[COLS - 1], 1);
    int fin = __shfl_up_sync(FULL, fout, 1);
    const unsigned tw = __shfl_sync(FULL, T4, (i >> 2) & 31);
    int hd = hprev;
    if (lane == 0) {
      const int B = col_h(i, gapoe, e);        // H(i, -1) = F(i, 0) + q + e
      hd = i == 0 ? 0 : B + e;                 // H(i - 1, -1)
      fin = B;
    }
    hprev = hin;
    ROWS_STAMP(0);
    pend(s, edge_);
    ROWS_STAMP(1);
    const int sel = prmt(tw, 0, (i & 3) | 0x4440) * 0x1111 + 0x8880;
    const bool act = !EDGE || (unsigned)i < (unsigned)tlen;
    int F = fin, Hd = hd;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int hnof = __viaddmax_s32(Hd, prmt(SL[k], SH[k], sel), E[k]);
      const int cv = Hd + mat0;
      const int h = min(__viaddmax_s32(F, -gapoe, hnof), cv);
      F = __viaddmax_s32(F, -e, min(hnof, cv));
      const int En = __viaddmax_s32(E[k], -e, h - gapoe);
      Hd = H[k];
      H[k] = act ? h : H[k];
      E[k] = act ? En : E[k];
      ph[k] = h;
    }
    fout = F;
    ROWS_STAMP(2);
  };
  // steps 0..31 fill the pipeline (step 31's rows are all >= 0, so the
  // next step's late cells are too); steps up to tlen - 4 take rows at
  // least 4 from the last.  Three loops, the middle one unrolled by 2
  // (on an H100 one loop with the edge test inside took 0.0244 ms on the
  // 502 short pairs, these 0.0196)
  int s = 0;
  for (const int fill = min(32, nsteps); s < fill; ++s)
    step(s, std::true_type{});
#pragma unroll 2
  for (; s <= tlen - 4; ++s) step(s, std::false_type{});
  for (; s < nsteps; ++s) step(s, std::true_type{});
  pend(nsteps, std::true_type{});
  // the lane's last diagonals, and the last row, where each lane's state
  // stopped
  part[lane * P + nsteps + 1] = acc1;
  part[lane * P + nsteps + 2] = acc2;
  part[lane * P + nsteps + 3] = acc3;
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    if (k <= cq) hlg[jb + k] = H[k];
  ROWS_STAMP_FLUSH(nsteps);
  __syncwarp();
  // diagonal r: the maximum of what each lane l handed on for it, at slot
  // r + 1 - 3 l (slots 0 .. nsteps + 3 are written)
  int* Dg = D + (size_t)b * nd;
  for (int r = lane; r < nd; r += 32) {
    int v = SENT;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) {
      const int sl = r + 1 - 3 * l;
      if ((unsigned)sl < (unsigned)(nsteps + 4)) v = max(v, part[l * P + sl]);
    }
    Dg[r] = v;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ksw2t_rows_fwd(const void* qs, const void* ts,
                              const void* qlen, const void* tlen,
                              const void* table, int B, int Lq, int tv,
                              int m, int q, int e, int mat0, int kb, void* D,
                              void* Dq, void* hl, void* stream) {
  if (B <= 0 || Lq <= 0 || Lq > LQ_MAX || tv > LQ_MAX || m > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)32 * slot_pitch(Lq, tv) * sizeof(int);
  rows_fwd_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
      (const int*)tlen, (const int*)table, B, Lq, tv, m, q, e, mat0, kb,
      (int*)D, (int*)Dq, (int*)hl);
  return (int)cudaGetLastError();
}
