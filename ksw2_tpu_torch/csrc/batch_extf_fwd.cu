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
// Two forms, chosen on the host from the launch's n_col (the widest
// pair's 16-rounded band, ops/batch_extf.py:extf_form), never at run time:
//
// The register form (extf_reg_kernel) keeps a pair's u, v and score
// bytes in one warp's registers, a block a pair: reg_window.cuh's unit
// window, W = 1024 target positions in units of 8, unit u held by lane u
// % 32 in slot u / 32 (4 slots; the CLI's unbanded launches reach n_col
// 720), while n_col + 48 <= W.  A diagonal computes only the slots its
// band meets, slot 0 (which holds st) up to the last, so its work follows
// the band's width: the CLI's pairs X-drop at -z40 while their band lies
// in one slot, and a banded launch pays little for the window's width.  Every
// lane of a slot computes its 8 cells, last first, each reading t - 1's
// old v from its own registers (one rotation a slot for cell 0), and
// keeps them where its unit lies in [st, en] (selects).  The symbols are
// raw bytes four to a register, so a score is raw byte equality
// (bytes_eq); the target is 0 past tlen and the query outside [0, qlen),
// as the reference's arrays are.  The H0 walk reads v[lt] and u[lt + 1]
// by a select tree in the lane that holds each and one shuffle; lane j
// keeps diagonal r_lo + j's H0 and lt, and at a group's end the warp
// replays the maximum and the X-drop test in order by a scan, the first
// diagonal that drops (by ballot) being the stop.  The warp has run up to
// 31 diagonals past a drop; nothing it wrote there is kept.
//
// The strip form (extf_fwd_kernel) takes the wider launches: a pair's u, v
// and s planes are strips in the t coordinate of TP bytes in shared
// memory, as the reference's own arrays are.  Lane l owns t = st + 32 c +
// l over the band [st, max(en, fill end)], reads its cell's old state, and
// takes the old v[t - 1] from lane l - 1 by __shfl_up_sync (lane 0 from
// lane 31 of the previous chunk, carried in registers).  The first old
// v[st - 1] is read before a warp barrier, and the writes are in place
// after it, so positions outside the band keep the reference's stale
// bytes.  The H0 walk reads v[lt] and u[lt + 1] after the second barrier;
// every lane computes it, so the per-pair scalars stay in registers and
// the loop's exit is uniform.
//
// What bounds them on an H100: the serial chain of diagonals (qlen + tlen
// - 1 of them, or to an X-drop and the rest of its group), one warp's
// instructions a diagonal (chip_smoke.py --breakdown extf: the strip
// form's ~455 cycles a chunk step; the register form ~1,100-1,300 stamped
// cycles a diagonal, the walk's two picks and the cells of the live slots
// the largest parts); a cell is ~7 integer operations of the recurrence
// (chip_smoke.py: OPS, the bound).  No direction bytes are written, so
// memory traffic is the sequences and the records.
#include <climits>
#include <type_traits>

#include "reg_window.cuh"

// clock stamps of the register form's parts, empty here: chip_smoke.py
// --breakdown extf builds a copy that defines them
#ifndef REG_STAMPS
#define REG_STAMP_INIT()
#define REG_STAMP(part)
#define REG_STAMP_FLUSH(diags)
#endif

using namespace ksw2t;

namespace {

constexpr int NEG = -0x40000000;    // NEG_INF of core/flags.py
constexpr int MAX_WARPS = 8;        // pairs a block, batched form
constexpr unsigned FULL = 0xffffffffu;
constexpr int NU_X = 4;             // the register form's slots: W = 1024

__device__ __forceinline__ int w8(int v) { return (int)(signed char)v; }

struct ExtfArgs {
  const uint8_t* qs;
  const uint8_t* ts;
  const int* qlens;
  const int* tlens;
  const int* ws;
  int B, Lq, Lt, mch, mis, e, xdrop, TP, ncol;
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


// The register form: see the head of the file.  One warp a block (b is
// the block), so every branch of the loop is warp-uniform.
__global__ void __launch_bounds__(32) extf_reg_kernel(const ExtfArgs A) {
  constexpr int NU = NU_X, W = 256 * NU;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int qlen = A.qlens[b], tlen = A.tlens[b], w = A.ws[b];
  int* out = A.rec + (size_t)b * 9;
  if (qlen <= 0 || tlen <= 0) {      // ksw_reset_extz: nothing to align
    if (lane == 0) {
      out[0] = 0; out[1] = -1; out[2] = -1; out[3] = NEG; out[4] = -1;
      out[5] = NEG; out[6] = -1; out[7] = NEG; out[8] = 0;
    }
    return;
  }
  // the launch's form holds bands of at most n_col - 16 cells
  if (min(min(w + 1, qlen), tlen) + 16 > A.ncol || A.ncol + 48 > W) __trap();
  // the score bytes are kept biased by 2e, the cells' only use of them
  const int e = A.e;
  const unsigned MCH4 = (unsigned)((A.mch + 2 * e) & 255) * 0x01010101u;
  const unsigned XM4 =
      MCH4 ^ (unsigned)((A.mis + 2 * e) & 255) * 0x01010101u;
  const uint8_t* tg = A.ts + (size_t)b * A.Lt;
  const uint8_t* qy = A.qs + (size_t)b * A.Lq;
  const int ndb = qlen + tlen - 1;
  const int rlim = first_empty_diag(qlen, tlen, w);

  // unit (lane, j): the planes u, v; a score byte never filled is the
  // reference's zero, biased
  UnitWindow<NU, 2> win;
  auto& U = win.P[0];
  auto& V = win.P[1];
  auto& S4 = win.S4;
  const unsigned sb4[2] = {(unsigned)(2 * e & 255) * 0x01010101u,
                           (unsigned)(2 * e & 255) * 0x01010101u};
  int last_st = -1, last_en = -1, H0 = 0, lt = 0;
  int mx = 0, mt = -1, mq = -1, zd = rlim < ndb ? 1 : 0, done_diags = 0;
  // lane j's diagonal r_lo + j of the group: the walk's H0 and lt
  int gH = INT_MIN, gT = 0;
  REG_STAMP_INIT();
  // the O(1) H0 walk (ksw2_extf2_sse.c:80-91) of diagonal rw, on the planes
  // as its update left them (window base `base`); it runs one diagonal
  // behind the cells, so that its picks overlap the next diagonal's head
  auto walk = [&](int rw, int r_lo) {
    // branch-free: diagonal 0 (base 0, lt 0) reads v[0] as d0 and starts
    // H0 at v[0] - 2e = d0 - e
    const BandRow bw = band_row(rw, qlen, tlen, w);
    const bool c1 = lt >= bw.st0 && lt <= bw.en0;
    const bool c2 = lt + 1 >= bw.st0 && lt + 1 <= bw.en0;
    const int d0 =
        (int)((unsigned)unit_pick<NU>(V, lt - win.base) >> 24) - e;
    const int d1 =
        (int)((unsigned)unit_pick<NU>(U, lt + 1 - win.base) >> 24) - e;
    const bool stay = c1 && (!c2 || d0 > d1);
    H0 = rw == 0 ? d0 - e : H0 + (stay ? d0 : d1);
    lt = rw == 0 ? 0 : lt + (stay ? 0 : 1);
    if (lane == rw - r_lo) {
      gH = H0;
      gT = lt;
    }
  };
  auto begin = [&](int, int) {
    gH = INT_MIN;
    gT = 0;
    REG_STAMP(4);
  };
  auto head = [&](int r, int r_lo) {
    if (r > r_lo) walk(r - 1, r_lo);
    REG_STAMP(3);
  };
  auto cells = [&](int r, const BandRow& bd) {
    const int st0 = bd.st0, en0 = bd.en0, st = bd.st, en = bd.en;
    const int base = win.base;
    // the score fill's end (ksw2_extf2_sse.c:66-72)
    const int hi = st0 + ((en0 - st0) & ~15) + 15;
    const bool prevok = st > 0 && last_st <= st - 1 && st - 1 <= last_en;
    int Vp[NU];
    unit_prev<NU>(V, lane, Vp);
    REG_STAMP(0);
    // the slots the diagonal meets, slot 0 (which holds st) up to jhi (slot
    // j: positions sb .. sb + 255, this lane's unit from pu): the score
    // fill over [st0, hi] (raw symbol equality; the other positions keep
    // stale bytes), then the cells of [st, en], kept in the units the band
    // covers (selects)
    auto slot = [&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const int sb = base + 256 * j, pu = sb + 8 * lane;
      const unsigned fm = cell_mask<8>(st0 - pu, hi - pu);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned sn =
            MCH4 ^ (~bytes_eq(win.T4[j][i], win.Q4[j][i]) & XM4);
        const unsigned bm = byte_mask(fm >> (4 * i));
        S4[j][i] = (S4[j][i] & ~bm) | (sn & bm);
      }
      REG_STAMP(1);
      // u[r] = 0 where the first column lies in the band
      if (st <= r && r <= en) {
        const int kc = r - pu;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k == kc) U[j][k] = 0;
      }
      // cell k reads k - 1's old v; v[st - 1] enters the cell at st when
      // the previous band covered it
      const bool live = pu >= st && pu + 7 <= en;
      const int V0 = pu == st && !prevok ? 0 : Vp[j];
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const int V1 = k ? V[j][k - 1] : V0, Uc = U[j][k];
        int z = max(score_top(S4[j], k), V1);   // s + 2e, signed
        z = (int)max((unsigned)z, (unsigned)Uc);           // unsigned
        U[j][k] = live ? wsub(z, V1) : Uc;
        V[j][k] = live ? wsub(z, Uc) : V[j][k];
      }
    };
    static_assert(NU == 4, "the switch below enters 4 slots");
    switch (min((max(en, hi) - base) >> 8, NU - 1)) {
      case 3:
        slot(std::integral_constant<int, 3>{});
        [[fallthrough]];
      case 2:
        slot(std::integral_constant<int, 2>{});
        [[fallthrough]];
      case 1:
        slot(std::integral_constant<int, 1>{});
        [[fallthrough]];
      default:
        slot(std::integral_constant<int, 0>{});
    }
    REG_STAMP(2);
    last_st = st;
    last_en = en;
  };
  auto end = [&](int r_lo, int n) {
    walk(r_lo + n - 1, r_lo);
    REG_STAMP(3);
    // the group's replay (ksw2_extf2_sse.c:87-90): lane j holds diagonal
    // rj = r_lo + j; the maximum before it is the carried one joined with
    // an exclusive scan of the group's (first strictly greater wins)
    const int rj = r_lo + lane;
    const bool contrib = lane < n && rj > 0;
    const int v = contrib ? gH : INT_MIN;
    const RunMax s = first_max_scan(v, gT, rj, lane, mx, mt, mq);
    const bool drop = contrib && A.xdrop >= 0 && !(v > s.pv) &&
                      s.pv - v > A.xdrop;
    const unsigned DM = __ballot_sync(FULL, drop);
    const int jd = DM ? __ffs(DM) - 1 : 32;
    {
      const int jl = min(jd, n - 1);
      const int lv = __shfl_sync(FULL, s.iv, jl);
      const int lt_ = __shfl_sync(FULL, s.it, jl);
      const int lr = __shfl_sync(FULL, s.ir, jl);
      if (lv > mx) {
        mx = lv;
        mt = lt_;
        mq = lr - lt_;
      }
    }
    done_diags += min(jd + 1, n);
    REG_STAMP(5);
    if (jd < n) zd = 1;
    return jd < n;
  };
  unit_sweep<NU, 2>(win, tg, tlen, qy, qlen, tlen, w, rlim, lane, sb4, begin,
                    head, cells, end);
  REG_STAMP_FLUSH(done_diags);
  if (lane == 0) {
    const int f[9] = {mx, mt, mq, NEG, -1, NEG, -1, zd ? NEG : H0, zd};
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i] = f[i];
  }
}

}  // namespace

// Kernel 7's strip form: one warp a pair, `warps` pairs a block, the strips (3 x TP
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
             TP, 0, (int*)rec};
  const size_t smem = (size_t)warps * 3 * TP;
  cudaError_t err = cudaFuncSetAttribute(
      extf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  extf_fwd_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 7's register form: one warp a pair, a block each, on a launch
// that ops/batch_extf.py:extf_form gives it (ncol + 48 <= 1024, the
// window's 4 slots).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ksw2t_batch_extf_reg_fwd(const void* qs, const void* ts,
                                        const void* qlen, const void* tlen,
                                        const void* w, int B, int Lq, int Lt,
                                        int mch, int mis, int e, int xdrop,
                                        int ncol, void* rec, void* stream) {
  if (B <= 0 || ncol % 16 || ncol + 48 > 256 * NU_X)
    return (int)cudaErrorInvalidValue;
  ExtfArgs a{(const uint8_t*)qs, (const uint8_t*)ts, (const int*)qlen,
             (const int*)tlen, (const int*)w, B, Lq, Lt, mch, mis, e, xdrop,
             0, ncol, (int*)rec};
  extf_reg_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
