// One semi-global affine-gap DP body (Gotoh, free end gaps, SeqAn tie
// rules) shared by the three hand-written Hopper kernels of this package:
//
//   dp_score.cu   best score only         (replaces porechop_tpu/ops/kernel_pallas.py
//                                           _score_kernel and _score_kernel_t)
//   dp_stats.cu   best cell + path stats  (replaces _stats_kernel and _stats_kernel_t)
//   dp_bitmap.cu  best cell + trace bits  (replaces _forward_kernel)
//
// Layout and design.  One thread owns one lane (one read window against one
// adapter) and sweeps the read's columns left to right; the adapter axis
// (rows, at most AMAX) lives in registers as a column of DP state, so every
// recurrence is evaluated exactly as written in ops/spec.py:
//   V[i][j] = max(V[i-1][j] + ext, M[i-1][j] + open)        (ties: extension)
//   H[i][j] = max(H[i][j-1] + ext, pre[i][j-1] + open)      (ties: extension)
//   pre     = max(M[i-1][j-1] + sub, V)                     (ties: diagonal)
//   M       = max(pre, H)                                   (ties: pre)
// (H from pre instead of M is exact for open < ext, the only schemes the
// dispatcher sends here.)  The TPU kernels instead sweep rows with the
// columns in vector lanes and need a windowed log-shift prefix max for H
// (kernel_pallas._prefix_window); the per-lane column sweep needs neither,
// and only touches the rows <= adapter_len and columns <= read_len that the
// result depends on.
//
// What bounds it on an H100: integer operations, ~15-30 per cell, with one
// lane per thread; at the middle-adapter shape (16k lanes) that is only ~4
// warps per SM, so the sweep is latency-bound, not throughput-bound.  The
// bitmap mode also stores one byte per cell with a lane stride of L1p bytes
// (uncoalesced).  A warp-per-lane anti-diagonal wavefront and the DPX
// instructions (__viaddmax, __vimax3) are the planned fixes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pdp {

constexpr int NEG = -(1 << 30);     // ops/spec.py NEG
constexpr int PAY_G_BIAS = 1 << 14;  // stats payload: mat * 2^15 + (g + 2^14)
constexpr int PAY_MAT = 1 << 15;
constexpr int LANES_PER_BLOCK = 32;

enum Mode { SCORE = 0, STATS = 1, BITMAP = 2 };

// Error codes returned to the Python wrapper besides cudaError_t values.
constexpr int ERR_ADAPTER_TOO_LONG = 100000;

struct Args {
  const int8_t* reads;       // (B, L) Dna5 codes 0..4
  const int32_t* read_lens;  // (B,)
  const int8_t* adapters;    // (B, A) Dna5 codes 0..4
  const int32_t* adapter_lens;
  int B, L, A, L1p;
  int match, mismatch, gap_open, gap_ext;
  int32_t* best;             // (B,) every mode
  int32_t* cell_i;           // (B,) stats, bitmap
  int32_t* cell_j;
  int32_t* pay;              // (B,) stats: payload of the elected start state
  uint8_t* vflag;            // (B,) bitmap
  uint8_t* hflag;
  uint8_t* bits;             // (A, B, L1p) bitmap
};

template <int MODE, int AMAX>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
dp_lane_kernel(Args p) {
  constexpr int NW = AMAX / 32;
  constexpr bool STAT = MODE == STATS;
  constexpr bool BITS = MODE == BITMAP;
  constexpr bool SCOUT = MODE != SCORE;

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int rlen = min(max(p.read_lens[b], 0), p.L);
  const int alen = min(max(p.adapter_lens[b], 0), p.A);
  const int ma = p.match, mm = p.mismatch, go = p.gap_open, ge = p.gap_ext;
  const int8_t* read = p.reads + (size_t)b * p.L;
  const int8_t* adp = p.adapters + (size_t)b * p.A;
  const size_t plane = (size_t)p.B * p.L1p;
  uint8_t* lane_bits = BITS ? p.bits + (size_t)b * p.L1p : nullptr;

  // eqm[c][w] bit k: adapter[32w + k] == code c (c = 0..4; N == N).
  uint32_t eqm[5][NW];
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int w = 0; w < NW; ++w) eqm[c][w] = 0u;
#pragma unroll
  for (int i = 0; i < AMAX; ++i) {   // unrolled: register-resident eqm
    if (i >= alen) break;
    const int c = adp[i];
#pragma unroll
    for (int cc = 0; cc < 5; ++cc)
      if (c == cc) eqm[cc][i >> 5] |= 1u << (i & 31);
  }

  // Column state for the previous column, row i+1 in slot i.
  int M[AMAX];       // M[i][j-1]
  int Hn[AMAX];      // H[i][j] (next column's H, from column j-1)
  int PM[STAT ? AMAX : 1];
  int PHn[STAT ? AMAX : 1];
  uint32_t hb[BITS ? NW : 1];  // H_EXT bit of the next column
  const bool hb0 = (NEG + ge) >= go;          // H[i][0] = NEG, M[i][0] = 0
#pragma unroll
  for (int i = 0; i < AMAX; ++i) {
    M[i] = 0;
    Hn[i] = (NEG + ge) >= go ? NEG + ge : go;  // pre[i][0] = 0
    if constexpr (STAT) {
      PM[i] = PAY_G_BIAS;
      PHn[i] = PAY_G_BIAS + (i + 1 < alen ? 1 : 0);
    }
  }
  if constexpr (BITS) {
#pragma unroll
    for (int w = 0; w < NW; ++w) hb[w] = hb0 ? 0xffffffffu : 0u;
    // Column 0: no H_EXT, no EQ; DIAG and MAX_V from NEG >= NEG.
    const uint8_t b0 = (uint8_t)((((NEG + ge) >= go) ? 2 : 0) | 4 | 8);
    for (int i = 0; i < alen; ++i) lane_bits[i * plane] = b0;
  }

  // Final-column scout: first strict max down column read_len, from
  // M(0, read_len) = 0.  Last-row scout: leftmost max along row
  // adapter_len over columns [0, read_len), from M(alen, 0) = 0.
  int tsc = 0, ti = 0, tpay = PAY_G_BIAS;
  bool tvf = false, thf = false;
  int rsc = rlen > 0 ? 0 : -(1 << 30) - (1 << 29), rj = 0, rpay = PAY_G_BIAS;
  bool rvf = false, rhf = false;
  int best = 0;   // score mode

  for (int j = 1; j <= rlen; ++j) {
    const int r = read[j - 1];
    uint32_t eqw[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w)
      eqw[w] = r == 0 ? eqm[0][w] : r == 1 ? eqm[1][w] : r == 2 ? eqm[2][w]
             : r == 3 ? eqm[3][w] : eqm[4][w];
    const bool last_col = j == rlen;
    int mdiag = 0, pdiag = PAY_G_BIAS;          // M(0, j-1)
    int mup = 0, pmup = PAY_G_BIAS;             // M(0, j)
    int vup = NEG, pvup = PAY_G_BIAS;           // V(0, j)
    uint32_t hbn[BITS ? NW : 1];
#pragma unroll
    for (int w = 0; w < (BITS ? NW : 1); ++w) hbn[w] = 0u;
#pragma unroll
    for (int i = 0; i < AMAX; ++i) {
      if (i >= alen) break;
      const bool eq = (eqw[i >> 5] >> (i & 31)) & 1u;
      const int vext = vup + ge, vopen = mup + go;
      const bool vbit = vext >= vopen;
      const int v = vbit ? vext : vopen;
      const int d = mdiag + (eq ? ma : mm);
      const bool dwin = d >= v;
      const int pre = dwin ? d : v;
      const int h = Hn[i];
      const bool prewin = pre >= h;
      const int m = prewin ? pre : h;
      const int hext = h + ge, hopen = pre + go;
      const bool hx = hext >= hopen;
      int pv = 0, ph = 0, pm = 0;
      if constexpr (STAT) {
        pv = vbit ? pvup : pmup;
        const int pd = pdiag + (eq ? PAY_MAT : 0);
        const int ppre = dwin ? pd : pv;
        ph = PHn[i];
        pm = prewin ? ppre : ph;
        pdiag = PM[i];
        PHn[i] = (hx ? ph : ppre) + (i + 1 < alen ? 1 : 0);
        PM[i] = pm;
        pmup = pm;
        pvup = pv;
      }
      if constexpr (BITS) {
        const int vh = v >= h ? v : h;
        const uint32_t byte = ((hb[i >> 5] >> (i & 31)) & 1u)
                            | (vbit ? 2u : 0u) | (d >= vh ? 4u : 0u)
                            | (v >= h ? 8u : 0u) | (eq ? 16u : 0u);
        lane_bits[i * plane + j] = (uint8_t)byte;
        if (h + ge >= m + go) hbn[i >> 5] |= 1u << (i & 31);
      }
      mdiag = M[i];
      M[i] = m;
      Hn[i] = hx ? hext : hopen;
      mup = m;
      vup = v;
      if constexpr (SCOUT) {
        if (last_col && m > tsc) {
          tsc = m;
          ti = i + 1;
          tvf = v == m;
          thf = !tvf && h == m;
          if constexpr (STAT) tpay = tvf ? pv : (thf ? ph : pm);
        }
        if (!last_col && i + 1 == alen && m > rsc) {
          rsc = m;
          rj = j;
          rvf = v == m;
          rhf = !rvf && h == m;
          if constexpr (STAT) rpay = rvf ? pv : (rhf ? ph : pm);
        }
      } else {
        if (last_col || i + 1 == alen) best = m > best ? m : best;
      }
    }
    if constexpr (BITS) {
#pragma unroll
      for (int w = 0; w < NW; ++w) hb[w] = hbn[w];
    }
  }

  if constexpr (SCOUT) {
    const bool col_wins = tsc > rsc;
    p.best[b] = col_wins ? tsc : rsc;
    p.cell_i[b] = col_wins ? ti : alen;
    p.cell_j[b] = col_wins ? rlen : rj;
    if constexpr (STAT) p.pay[b] = col_wins ? tpay : rpay;
    if constexpr (BITS) {
      p.vflag[b] = col_wins ? tvf : rvf;
      p.hflag[b] = col_wins ? thf : rhf;
    }
  } else {
    p.best[b] = best;
  }
}

// Launches the instantiation whose register column covers A rows and
// returns 0 or an error code (cudaGetLastError() after the launch).
template <int MODE>
int launch(const Args& p, cudaStream_t stream) {
  if (p.B <= 0) return 0;
  const dim3 grid((p.B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK);
  const dim3 block(LANES_PER_BLOCK);
  if (p.A <= 32) {
    dp_lane_kernel<MODE, 32><<<grid, block, 0, stream>>>(p);
  } else if (p.A <= 64) {
    dp_lane_kernel<MODE, 64><<<grid, block, 0, stream>>>(p);
  } else if (p.A <= 128) {
    dp_lane_kernel<MODE, 128><<<grid, block, 0, stream>>>(p);
  } else {
    return ERR_ADAPTER_TOO_LONG;
  }
  return (int)cudaGetLastError();
}

inline Args make_args(const void* reads, const void* read_lens,
                      const void* adapters, const void* adapter_lens,
                      int B, int L, int A, int L1p, int match, int mismatch,
                      int gap_open, int gap_ext) {
  Args p{};
  p.reads = static_cast<const int8_t*>(reads);
  p.read_lens = static_cast<const int32_t*>(read_lens);
  p.adapters = static_cast<const int8_t*>(adapters);
  p.adapter_lens = static_cast<const int32_t*>(adapter_lens);
  p.B = B;
  p.L = L;
  p.A = A;
  p.L1p = L1p;
  p.match = match;
  p.mismatch = mismatch;
  p.gap_open = gap_open;
  p.gap_ext = gap_ext;
  return p;
}

}  // namespace pdp
