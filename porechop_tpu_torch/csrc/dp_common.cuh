// One semi-global affine-gap DP (Gotoh, free end gaps, SeqAn tie rules) and
// one wavefront kernel body, dp_wave_kernel<MODE, AMAX, LW>, instantiated by
// the three hand-written Hopper kernels of this package:
//
//   dp_score.cu   SCORE: best score only    (replaces porechop_tpu/ops/
//                                             kernel_pallas.py _score_kernel
//                                             and _score_kernel_t)
//   dp_stats.cu   STATS: best cell + path   (replaces _stats_kernel and
//                        stats              _stats_kernel_t)
//   dp_tiled.cu   BITS:  best cell + trace  (replaces _forward_kernel and
//                        bits               _tiled_kernel)
//
// Recurrences, as written in ops/spec.py:
//   V[i][j] = max(V[i-1][j] + ext, M[i-1][j] + open)        (ties: extension)
//   H[i][j] = max(H[i][j-1] + ext, pre[i][j-1] + open)      (ties: extension)
//   pre     = max(M[i-1][j-1] + sub, V)                     (ties: diagonal)
//   M       = max(pre, H)                                   (ties: pre)
// (H from pre instead of M is exact for open < ext, the only schemes the
// dispatcher sends here.)  STATS and BITS evaluate a cell through dp_cell,
// so the tie rules are written once; SCORE needs values only, which do not
// depend on how ties break, and takes Hopper's DPX instructions instead
// (__viaddmax_s32 for V and the next H, __vimax3_s32 for M).
//
// Design.  The TPU kernels keep lanes (one read window against one adapter)
// in vector lanes and sweep adapter rows, with a windowed log-shift prefix
// max for H (kernel_pallas._prefix_window).  Here the parallel work inside
// one lane is across adapter rows, on the anti-diagonal: LW threads per
// lane (a warp, or for SCORE and STATS at narrow rungs 8 or 16 threads,
// G = 32 / LW lanes sharing a warp), thread t of a lane owning the R = AMAX
// / LW consecutive rows [R t, R t + R).  At step s of a tile thread t
// computes column j = jlo + s - t for its rows, top to bottom; the row
// above its first row (M and V at column j, M at column j - 1 received one
// step earlier, and for STATS their payloads) comes from thread t - 1 by
// __shfl_up_sync of width LW, and thread 0 uses row 0's boundary (M = 0,
// V = NEG).  H, the last M of each row (and STATS's payloads, BITS's H_EXT
// bits) stay in the owning thread's registers, so a tile edge costs no
// trip through memory.  H is computed exactly, column by column, so there
// is no prefix window.  A tile of T columns fills and drains the wavefront
// in T + LW - 1 steps; its read codes are staged in shared memory with
// coalesced loads.  A lane stops at its own read length, so the work is
// what each lane's data needs, and any L is taken.  Where lanes share a
// warp, the warp steps to the largest bound of its lanes (tiles, steps;
// a lane past B has no rows and no columns) and each lane masks its own
// cells, so that every full-mask shuffle is reached by all 32 threads.
//
//   mode   T      warps per block  lanes a warp  shared memory per warp
//   SCORE  1,024  4                1, 2 or 4     T read codes a lane
//   STATS  1,024  4                1, 2 or 4     T read codes a lane
//   BITS   256    1                1             T read codes + AMAX x T
//                                                trace bytes, written out
//                                                a row at a time with
//                                                16-byte stores
// SCORE and STATS need little shared memory (1 to 4 KB a warp), so 4-warp
// blocks let registers, not shared memory, bound their warps per SM;
// BITS's trace-byte buffer (8.4, 16.6, 24.8 and 33 KB per warp at AMAX 32,
// 64, 96 and 128) bounds its warps per SM first.  card_warps below asks
// the runtime how many warps of a one-lane-a-warp instantiation the card
// holds (dp_tiled.cu pdp_tiled_warps, dp_score.cu and dp_stats.cu
// pdp_*_warps).
//
// The planner pads adapters to the JAX package's rungs (ops/dispatch.py
// _A_LADDER: 16, 24, 32, 48, 64, 96, 128).  Instantiations (AMAX, LW):
// (32|64|96|128, 32) in every mode, the narrowest covering A; SCORE and
// STATS also (24, 8) and (48, 16), three rows a thread, for rungs 16-24
// and 48 (there is no built-in adapter of 16 bases or fewer, so rung 16
// runs only on the 24 instantiation's rows).  ops/kernels.py lane_group
// takes them for a launch of at least 3/4 as many lanes as the card holds
// one-lane-a-warp warps of the kernel, where the launch is bound by issue
// and the padding rows of AMAX 32 or 64 (8 or 16 of its threads idle on
// every step, 31 fill steps a tile instead of 7 or 15) cost the most; a
// launch of fewer lanes keeps one lane a warp (below).  Nothing in the
// body needs R or AMAX to be a power of two.
//
// BITS may also cut a lane into column chunks, one warp each, every chunk
// but the first starting with a warm-up sweep whose length is proven to
// make its values exact (dp_tiled.cu: the split, the proof, and the fold
// of the chunks' scouts); ops/kernels.py split_plan picks the chunks so
// that a launch of few long lanes fills the card.
//
// BITS with a walk (dp_tiled.cu pdp_forward_walk): the warp that elects an
// unsplit lane's cell walks it at once with dp_walk.cuh's body, reusing
// sbits -- in place when the lane is one tile, whose trace bytes then
// never leave the SM, else as the staging buffer for the bytes it has just
// written; bits_fold_kernel walks a split lane.
//
// Scouts: the thread holding row adapter_len keeps the last-row leftmost
// maximum over columns [0, read_len) with a strict > in increasing j; the
// final-column scout (first strict maximum down column read_len from
// M(0, read_len) = 0) is a per-thread scan of its rows then a butterfly
// over the lane's threads (the largest M, then the smallest row holding
// it), carrying the elected start state's flags (BITS) or payload (STATS:
// V == M -> V, else H == M -> H, else M); then the column-against-row
// election.  SCORE keeps a per-thread max over the last column and the
// last row, then a max over the lane's threads.
//
// What bounds it on an H100: the instruction rate (a step is two or four
// shuffles, the boundary selects, and R cells of integer operations) once a
// launch holds enough warps.  A lane takes read_len + (LW - 1) x tiles
// dependent steps of R cells each however wide the card, so a SCORE or
// STATS launch of few lanes is still bound by that chain, which three rows
// a thread lengthen (the reason lane_group keeps such launches at one lane
// a warp); BITS splits such a launch into column chunks and pays the
// warm-up instead.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "dp_walk.cuh"

namespace pdp {

constexpr int NEG = -(1 << 30);     // ops/spec.py NEG
constexpr int PAY_G_BIAS = 1 << 14;  // stats payload: mat * 2^15 + (g + 2^14)
constexpr int PAY_MAT = 1 << 15;
constexpr int TILE_T = 256;          // BITS tile: ops/kernels.py TILE_T
constexpr int SCAN_T = 1024;         // SCORE and STATS tile
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { SCORE = 0, STATS = 1, BITS = 2 };

__host__ __device__ constexpr int tile_of(int mode) {
  return mode == BITS ? TILE_T : SCAN_T;
}
__host__ __device__ constexpr int warps_of(int mode) {
  return mode == BITS ? 1 : 4;
}
// Per warp, of g lanes: each lane's T read codes (BITS: and its trace bytes).
__host__ __device__ constexpr int smem_of(int mode, int amax, int g = 1) {
  return tile_of(mode) * (mode == BITS ? 1 + amax : g);
}

// Error codes returned to the Python wrapper besides cudaError_t values.
constexpr int ERR_ADAPTER_TOO_LONG = 100000;
constexpr int ERR_BAD_L1P = 100001;
constexpr int ERR_BAD_SPLIT = 100002;
constexpr int ERR_NULL_OUTPUT = 100003;  // a null output the call writes
constexpr int ERR_BAD_GROUP = 100004;    // lanes a warp the width refuses

// BITS split into column chunks: ints per (chunk, lane) partial scout --
// last-row score, column and flags, final-column score and key.
constexpr int PART_INTS = 5;

struct Args {
  const int8_t* reads;       // (B, L) Dna5 codes 0..4
  const int32_t* read_lens;  // (B,)
  const int8_t* adapters;    // (B, A) Dna5 codes 0..4
  const int32_t* adapter_lens;
  int B, L, A, L1p;
  int match, mismatch, gap_open, gap_ext;
  int32_t* best;             // (B,) every mode
  int32_t* cell_i;           // (B,) stats, trace bits
  int32_t* cell_j;
  int32_t* pay;              // (B,) stats: payload of the elected start state
  uint8_t* vflag;            // (B,) trace bits
  uint8_t* hflag;
  uint8_t* bits;             // (A, B, L1p) trace bits
};

// BITS's arguments: Args and the column split.  (Score and stats keep Args
// alone: with the split's fields in Args, ptxas built the stats kernel with
// fewer registers and 3.6-4.6% slower at three of its four shapes,
// time_kernels.py on an H100.)
struct BitsArgs : Args {
  int nch, chunk_cols, warm_cols;  // column chunks of a lane
  int32_t* part;                   // (nch, B, PART_INTS), nch > 1
  int32_t* walk;                   // (B, WALK_OUTS) walk aggregates, or
                                   // null: no walk
};

template <int MODE>
using ArgsOf = std::conditional_t<MODE == BITS, BitsArgs, Args>;

__device__ __forceinline__ int lane_len(const int32_t* lens, int b, int cap) {
  return min(max(lens[b], 0), cap);
}

// A trace-bit lane's elected cell, its score and its start state.
struct Elected {
  int best, i, j;
  bool vf, hf;
};

// The column-against-row election of the trace-bit forward: the
// final-column scout (score tsc, key (row << 2) | (V flag << 1) | H flag)
// wins only if strictly better than the last-row scout.
__device__ __forceinline__ Elected elect_cell(int alen, int rlen, int tsc,
                                              int tkey, int rsc, int rj,
                                              int rflags) {
  const bool col_wins = tsc > rsc;
  const int flags = col_wins ? tkey & 3 : rflags;
  return Elected{col_wins ? tsc : rsc, col_wins ? tkey >> 2 : alen,
                 col_wins ? rlen : rj, (flags & 2) != 0, (flags & 1) != 0};
}

__device__ __forceinline__ void write_cell(const BitsArgs& p, int b,
                                           const Elected& e) {
  p.best[b] = e.best;
  p.cell_i[b] = e.i;
  p.cell_j[b] = e.j;
  p.vflag[b] = e.vf ? 1 : 0;
  p.hflag[b] = e.hf ? 1 : 0;
}

// One DP cell (i, j), from M(i-1, j-1) = mdiag, M(i-1, j) = mup,
// V(i-1, j) = vup and H(i, j) = h (computed at column j-1).
struct Cell {
  int v, d, pre, m;   // V, diagonal, pre and M of (i, j)
  int hnext;          // H(i, j+1)
  bool vbit;          // V extends
  bool dwin;          // pre takes the diagonal
  bool prewin;        // M takes pre
  bool hx;            // H(i, j+1) extends
};

__device__ __forceinline__ Cell dp_cell(int mdiag, int mup, int vup, int h,
                                        bool eq, int ma, int mm, int go,
                                        int ge) {
  Cell c;
  const int vext = vup + ge, vopen = mup + go;
  c.vbit = vext >= vopen;
  c.v = c.vbit ? vext : vopen;
  c.d = mdiag + (eq ? ma : mm);
  c.dwin = c.d >= c.v;
  c.pre = c.dwin ? c.d : c.v;
  c.prewin = c.pre >= h;
  c.m = c.prewin ? c.pre : h;
  const int hext = h + ge, hopen = c.pre + go;
  c.hx = hext >= hopen;
  c.hnext = c.hx ? hext : hopen;
  return c;
}

// H(i, 1) = max(H(i, 0) + ext, pre(i, 0) + open), H(i, 0) = NEG, pre = 0.
__device__ __forceinline__ int h_col1(int go, int ge) {
  return (NEG + ge) >= go ? NEG + ge : go;
}

// Trace byte of cell (i, j): H_EXT 1 (hbit, from next_hbit at column j-1),
// V_EXT 2, DIAG 4, MAX_V 8, EQ 16.
__device__ __forceinline__ uint32_t trace_byte(const Cell& c, int h,
                                               bool hbit, bool eq) {
  const int vh = c.v >= h ? c.v : h;
  return (hbit ? 1u : 0u) | (c.vbit ? 2u : 0u) | (c.d >= vh ? 4u : 0u)
       | (c.v >= h ? 8u : 0u) | (eq ? 16u : 0u);
}

// H_EXT bit of cell (i, j+1): H(i, j) + ext >= M(i, j) + open.
__device__ __forceinline__ bool next_hbit(const Cell& c, int h, int go,
                                          int ge) {
  return h + ge >= c.m + go;
}

// Column 0: M = 0, V = H = NEG; no H_EXT, no EQ; DIAG and MAX_V from
// NEG >= NEG.
__device__ __forceinline__ uint8_t col0_byte(int go, int ge) {
  return (uint8_t)((((NEG + ge) >= go) ? 2 : 0) | 4 | 8);
}

// A BITS warp stages its walk in its trace-byte buffer (sbits).
static_assert(STAGE_BYTES <= 32 * TILE_T, "the walk's block fits in sbits");

// LW threads a lane: G = 32 / LW lanes share a warp, each thread owning R =
// AMAX / LW rows.  With G > 1 the lanes of a warp end at different columns,
// so every loop bound below that differs between lanes is the warp's
// maximum, and a lane past its own bound (or past B) steps masked: every
// full-mask shuffle is reached by all 32 threads.
template <int MODE, int AMAX, int LW = 32>
__global__ void __launch_bounds__(32 * warps_of(MODE))
dp_wave_kernel(ArgsOf<MODE> p) {
  static_assert(MODE != BITS || LW == 32, "BITS runs one lane a warp");
  static_assert(32 % LW == 0 && AMAX % LW == 0, "whole lanes, whole rows");
  constexpr int G = 32 / LW;
  constexpr int R = AMAX / LW;
  constexpr int T = tile_of(MODE);
  constexpr int W = warps_of(MODE), SMEM = smem_of(MODE, AMAX, G);
  constexpr bool SC = MODE == SCORE, ST = MODE == STATS, BI = MODE == BITS;
  constexpr int P0 = PAY_G_BIAS;
  extern __shared__ __align__(16) uint8_t smem[];

  const int t = threadIdx.x & 31;
  const int tg = t % LW;               // rank in the lane
  const int w = W > 1 ? threadIdx.x >> 5 : 0;
  // BITS: block k * B + b sweeps column chunk k of lane b (k = 0 unsplit).
  const int b0 = BI ? (int)(blockIdx.x % p.B) : (blockIdx.x * W + w) * G;
  if (b0 >= p.B) return;               // the whole warp
  const int b = b0 + t / LW;
  const bool live = G == 1 || b < p.B; // a lane past B steps masked
  uint8_t* sread = smem + w * SMEM + (t / LW) * T;
  uint8_t* sbits = sread + T;          // BITS: [adapter row][T] trace bytes

  const int rlen = live ? lane_len(p.read_lens, b, p.L) : 0;
  const int alen = live ? lane_len(p.adapter_lens, b, p.A) : 0;
  // Own columns [c0, c1), after a warm-up over [w0, c0) that writes no
  // trace bytes and scouts nothing.  A chunk starting past read_len has no
  // column to own.
  int k = 0, c0 = 0, c1 = rlen + 1, w0 = 0;
  if constexpr (BI) {
    k = blockIdx.x / p.B;
    c0 = k * p.chunk_cols;
    if (c0 > rlen) return;
    c1 = min(c0 + p.chunk_cols, rlen + 1);
    w0 = max(c0 - p.warm_cols, 0);
  }
  const bool cold = w0 > 0;            // start from the lower-bound boundary
  const int ma = p.match, mm = p.mismatch, go = p.gap_open, ge = p.gap_ext;
  const int8_t* read = p.reads + (size_t)b * p.L;
  const int8_t* adp = p.adapters + (size_t)b * p.A;
  const size_t plane = (size_t)p.B * p.L1p;       // BITS
  uint8_t* lane_bits = BI ? p.bits + (size_t)b * p.L1p : nullptr;
  // BITS: a lane of one tile that walks in this kernel walks from sbits,
  // and its trace bytes never reach device memory (p.bits may be null).
  bool store_bits = false;
  if constexpr (BI) store_bits = p.walk == nullptr || p.L1p != T;

  const int row0 = R * tg;             // this thread's first row slot
  const int nt = (alen + R - 1) / R;   // threads that own rows < alen
  const int last_row = alen - 1;       // slot of row adapter_len
  int acode[R], M[R], Hn[R];
  int PM[ST ? R : 1], PHn[ST ? R : 1]; // payloads of M(i, j-1), H(i, j)
  uint32_t hb = 0;                     // bit r: H_EXT bit of the next column
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acode[r] = row0 + r < alen ? adp[row0 + r] : -1;
    M[r] = cold ? NEG : 0;               // M(i, w0 - 1)
    Hn[r] = cold ? NEG : h_col1(go, ge); // H(i, max(w0, 1))
    if constexpr (BI) {
      if (!cold && (NEG + ge) >= go) hb |= 1u << r;
    }
    if constexpr (ST) {
      PM[r] = P0;
      PHn[r] = P0 + (row0 + r + 1 < alen ? 1 : 0);
    }
  }

  int m_out = 0, v_out = NEG;  // M, V of this thread's last row, last column
  int m_prev = cold ? NEG : 0; // M(row0 - 1, j - 1), received a step earlier
  int pm_out = P0, pv_out = P0, pm_prev = P0;   // STATS: their payloads
  int best = 0;                                 // SCORE
  const bool last_row_here = alen > 0 && tg == last_row / R;
  int tsc = 0, ti = 0, tpay = P0;
  bool tvf = false, thf = false;
  // The last-row scout starts at column 0 (M = 0) in the chunk holding it.
  int rsc = rlen > 0 && k == 0 ? 0 : -(1 << 30) - (1 << 29), rj = 0;
  int rpay = P0;
  bool rvf = false, rhf = false;

  // Columns w0..c1 - 1; the warp's last lane to end sets the tiles.
  const int c1_warp = G == 1 ? c1 : __reduce_max_sync(FULL_MASK, c1);
  const int tile_hi = (c1_warp + T - 1) / T;
  for (int tile = w0 / T; tile < tile_hi; ++tile) {
    const int jlo = tile * T;
    const int jhi = min(jlo + T, c1);
    const bool own = !BI || jlo >= c0;   // c0 is a multiple of T
    for (int c = tg; c < jhi - jlo; c += LW) {   // column j holds read[j-1]
      const int j = jlo + c;
      sread[c] = j > 0 ? (uint8_t)read[j - 1] : (uint8_t)4;
    }
    if constexpr (BI) {
      if (jlo == 0) {
        const uint8_t b0 = col0_byte(go, ge);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (row0 + r < alen) sbits[(row0 + r) * T] = b0;
      }
    }
    __syncwarp();

    const int jstart = BI ? max(max(jlo, w0), 1) : max(jlo, 1);
    // A lane past its last column has jhi <= jlo: all its steps masked.
    const int lane_steps = jhi - jlo + (nt > 0 ? nt - 1 : 0);
    const int nsteps =
        G == 1 ? lane_steps : __reduce_max_sync(FULL_MASK, lane_steps);
    for (int s = 0; s < nsteps; ++s) {
      const int m_in = __shfl_up_sync(FULL_MASK, m_out, 1, LW);
      const int v_in = __shfl_up_sync(FULL_MASK, v_out, 1, LW);
      int pm_in = P0, pv_in = P0;
      if constexpr (ST) {
        pm_in = __shfl_up_sync(FULL_MASK, pm_out, 1, LW);
        pv_in = __shfl_up_sync(FULL_MASK, pv_out, 1, LW);
      }
      const int j = jlo + s - tg;
      if (tg < nt && j >= jstart && j < jhi) {
        int mdiag = tg == 0 ? 0 : m_prev;
        int mup = tg == 0 ? 0 : m_in;
        int vup = tg == 0 ? NEG : v_in;
        int pdiag = tg == 0 ? P0 : pm_prev;
        int pmup = tg == 0 ? P0 : pm_in;
        int pvup = tg == 0 ? P0 : pv_in;
        const int rc = sread[j - jlo];
        const bool last_col = j == rlen;
        uint8_t* col = sbits + (j - jlo);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = row0 + r;
          if (i >= alen) break;
          const bool eq = rc == acode[r];
          const int h = Hn[r];
          if constexpr (SC) {
            const int v = __viaddmax_s32(vup, ge, mup + go);
            const int d = mdiag + (eq ? ma : mm);
            Hn[r] = __viaddmax_s32(h, ge, max(d, v) + go);
            mdiag = M[r];
            mup = M[r] = __vimax3_s32(d, v, h);
            vup = v;
          } else {
            const Cell c = dp_cell(mdiag, mup, vup, h, eq, ma, mm, go, ge);
            if constexpr (BI) {
              col[i * T] = (uint8_t)trace_byte(c, h, (hb >> r) & 1u, eq);
              hb = next_hbit(c, h, go, ge) ? hb | (1u << r)
                                           : hb & ~(1u << r);
            }
            int pv = P0, ph = P0, pm = P0;
            if constexpr (ST) {
              pv = c.vbit ? pvup : pmup;
              const int ppre = c.dwin ? pdiag + (eq ? PAY_MAT : 0) : pv;
              ph = PHn[r];
              pm = c.prewin ? ppre : ph;
              pdiag = PM[r];
              PHn[r] = (c.hx ? ph : ppre) + (i + 1 < alen ? 1 : 0);
              PM[r] = pm;
              pmup = pm;
              pvup = pv;
            }
            mdiag = M[r];
            M[r] = c.m;
            Hn[r] = c.hnext;
            mup = c.m;
            vup = c.v;
            if (last_col) {
              if (c.m > tsc) {
                tsc = c.m;
                ti = i + 1;
                tvf = c.v == c.m;
                thf = !tvf && h == c.m;
                tpay = tvf ? pv : (thf ? ph : pm);
              }
            } else if (own && i == last_row && c.m > rsc) {
              rsc = c.m;
              rj = j;
              rvf = c.v == c.m;
              rhf = !rvf && h == c.m;
              rpay = rvf ? pv : (rhf ? ph : pm);
            }
          }
        }
        if constexpr (SC) {
          if (last_row_here) best = max(best, mup);  // M(adapter_len, j)
        }
        m_out = mup;
        v_out = vup;
        m_prev = m_in;
        if constexpr (ST) {
          pm_out = pmup;
          pv_out = pvup;
          pm_prev = pm_in;
        }
      }
    }
    __syncwarp();

    if constexpr (BI) {
      // Rows < adapter_len, columns [jlo, jhi) rounded up to 16 bytes: a
      // chunk's own columns, which end on a tile edge but in the last chunk.
      if (own && store_bits) {
        const int nq = (jhi - jlo + 15) / 16;
        for (int n = t; n < alen * nq; n += 32) {
          const int i = n / nq, q = n % nq;
          *reinterpret_cast<uint4*>(lane_bits + i * plane + jlo + 16 * q) =
              *reinterpret_cast<const uint4*>(sbits + i * T + 16 * q);
        }
      }
      __syncwarp();
    }
  }

  if constexpr (SC) {
    // The sweep ended at column read_len: M[r] holds M(row, read_len), and
    // rows past adapter_len keep M = 0 <= best.
#pragma unroll
    for (int r = 0; r < R; ++r) best = max(best, M[r]);
    if constexpr (G == 1) {
      best = __reduce_max_sync(FULL_MASK, best);
    } else {
#pragma unroll
      for (int off = LW / 2; off > 0; off >>= 1)
        best = max(best, __shfl_xor_sync(FULL_MASK, best, off, LW));
    }
    if (tg == 0 && live) p.best[b] = best;
  } else {
    // Final-column scout across the lane: the largest M, then the smallest
    // row (ti packs the row and both flags).
    int tkey = (ti << 2) | (tvf ? 2 : 0) | (thf ? 1 : 0);
#pragma unroll
    for (int off = LW / 2; off > 0; off >>= 1) {
      const int osc = __shfl_xor_sync(FULL_MASK, tsc, off, LW);
      const int okey = __shfl_xor_sync(FULL_MASK, tkey, off, LW);
      int opay = P0;
      if constexpr (ST) opay = __shfl_xor_sync(FULL_MASK, tpay, off, LW);
      if (osc > tsc || (osc == tsc && okey < tkey)) {
        tsc = osc;
        tkey = okey;
        tpay = opay;
      }
    }
    const int owner = alen > 0 ? last_row / R : 0;
    rsc = __shfl_sync(FULL_MASK, rsc, owner, LW);
    rj = __shfl_sync(FULL_MASK, rj, owner, LW);
    const int rflags = __shfl_sync(FULL_MASK, (rvf ? 2 : 0) | (rhf ? 1 : 0),
                                   owner, LW);
    if constexpr (ST) rpay = __shfl_sync(FULL_MASK, rpay, owner, LW);
    if constexpr (BI) {
      if (p.nch > 1) {         // folded across chunks by bits_fold_kernel
        if (t == 0) {
          int32_t* q = p.part + ((size_t)k * p.B + b) * PART_INTS;
          q[0] = rsc;
          q[1] = rj;
          q[2] = rflags;
          q[3] = tsc;
          q[4] = tkey;
        }
      } else {
        // Every thread holds both scouts, so every thread elects.
        const Elected e = elect_cell(alen, rlen, tsc, tkey, rsc, rj, rflags);
        if (t == 0) write_cell(p, b, e);
        if (p.walk != nullptr) {
          Walk wk = walk_start(e.i, e.j, e.vf, e.hf);
          if (p.L1p == T) {
            // One tile: sbits holds the lane's every trace byte.
            walk_block(wk, sbits, T, 0, 0);
          } else {
            // The warp's own stores of the bytes it now reads back; sbits
            // is free to stage them.
            __threadfence_block();
            __syncwarp();
            walk_staged<16>(wk, lane_bits, plane, sbits);
          }
          if (t == 0) walk_store(wk, p.walk + (size_t)b * WALK_OUTS);
        }
      }
    } else if (tg == 0 && live) {
      const bool col_wins = tsc > rsc;
      p.best[b] = col_wins ? tsc : rsc;
      p.cell_i[b] = col_wins ? tkey >> 2 : alen;
      p.cell_j[b] = col_wins ? rlen : rj;
      p.pay[b] = col_wins ? tpay : rpay;
    }
  }
}

template <int MODE, int AMAX, int LW = 32>
int launch_wave(const ArgsOf<MODE>& p, cudaStream_t stream) {
  constexpr int W = warps_of(MODE), G = 32 / LW;
  const int smem = W * smem_of(MODE, AMAX, G);
  auto kern = dp_wave_kernel<MODE, AMAX, LW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = (p.B + W * G - 1) / (W * G);
  if constexpr (MODE == BITS) blocks = p.B * p.nch;
  const dim3 grid(blocks);
  const dim3 block(32 * W);
  kern<<<grid, block, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches, for `group` lanes a warp, the narrowest instantiation whose
// rows cover A: with one lane a warp AMAX 32, 64, 96 or 128; SCORE and
// STATS also take four lanes of 8 threads (AMAX 24) or two of 16 (AMAX
// 48), three rows a thread.  Returns 0 or an error code
// (cudaGetLastError() after the launch).
template <int MODE>
int launch(const ArgsOf<MODE>& p, int group, cudaStream_t stream) {
  if (p.B <= 0) return 0;
  if (p.A > 128) return ERR_ADAPTER_TOO_LONG;
  if constexpr (MODE != BITS) {
    if (group == 4 && p.A <= 24) return launch_wave<MODE, 24, 8>(p, stream);
    if (group == 2 && p.A <= 48) return launch_wave<MODE, 48, 16>(p, stream);
  }
  if (group != 1) return ERR_BAD_GROUP;
  if (p.A <= 32) return launch_wave<MODE, 32>(p, stream);
  if (p.A <= 64) return launch_wave<MODE, 64>(p, stream);
  if (p.A <= 96) return launch_wave<MODE, 96>(p, stream);
  return launch_wave<MODE, 128>(p, stream);
}

// The blocks of dp_wave_kernel<MODE, AMAX> (one lane a warp) that the
// current device holds at once, times its warps a block: its resident
// warps, as the runtime's occupancy query gives them.
template <int MODE, int AMAX>
int resident_warps(int* warps) {
  constexpr int W = warps_of(MODE);
  auto kern = dp_wave_kernel<MODE, AMAX>;
  const int smem = W * smem_of(MODE, AMAX);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * W,
                                                      smem);
  *warps = per_sm * sms * W;
  return (int)e;
}

// resident_warps of the one-lane-a-warp instantiation that serves A.
template <int MODE>
int card_warps(int A, int* warps) {
  if (A <= 32) return resident_warps<MODE, 32>(warps);
  if (A <= 64) return resident_warps<MODE, 64>(warps);
  if (A <= 96) return resident_warps<MODE, 96>(warps);
  if (A <= 128) return resident_warps<MODE, 128>(warps);
  return ERR_ADAPTER_TOO_LONG;
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
