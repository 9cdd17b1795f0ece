// The trace-bit walk's body: SeqAn's GapsLeft traceback of one lane from
// its elected cell to the DP's first row or column, folded into ten
// reverse-walk aggregates.  Counterpart of the XLA lax.while_loop of
// porechop_tpu/ops/engine_v2.py _traceback_impl (:252, not a Pallas kernel)
// and its host twin porechop_tpu/native/traceback.cpp; ops/kernels.py
// walk_plain is its plain version.  Three kernels run it, one warp per
// lane: the trace-bit kernel's epilogue (dp_common.cuh, an unsplit
// launch), bits_fold_kernel (dp_tiled.cu, a launch cut into column chunks)
// and the standalone dp_walk_kernel (dp_walk.cu).
//
// Trace bytes: H_EXT 1, V_EXT 2, DIAG 4, MAX_V 8, EQ 16; the byte of cell
// (i, j) lies on byte row i - 1, column j.  Aggregates, in order: i0, j0
// (where the walk stopped), n_path (moves), matches (diagonal moves on
// equal codes), rd_tmin/rd_tmax and ad_tmin/ad_tmax (first/last move index
// that holds a read / adapter base, -1 when none), s_ar_rev (adapter bases
// before the last read column), s_ra_rev (read bases before the last
// adapter column).
//
// Design.  The walk is a chain of dependent one-byte reads, each move's
// byte chosen by the move before; one thread reading device memory pays a
// round trip a move.  A path only moves up and left, so the warp first
// stages a block of STAGE_ROWS x STAGE_COLS trace bytes that ends at the
// current cell into shared memory, with 16-byte loads spread over its 32
// threads (one round trip to device memory), and walks inside the block a
// run of moves at a time (walk_block); when the path leaves through the
// block's top or left edge, the warp stages the next block.  A block holds
// at least 48 columns left of the cell and 63 byte rows above it, so a
// path of n moves stages at most about n / 49 + 1 blocks.  A lane whose
// whole DP is already in shared memory (the trace-bit kernel's one-tile
// launches) walks there with no staging and no trace byte in device
// memory.
//
// What bounds it on an H100: latency, a device-memory round trip a staged
// block and a shared-memory round trip and two ballots a run; the bytes
// are far below the memory rate.  Standalone (dp_walk.cu), 5.0-11.6 us at
// the middle phase's launches of 128-512 lanes and 25.6 us at 16,384
// lanes, where each warp stages 2 KB for ~20 moves; in the trace-bit
// launch 0.2-3.4% over the forward alone at the main path's shapes, where
// a one-thread walk of each block took 8.5% at phase 2's end windows
// (chip_smoke.py and time_kernels.py --walk, H100 SXM at 700 W).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pdp {

constexpr int WALK_OUTS = 10;
constexpr int STAGE_ROWS = 64;
constexpr int STAGE_COLS = 64;               // a multiple of 16
constexpr int STAGE_BYTES = STAGE_ROWS * STAGE_COLS;
constexpr uint8_t B_HEXT = 1, B_VEXT = 2, B_DIAG = 4, B_MAXV = 8, B_EQ = 16;

struct Walk {
  int i, j;
  int mode;        // 0 dispatch, 1 vertical run, 2 horizontal run
  int t, matches, rd_tmin, rd_tmax, ad_tmin, ad_tmax, s_ar_rev, s_ra_rev;
};

// A walk from cell (i, j) in the start state the flags give.  A lane
// outside the DP (a pad lane, i or j of 0) makes no move.
__device__ __forceinline__ Walk walk_start(int i, int j, bool vflag,
                                           bool hflag) {
  Walk w;
  w.i = i;
  w.j = j;
  w.mode = i > 0 && j > 0 ? (vflag ? 1 : (hflag ? 2 : 0)) : 0;
  w.t = w.matches = w.s_ar_rev = w.s_ra_rev = 0;
  w.rd_tmin = w.rd_tmax = w.ad_tmin = w.ad_tmax = -1;
  return w;
}

__device__ __forceinline__ unsigned low_bits(int n) {  // bits [0, n)
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ int ones_from_bit0(unsigned m) {
  return m == 0xffffffffu ? 32 : __ffs((int)~m) - 1;
}

// The calling warp (all 32 threads, each with the same w) moves while the
// current cell's byte lies in a block of bytes whose element (r, c) is the
// byte of byte row r0 + r, column c0 + c, at blk[r * stride + c].  The
// block must hold every byte row from r0 to the current cell's and every
// column from c0 to its: a path never moves down or right.
//
// A path is a chain of runs, and a run's moves are known from its bytes
// alone: a diagonal run (dispatch on a DIAG byte) goes on while the next
// byte on the diagonal has DIAG; a vertical run (a vertical run's mode, or
// dispatch on a MAX_V byte without DIAG) moves up once from each cell and
// goes on while that cell's byte has V_EXT and its row is not 1; a
// horizontal run likewise along the row with H_EXT.  So thread t reads the
// byte t moves along each of the three, the warp's ballots give the length
// of the run that the current byte starts (up to 32 moves) and its EQ
// bytes, and every thread folds the run into the aggregates: one
// shared-memory round trip a run where a one-thread walk paid one a move.
__device__ __forceinline__ void walk_block(Walk& w, const uint8_t* blk,
                                           int stride, int r0, int c0) {
  constexpr unsigned ALL = 0xffffffffu;
  const int t = threadIdx.x & 31;
  while (w.i > r0 && w.j > 0 && w.j >= c0) {
    const int n0 = (w.i - 1 - r0) * stride + (w.j - c0);
    // Cells t moves up, left and up-left: read if in the block, else the
    // index is clamped to the current cell's.
    const bool in_u = w.i - t > r0;
    const bool in_l = w.j - t > 0 && w.j - t >= c0;
    const bool in_d = in_u && in_l;
    const uint8_t tv = blk[n0];
    const uint8_t bu = blk[in_u ? n0 - t * stride : n0];
    const uint8_t bl = blk[in_l ? n0 - t : n0];
    const uint8_t bd = blk[in_d ? n0 - t * (stride + 1) : n0];
    const int t0 = w.t;
    int n;                                   // moves of this run
    if (w.mode == 0 && (tv & B_DIAG)) {
      n = ones_from_bit0(__ballot_sync(ALL, in_d && (bd & B_DIAG)));
      w.matches += __popc(__ballot_sync(ALL, bd & B_EQ) & low_bits(n));
      if (w.rd_tmin < 0) {
        w.rd_tmin = t0;
        w.s_ar_rev = w.i - 1;
      }
      if (w.ad_tmin < 0) {
        w.ad_tmin = t0;
        w.s_ra_rev = w.j - 1;
      }
      w.rd_tmax = w.ad_tmax = t0 + n - 1;
      w.i -= n;
      w.j -= n;
    } else if (w.mode == 1 || (w.mode == 0 && (tv & B_MAXV))) {
      // Move k needs its cell in the block and, past the first, the move
      // before it to have gone on.
      const unsigned on = __ballot_sync(
          ALL, in_u && (bu & B_VEXT) && w.i - t != 1);
      n = ones_from_bit0(__ballot_sync(ALL, in_u) & ((on << 1) | 1u));
      if (w.ad_tmin < 0) {
        w.ad_tmin = t0;
        w.s_ra_rev = w.j;
      }
      w.ad_tmax = t0 + n - 1;
      w.i -= n;
      w.mode = (on >> (n - 1)) & 1u;
    } else {
      const unsigned on = __ballot_sync(
          ALL, in_l && (bl & B_HEXT) && w.j - t != 1);
      n = ones_from_bit0(__ballot_sync(ALL, in_l) & ((on << 1) | 1u));
      if (w.rd_tmin < 0) {
        w.rd_tmin = t0;
        w.s_ar_rev = w.i;
      }
      w.rd_tmax = t0 + n - 1;
      w.j -= n;
      w.mode = (on >> (n - 1)) & 1u ? 2 : 0;
    }
    w.t += n;
  }
}

// The whole walk of one lane by the calling warp (all 32 threads, each
// with the same start w), over bytes in device memory: the byte of cell
// (i, j) at lane_bits[(i - 1) plane + j].  VEC is the bytes of each staging
// load: 16 where lane_bits and plane are multiples of 16 (every row then
// readable up to align16(j + 1), which the caller ensures), else 1.
// stage: STAGE_BYTES of shared memory, 16-byte aligned, the warp's own.
template <int VEC>
__device__ __forceinline__ void walk_staged(Walk& w,
                                            const uint8_t* lane_bits,
                                            size_t plane, uint8_t* stage) {
  static_assert(VEC == 1 || VEC == 16, "16-byte or byte loads");
  const int t = threadIdx.x & 31;
  while (w.i > 0 && w.j > 0) {
    // Byte rows [r0, i), columns [c0, c_hi): the block ending at (i, j).
    const int r0 = max(w.i - STAGE_ROWS, 0);
    const int c_hi = VEC == 16 ? (w.j + 16) & ~15 : w.j + 1;
    const int c0 = max(c_hi - STAGE_COLS, 0);
    const int nq = (c_hi - c0) / VEC;
    for (int n = t; n < (w.i - r0) * nq; n += 32) {
      const int r = n / nq, q = n % nq;
      const uint8_t* src =
          lane_bits + (size_t)(r0 + r) * plane + c0 + VEC * q;
      uint8_t* dst = stage + r * STAGE_COLS + VEC * q;
      if constexpr (VEC == 16)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else
        *dst = *src;
    }
    __syncwarp();
    walk_block(w, stage, STAGE_COLS, r0, c0);
    __syncwarp();                          // the warp is done with stage
  }
}

__device__ __forceinline__ void walk_store(const Walk& w, int32_t* o) {
  o[0] = w.i;
  o[1] = w.j;
  o[2] = w.t;
  o[3] = w.matches;
  o[4] = w.rd_tmin;
  o[5] = w.rd_tmax;
  o[6] = w.ad_tmin;
  o[7] = w.ad_tmax;
  o[8] = w.s_ar_rev;
  o[9] = w.s_ra_rev;
}

}  // namespace pdp
