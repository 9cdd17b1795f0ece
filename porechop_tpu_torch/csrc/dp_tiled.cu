// Column-tiled trace-bit forward semi-global DP for windows of any length:
// dp_wave_kernel<BITS, AMAX>, the port's one trace-bit forward (design notes
// in dp_common.cuh).  Replaces porechop_tpu/ops/kernel_pallas.py
// _tiled_kernel (:376), launched by forward_pallas_tiled_impl (:590), which
// the middle phase runs on windows longer than 16,383 bp, and
// _forward_kernel (:115), which serves the shorter ones (phase 2 end
// windows, the middle phase's coordinate pass and replay rounds).  Writes
// trace bytes into bits (A, B, L1p) uint8 -- H_EXT 1, V_EXT 2, DIAG 4,
// MAX_V 8, EQ 16 -- for rows < adapter_len and columns <= read_len (the
// rest of each written tile holds leftovers), and best, cell_i, cell_j (B,)
// int32, vflag, hflag (B,) uint8.  L1p is a multiple of TILE_T.
//
// The TPU kernel walks 2,048-column tiles through a sequential grid,
// carrying each row's tile-edge state (cm/ch/cb) in VMEM; here that state
// never leaves the owning thread's registers, and only the read codes and
// the trace bytes of a 256-column tile go through shared memory.
//
// Column chunks.  One warp carries one lane, and a lane takes read_len +
// 31 x tiles dependent steps however wide the card: a launch of a few long
// lanes (a replay round of 128 lanes at rung 262,144) leaves most of the
// card idle.  So a launch may cut every lane into chunks of chunk_cols
// columns (a multiple of TILE_T), one warp each (block k * B + b for chunk
// k of lane b).  Chunk k owns columns [k C, min((k + 1) C, read_len + 1))
// and writes their trace bytes, which no other chunk writes.  It first
// sweeps warm_cols columns before them from a lower bound (rows >= 1 at
// M = V = H = NEG, row 0 at its true M = 0), writing nothing.
//
// Why the warm-up gives exact values.  Every value is the best score of
// paths from the DP's boundary.  Those of cell (i, j) that start inside the
// warm-up window, at row 0 of a column >= w0 = k C - D, the cold sweep
// computes exactly; the lower bound at column w0 - 1 only adds paths of
// score <= the true ones.  A path from outside the window crosses column
// w0 - 1 at some row with at most A diagonal moves in all, so it spends at
// least (j - w0 + 1) - A moves in horizontal gap, each <= gap_ext < 0, and
// the score it brings in is at most A s_hi (s_hi = max(match, mismatch,
// 0)): for j >= w0 + D - 1 it scores at most A s_hi - (D - A) |gap_ext|.
// The all-diagonal path from row 0 at column j - i (inside the window)
// scores at least A s_lo (s_lo = min(match, mismatch, 0)), and the same
// argument with one gap move fewer covers paths ending in V or H.  So
// with D = A + 2 + ceil(A (s_hi - s_lo) / |gap_ext|), M, V and H are exact
// from column k C - 1 on: the one column before k C feeds the diagonal and
// the H_EXT bit of column k C.  ops/kernels.py split_plan passes D rounded
// up to TILE_T; tests/test_torch_split.py checks D by brute force, and
// tests/test_torch_csrc_host.py shows a 16-column warm-up going wrong.
//
// The election across chunks: each chunk writes its partial scouts (the
// last-row leftmost maximum over its own columns in [0, read_len), and in
// the chunk holding column read_len the final-column scout) to part, and a
// second small launch, bits_fold_kernel, folds them per lane in chunk order
// (largest score, then the smallest chunk) and elects as an unsplit lane
// does.  Two launches in one call keep the fold deterministic and need no
// atomics; an unsplit launch (nch = 1) elects in the kernel itself.
//
// The walk (pdp_forward_walk).  Where the lane's cell is elected, its warp
// walks it with the body of dp_walk.cuh, in the same launch: the trace-bit
// kernel's epilogue for an unsplit lane (from shared memory alone for a
// one-tile lane, whose trace bytes are then never written: bits may be
// null), bits_fold_kernel, one warp per lane, for a split one.  A call
// returns the walk's aggregates in one or two launches, as the trace bits
// alone took, and bits only the walk read need not outlive it.
// pdp_forward_tiled is the same call without the walk: bits written.
//
// What bounds it on an H100: the instruction rate once a launch holds
// enough warps, a step being two shuffles, the boundary selects and R cells
// of integer operations (2,048 lanes at rung 16,384, ~16 warps per SM:
// 3.13 ms against a 0.96 ms bound of int32 operations).  Split, a few-lane
// launch reaches the same rate and pays its warm-up, at most 1 / 8 of a
// chunk, on top: 128 lanes at rung 262,144 take 3.14 ms against a 0.95 ms
// bound, where one warp per lane took 32.1 ms (time_kernels.py, parent and
// split in one call, H100 SXM at 700 W).  The barcoded middle's 512 lanes
// x 10,240 x adapter rung 96 run on AMAX 96 (24.8 KB a warp: 1,188 warps),
// split into two chunks after a 768-column warm-up: 2.10 ms with the walk
// against a 0.45 ms bound.  On AMAX 128 (792 warps, too few for the plan
// to split 512 lanes) they take 3.91 ms (both in one call).
#include "dp_common.cuh"

namespace {

constexpr int FOLD_WARPS = 4;

// One warp per lane: the fold of its chunks' scouts and the election (by
// every thread, on the same values), then, with p.walk, its walk.
__global__ void __launch_bounds__(32 * FOLD_WARPS)
bits_fold_kernel(pdp::BitsArgs p) {
  extern __shared__ __align__(16) uint8_t stage[];  // STAGE_BYTES a warp
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * FOLD_WARPS + w;
  if (b >= p.B) return;                // the whole warp
  const int rlen = pdp::lane_len(p.read_lens, b, p.L);
  const int alen = pdp::lane_len(p.adapter_lens, b, p.A);
  const int last = rlen / p.chunk_cols;      // the chunk holding read_len
  const size_t stride = (size_t)p.B * pdp::PART_INTS;
  const int32_t* q = p.part + (size_t)b * pdp::PART_INTS;
  int rsc = q[0], rj = q[1], rflags = q[2];
  for (int k = 1; k <= last; ++k) {
    const int32_t* qk = q + k * stride;
    if (qk[0] > rsc) {
      rsc = qk[0];
      rj = qk[1];
      rflags = qk[2];
    }
  }
  const int32_t* ql = q + last * stride;
  const pdp::Elected e =
      pdp::elect_cell(alen, rlen, ql[3], ql[4], rsc, rj, rflags);
  const bool lead = (threadIdx.x & 31) == 0;
  if (lead) pdp::write_cell(p, b, e);
  if (p.walk == nullptr) return;
  pdp::Walk wk = pdp::walk_start(e.i, e.j, e.vf, e.hf);
  pdp::walk_staged<16>(wk, p.bits + (size_t)b * p.L1p, (size_t)p.B * p.L1p,
                       stage + w * pdp::STAGE_BYTES);
  if (lead) pdp::walk_store(wk, p.walk + (size_t)b * pdp::WALK_OUTS);
}

// The trace-bit call of pdp_forward_tiled and pdp_forward_walk: the
// kernel, then, for a split launch, the fold; walk null for no walk.
int forward_bits(const void* reads, const void* read_lens,
                 const void* adapters, const void* adapter_lens, int B,
                 int L, int A, int L1p, int match, int mismatch, int gap_open,
                 int gap_ext, int chunk_cols, int warm_cols, void* bits,
                 void* best, void* cell_i, void* cell_j, void* vflag,
                 void* hflag, void* part, void* walk, void* stream) {
  if (B <= 0) return 0;
  if (L1p % pdp::TILE_T != 0 || L1p < L + 1) return pdp::ERR_BAD_L1P;
  if (chunk_cols <= 0 || chunk_cols % pdp::TILE_T != 0 || warm_cols < 0)
    return pdp::ERR_BAD_SPLIT;
  pdp::BitsArgs p{pdp::make_args(reads, read_lens, adapters, adapter_lens,
                                 B, L, A, L1p, match, mismatch, gap_open,
                                 gap_ext),
                  L / chunk_cols + 1,        // chunks holding columns 0..L
                  chunk_cols, warm_cols, static_cast<int32_t*>(part),
                  static_cast<int32_t*>(walk)};
  if (p.nch > 1 && part == nullptr) return pdp::ERR_BAD_SPLIT;
  // Only a one-tile launch that walks keeps its trace bytes on the SM.
  if (bits == nullptr && (walk == nullptr || L1p != pdp::TILE_T))
    return pdp::ERR_NULL_OUTPUT;
  p.bits = static_cast<uint8_t*>(bits);
  p.best = static_cast<int32_t*>(best);
  p.cell_i = static_cast<int32_t*>(cell_i);
  p.cell_j = static_cast<int32_t*>(cell_j);
  p.vflag = static_cast<uint8_t*>(vflag);
  p.hflag = static_cast<uint8_t*>(hflag);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = pdp::launch<pdp::BITS>(p, 1, s);
  if (rc != 0 || p.nch == 1) return rc;
  const int smem = walk == nullptr ? 0 : FOLD_WARPS * pdp::STAGE_BYTES;
  bits_fold_kernel<<<(B + FOLD_WARPS - 1) / FOLD_WARPS, 32 * FOLD_WARPS,
                     smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The warps of the trace-bit kernel for adapter width A that the current
// device holds at once (ops/kernels.py card_warps, split_plan's target).
extern "C" int pdp_tiled_warps(int A, int* warps) {
  return pdp::card_warps<pdp::BITS>(A, warps);
}

// chunk_cols: columns per chunk, a multiple of TILE_T (>= L + 1: one chunk);
// warm_cols: warm-up columns of every chunk but the first; part: (ceil((L +
// 1) / chunk_cols), B, PART_INTS) int32 scratch when there are two chunks
// or more, else unused.
extern "C" int pdp_forward_tiled(const void* reads, const void* read_lens,
                                 const void* adapters,
                                 const void* adapter_lens, int B, int L,
                                 int A, int L1p, int match, int mismatch,
                                 int gap_open, int gap_ext, int chunk_cols,
                                 int warm_cols, void* bits, void* best,
                                 void* cell_i, void* cell_j, void* vflag,
                                 void* hflag, void* part, void* stream) {
  return forward_bits(reads, read_lens, adapters, adapter_lens, B, L, A, L1p,
                      match, mismatch, gap_open, gap_ext, chunk_cols,
                      warm_cols, bits, best, cell_i, cell_j, vflag, hflag,
                      part, nullptr, stream);
}

// pdp_forward_tiled and each lane's walk from its elected cell into walk
// (B, WALK_OUTS) int32, in the same launches.  bits may be null when L1p
// is TILE_T (a one-tile launch): its trace bytes stay in shared memory.
extern "C" int pdp_forward_walk(const void* reads, const void* read_lens,
                                const void* adapters,
                                const void* adapter_lens, int B, int L,
                                int A, int L1p, int match, int mismatch,
                                int gap_open, int gap_ext, int chunk_cols,
                                int warm_cols, void* bits, void* best,
                                void* cell_i, void* cell_j, void* vflag,
                                void* hflag, void* part, void* walk,
                                void* stream) {
  if (B > 0 && walk == nullptr) return pdp::ERR_NULL_OUTPUT;
  return forward_bits(reads, read_lens, adapters, adapter_lens, B, L, A, L1p,
                      match, mismatch, gap_open, gap_ext, chunk_cols,
                      warm_cols, bits, best, cell_i, cell_j, vflag, hflag,
                      part, walk, stream);
}
