// Stat-carrying semi-global DP: dp_wave_kernel<STATS, AMAX> (design notes
// in dp_common.cuh).  Replaces porechop_tpu/ops/kernel_pallas.py
// _stats_kernel (lane-major, phase 3 survivors) and _stats_kernel_t
// (transposed, phase 1 group max): one kernel serves both call sites.  Each
// state carries the payload mat * 2^15 + (g + 2^14) of the SeqAn-traceback
// path reaching it, selected under the walker's tie rules.  Outputs: best,
// cell_i, cell_j and the payload of the elected start state (V == M -> V,
// else H == M -> H, else M), all (B,) int32.
//
// What bounds it on an H100: the instruction rate (four shuffles a step,
// the tie flags and payload selects of dp_cell, the scouts): 1.3 ms at the
// middle survivors' 1,024 x 10,240 x 32 against a 0.27 ms bound of int32
// operations, 0.22 ms at detection's 16,384 x 150 x 24 against 0.05 ms
// (time_kernels.py on an H100 SXM at 700 W).  Few lanes are bound by the
// dependent chain instead: the barcoded survivors' 512 x 10,240 x 96
// take 2.64 ms on the AMAX 96 instantiation (three rows a thread) against
// a 0.40 ms bound, where AMAX 128 took 3.21 ms (both in one call).
// Adapter rungs 16-24 and 48 run as four lanes of 8 threads or two of 16 a
// warp in launches of many lanes (ops/kernels.py lane_group): the
// barcoded detection's 1,048,576 x 150 x 24 takes 6.93 ms there against
// 11.42 one lane a warp, 16,384 x 150 x 48 0.248 against 0.356; few-lane
// launches keep one lane a warp, where three rows a thread double the
// chain (512 x 10,240 x 24: 2.62 against 1.22; time_kernels.py --layouts,
// one call).
#include "dp_common.cuh"

extern "C" int pdp_forward_stats(const void* reads, const void* read_lens,
                                 const void* adapters,
                                 const void* adapter_lens, int B, int L,
                                 int A, int match, int mismatch,
                                 int gap_open, int gap_ext, int group,
                                 void* best, void* cell_i, void* cell_j,
                                 void* pay, void* stream) {
  pdp::Args p = pdp::make_args(reads, read_lens, adapters, adapter_lens, B,
                               L, A, 0, match, mismatch, gap_open, gap_ext);
  p.best = static_cast<int32_t*>(best);
  p.cell_i = static_cast<int32_t*>(cell_i);
  p.cell_j = static_cast<int32_t*>(cell_j);
  p.pay = static_cast<int32_t*>(pay);
  return pdp::launch<pdp::STATS>(p, group,
                                 static_cast<cudaStream_t>(stream));
}

// The warps of the one-lane-a-warp instantiation for adapter width A that
// the current device holds at once (ops/kernels.py lane_group's threshold).
extern "C" int pdp_stats_warps(int A, int* warps) {
  return pdp::card_warps<pdp::STATS>(A, warps);
}
