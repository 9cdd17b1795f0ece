// Best-score-only semi-global DP: dp_wave_kernel<SCORE, AMAX> (design notes
// in dp_common.cuh).  Replaces porechop_tpu/ops/kernel_pallas.py
// _score_kernel (lane-major, phase 3 round 0) and _score_kernel_t
// (transposed, phase 1 prefilter): one kernel serves both call sites.
// Output: best (B,) int32, the max of M over the last column (rows <=
// adapter_len) and the last row.
//
// What bounds it on an H100: the instruction rate at the middle phase's
// real round 0 (16,384 lanes x 10,240 x 32: 6.5 ms against a 2.7 ms bound
// of int32 operations, time_kernels.py on an H100 SXM at 700 W), most of a
// step's instructions being the shuffles, range tests and boundary selects
// around R cells; the dependent chain of a step at 1,024 lanes (0.97 ms).
// The barcoded runs' round 0 (4,096 lanes x 10,240 x adapter rung 96) runs
// on the AMAX 96 instantiation, three rows a thread: 3.97 ms against a
// 2.0 ms bound, where AMAX 128, a quarter of its rows padding, took 4.74
// ms (time_kernels.py, both in one call, H100 SXM at 700 W).  Adapter
// rungs 16-24 and 48 run as four lanes of 8 threads or two of 16 a warp in
// launches of many lanes (ops/kernels.py lane_group): the detection
// prefilter at 1,048,576 x 150 x 24 takes 3.09 ms there against 6.38 one
// lane a warp on AMAX 32, the barcoded round 0 at 16,384 x 10,240 x 24
// 3.97 against 6.46, the 10 kb round 0 at 8,192 x 10,240 x 48 3.92
// against 5.36 on AMAX 64 (time_kernels.py --layouts, one call).
#include "dp_common.cuh"

extern "C" int pdp_forward_score(const void* reads, const void* read_lens,
                                 const void* adapters,
                                 const void* adapter_lens, int B, int L,
                                 int A, int match, int mismatch,
                                 int gap_open, int gap_ext, int group,
                                 void* best, void* stream) {
  pdp::Args p = pdp::make_args(reads, read_lens, adapters, adapter_lens, B,
                               L, A, 0, match, mismatch, gap_open, gap_ext);
  p.best = static_cast<int32_t*>(best);
  return pdp::launch<pdp::SCORE>(p, group,
                                 static_cast<cudaStream_t>(stream));
}

// The warps of the one-lane-a-warp instantiation for adapter width A that
// the current device holds at once (ops/kernels.py lane_group's threshold).
extern "C" int pdp_score_warps(int A, int* warps) {
  return pdp::card_warps<pdp::SCORE>(A, warps);
}
