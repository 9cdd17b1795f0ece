// Stat-carrying semi-global DP (see dp_common.cuh for the design).
// Replaces porechop_tpu/ops/kernel_pallas.py _stats_kernel (lane-major,
// phase 3 survivors) and _stats_kernel_t (transposed, phase 1 group max):
// one kernel serves both call sites.  Each state carries the payload
// mat * 2^15 + (g + 2^14) of the SeqAn-traceback path reaching it, selected
// under the walker's tie rules.  Outputs: best, cell_i, cell_j and the
// payload of the elected start state (V == M -> V, else H == M -> H, else
// M), all (B,) int32.
#include "dp_common.cuh"

extern "C" int pdp_forward_stats(const void* reads, const void* read_lens,
                                 const void* adapters,
                                 const void* adapter_lens, int B, int L,
                                 int A, int match, int mismatch,
                                 int gap_open, int gap_ext, void* best,
                                 void* cell_i, void* cell_j, void* pay,
                                 void* stream) {
  pdp::Args p = pdp::make_args(reads, read_lens, adapters, adapter_lens, B,
                               L, A, 0, match, mismatch, gap_open, gap_ext);
  p.best = static_cast<int32_t*>(best);
  p.cell_i = static_cast<int32_t*>(cell_i);
  p.cell_j = static_cast<int32_t*>(cell_j);
  p.pay = static_cast<int32_t*>(pay);
  return pdp::launch<pdp::STATS>(p, static_cast<cudaStream_t>(stream));
}
