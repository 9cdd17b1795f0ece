// Best-score-only semi-global DP (see dp_common.cuh for the design).
// Replaces porechop_tpu/ops/kernel_pallas.py _score_kernel (lane-major,
// phase 3 round 0) and _score_kernel_t (transposed, phase 1 prefilter):
// one kernel serves both call sites.  Output: best (B,) int32, the max of
// M over the last column (rows <= adapter_len) and the last row.
#include "dp_common.cuh"

extern "C" int pdp_forward_score(const void* reads, const void* read_lens,
                                 const void* adapters,
                                 const void* adapter_lens, int B, int L,
                                 int A, int match, int mismatch,
                                 int gap_open, int gap_ext, void* best,
                                 void* stream) {
  pdp::Args p = pdp::make_args(reads, read_lens, adapters, adapter_lens, B,
                               L, A, 0, match, mismatch, gap_open, gap_ext);
  p.best = static_cast<int32_t*>(best);
  return pdp::launch<pdp::SCORE>(p, static_cast<cudaStream_t>(stream));
}
