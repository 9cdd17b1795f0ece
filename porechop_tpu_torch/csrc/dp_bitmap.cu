// Bitmap-forward semi-global DP (see dp_common.cuh for the design).
// Replaces porechop_tpu/ops/kernel_pallas.py _forward_kernel for
// L + 1 <= 16,384 (phase 2 end windows, phase 3 first-hit coordinates and
// replay rounds).  Writes one trace byte per cell into bits (A, B, L1p)
// uint8 -- H_EXT 1, V_EXT 2, DIAG 4, MAX_V 8, EQ 16 -- for rows < adapter_len
// and columns <= read_len (the region the walker reads; the rest is left
// unwritten), plus best, cell_i, cell_j (B,) int32 and vflag, hflag (B,)
// uint8 from the first-strict-max scout.
#include "dp_common.cuh"

extern "C" int pdp_forward_bitmap(const void* reads, const void* read_lens,
                                  const void* adapters,
                                  const void* adapter_lens, int B, int L,
                                  int A, int L1p, int match, int mismatch,
                                  int gap_open, int gap_ext, void* bits,
                                  void* best, void* cell_i, void* cell_j,
                                  void* vflag, void* hflag, void* stream) {
  pdp::Args p = pdp::make_args(reads, read_lens, adapters, adapter_lens, B,
                               L, A, L1p, match, mismatch, gap_open,
                               gap_ext);
  p.bits = static_cast<uint8_t*>(bits);
  p.best = static_cast<int32_t*>(best);
  p.cell_i = static_cast<int32_t*>(cell_i);
  p.cell_j = static_cast<int32_t*>(cell_j);
  p.vflag = static_cast<uint8_t*>(vflag);
  p.hflag = static_cast<uint8_t*>(hflag);
  return pdp::launch<pdp::BITMAP>(p, static_cast<cudaStream_t>(stream));
}
