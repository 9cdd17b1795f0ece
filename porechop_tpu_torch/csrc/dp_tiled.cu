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
// What bounds it on an H100: the instruction rate when a launch holds many
// lanes (2,048 lanes at rung 16,384 put ~16 warps on each SM: 3.2 ms
// against a 0.95 ms bound of int32 operations, chip_smoke.py on an H100
// SXM at 700 W), and the dependent chain of one step (two shuffles, then R
// cells of dependent integer operations) when it holds few: ~220 cycles a
// step for a lone warp (a replay round of 128 lanes at rung 262,144:
// 32.6 ms).
#include "dp_common.cuh"

extern "C" int pdp_forward_tiled(const void* reads, const void* read_lens,
                                 const void* adapters,
                                 const void* adapter_lens, int B, int L,
                                 int A, int L1p, int match, int mismatch,
                                 int gap_open, int gap_ext, void* bits,
                                 void* best, void* cell_i, void* cell_j,
                                 void* vflag, void* hflag, void* stream) {
  if (B <= 0) return 0;
  if (L1p % pdp::TILE_T != 0 || L1p < L + 1) return pdp::ERR_BAD_L1P;
  pdp::Args p = pdp::make_args(reads, read_lens, adapters, adapter_lens, B,
                               L, A, L1p, match, mismatch, gap_open,
                               gap_ext);
  p.bits = static_cast<uint8_t*>(bits);
  p.best = static_cast<int32_t*>(best);
  p.cell_i = static_cast<int32_t*>(cell_i);
  p.cell_j = static_cast<int32_t*>(cell_j);
  p.vflag = static_cast<uint8_t*>(vflag);
  p.hflag = static_cast<uint8_t*>(hflag);
  return pdp::launch<pdp::BITS>(p, static_cast<cudaStream_t>(stream));
}
