// The standalone trace-bit walk: SeqAn's GapsLeft traceback over trace
// bits already in device memory, from each lane's elected cell, folded into
// ten aggregates per lane, with the walk body of dp_walk.cuh (order and
// meaning of the aggregates there).  Replaces, with the walk that
// dp_tiled.cu pdp_forward_walk runs inside the trace-bit launch, the XLA
// lax.while_loop of porechop_tpu/ops/engine_v2.py _traceback_impl (:252,
// not a Pallas kernel) and its host twin porechop_tpu/native/traceback.cpp;
// ops/kernels.py walk_plain is its plain version.  The trimming path walks
// inside its trace-bit launches; this kernel is the walk over any bits
// (kernels.walk), which the tests hold against the JAX walker.
//
// Inputs: bits (A, B, L1p) uint8, the byte of cell (i, j) of lane b at
// (i - 1) B L1p + b L1p + j; cell_i, cell_j (B,) int32 with cell_i <= A
// and cell_j < L1p; vflag, hflag (B,) one byte each, non-zero for true.
// Output: (B, 10) int32.
//
// Design.  One warp per lane, four to a block, each warp with a staging
// block of its own in shared memory (dp_walk.cuh walk_staged: one round
// trip to device memory per block of 64 x 64 trace bytes, then a run of
// moves per shared-memory round trip).  16-byte staging loads need bits and L1p on
// 16-byte boundaries, as forward_tiled makes them; other bits stage a byte
// a load.  A lane makes at most i + j moves and a pad lane (cell_i or
// cell_j of 0) none, so the launch ends with no check across lanes and
// nothing for the host to wait on.  Offsets are 64-bit.
//
// What bounds it on an H100: latency.  The bytes it needs (a few blocks a
// lane, 50 bytes in and out) are far below the memory rate; its time is
// the longest lane's chain of block loads and runs.
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_walk.cuh"

namespace {

constexpr int WALK_WARPS = 4;

struct WalkArgs {
  const uint8_t* bits;       // (A, B, L1p)
  const int32_t* cell_i;     // (B,)
  const int32_t* cell_j;
  const uint8_t* vflag;
  const uint8_t* hflag;
  int32_t* out;              // (B, WALK_OUTS)
  int B;
  int L1p;
};

template <int VEC>
__global__ void __launch_bounds__(32 * WALK_WARPS)
dp_walk_kernel(WalkArgs p) {
  extern __shared__ __align__(16) uint8_t stage[];  // STAGE_BYTES a warp
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * WALK_WARPS + w;
  if (b >= p.B) return;                // the whole warp
  pdp::Walk wk = pdp::walk_start(p.cell_i[b], p.cell_j[b], p.vflag[b] != 0,
                                 p.hflag[b] != 0);
  pdp::walk_staged<VEC>(wk, p.bits + (size_t)b * p.L1p,
                        (size_t)p.B * p.L1p, stage + w * pdp::STAGE_BYTES);
  if ((threadIdx.x & 31) == 0)
    pdp::walk_store(wk, p.out + (size_t)b * pdp::WALK_OUTS);
}

}  // namespace

// Enqueues the walk of B lanes over bits (A, B, L1p) on `stream`; returns
// cudaGetLastError() after the launch (0 when B is 0).
extern "C" int pdp_walk(const void* bits, const void* cell_i,
                        const void* cell_j, const void* vflag,
                        const void* hflag, int B, int L1p, void* out,
                        void* stream) {
  if (B <= 0) return 0;
  WalkArgs p{static_cast<const uint8_t*>(bits),
             static_cast<const int32_t*>(cell_i),
             static_cast<const int32_t*>(cell_j),
             static_cast<const uint8_t*>(vflag),
             static_cast<const uint8_t*>(hflag),
             static_cast<int32_t*>(out), B, L1p};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (B + WALK_WARPS - 1) / WALK_WARPS;
  const int smem = WALK_WARPS * pdp::STAGE_BYTES;
  const auto kern =
      reinterpret_cast<uintptr_t>(bits) % 16 == 0 && L1p % 16 == 0
          ? dp_walk_kernel<16>
          : dp_walk_kernel<1>;
  kern<<<grid, 32 * WALK_WARPS, smem, s>>>(p);
  return (int)cudaGetLastError();
}
