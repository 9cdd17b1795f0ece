// The trace-bit walk: SeqAn's GapsLeft traceback over the bytes that
// dp_tiled.cu writes, from each lane's elected cell to the DP's first row
// or column, folded into ten reverse-walk aggregates per lane.  Replaces
// the XLA lax.while_loop of porechop_tpu/ops/engine_v2.py _traceback_impl
// (:252, not a Pallas kernel) and its host twin
// porechop_tpu/native/traceback.cpp; ops/kernels.py walk_plain is its plain
// version, ops/engine_v2.py traceback_shards its caller.
//
// Inputs, as forward_tiled leaves them on the card: bits (A, B, L1p) uint8
// (H_EXT 1, V_EXT 2, DIAG 4, MAX_V 8, EQ 16), the byte of cell (i, j) of
// lane b at (i - 1) B L1p + b L1p + j; cell_i, cell_j (B,) int32 with
// cell_i <= A and cell_j < L1p; vflag, hflag (B,) one byte each, non-zero
// for true.  Output: (B, 10) int32, per lane i0, j0 (where the walk
// stopped), n_path (moves), matches (diagonal moves on equal codes),
// rd_tmin/rd_tmax and ad_tmin/ad_tmax (first/last move index that holds a
// read / adapter base, -1 when none), s_ar_rev (adapter bases before the
// last read column), s_ra_rev (read bases before the last adapter column).
//
// Design.  One thread per lane, 128 threads a block.  A lane walks until
// i == 0 or j == 0; every move lowers i or j or both, so it makes at most
// i + j moves, and the loop ends with no check across lanes and nothing
// for the host to wait on: the launch is enqueued behind the forward on
// the same stream and the caller harvests the aggregates when it needs
// them.  A lane outside the DP (a pad lane, cell_i or cell_j of 0) leaves
// at once with the plain version's outputs.  Offsets are 64-bit.
//
// What bounds it on an H100: latency.  Each move's byte load depends on
// the move before it, so a launch takes about as long as its longest
// lane's chain of one-byte global loads (tens to a few hundred moves, each
// an L2 or HBM round trip); the bytes it moves (one per move, 50 per lane
// in and out) are far below the memory rate.  Making it fast is later
// work: walking from shared memory or an L2-resident staging of the
// elected path's neighbourhood, or fusing the walk into the forward's
// epilogue.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WALK_THREADS = 128;
constexpr int WALK_OUTS = 10;
constexpr uint8_t B_HEXT = 1, B_VEXT = 2, B_DIAG = 4, B_MAXV = 8, B_EQ = 16;

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

__global__ void __launch_bounds__(WALK_THREADS) dp_walk_kernel(WalkArgs p) {
  const int b = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (b >= p.B) return;
  int i = p.cell_i[b];
  int j = p.cell_j[b];
  // mode: 0 dispatch, 1 vertical run, 2 horizontal run.
  int mode = 0;
  if (i > 0 && j > 0) mode = p.vflag[b] ? 1 : (p.hflag[b] ? 2 : 0);
  int t = 0, matches = 0, s_ar_rev = 0, s_ra_rev = 0;
  int rd_tmin = -1, rd_tmax = -1, ad_tmin = -1, ad_tmax = -1;
  const int64_t plane = (int64_t)p.B * p.L1p;
  const uint8_t* lane = p.bits + (int64_t)b * p.L1p;
  while (i > 0 && j > 0) {
    const uint8_t tv = lane[(int64_t)(i - 1) * plane + j];
    const bool dg = (tv & B_DIAG) != 0;
    const bool go_diag = mode == 0 && dg;
    const bool go_vert = mode == 1 || (mode == 0 && !dg && (tv & B_MAXV));
    const bool go_hori = !go_diag && !go_vert;
    const int next = go_vert && i != 1 && (tv & B_VEXT)   ? 1
                     : go_hori && j != 1 && (tv & B_HEXT) ? 2
                                                          : 0;
    // A move's column holds a read base unless it is vertical, an adapter
    // base unless it is horizontal.
    if (go_diag && (tv & B_EQ)) ++matches;
    if (!go_vert) {
      if (rd_tmin < 0) {
        rd_tmin = t;
        s_ar_rev = go_diag ? i - 1 : i;
      }
      rd_tmax = t;
    }
    if (!go_hori) {
      if (ad_tmin < 0) {
        ad_tmin = t;
        s_ra_rev = go_diag ? j - 1 : j;
      }
      ad_tmax = t;
    }
    i -= !go_hori;
    j -= !go_vert;
    mode = next;
    ++t;
  }
  int32_t* o = p.out + (int64_t)b * WALK_OUTS;
  o[0] = i;
  o[1] = j;
  o[2] = t;
  o[3] = matches;
  o[4] = rd_tmin;
  o[5] = rd_tmax;
  o[6] = ad_tmin;
  o[7] = ad_tmax;
  o[8] = s_ar_rev;
  o[9] = s_ra_rev;
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
  dp_walk_kernel<<<(B + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0,
                   s>>>(p);
  return (int)cudaGetLastError();
}
