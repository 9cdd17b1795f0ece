// Column-tiled trace-bit forward semi-global DP for windows of any length:
// the port's one trace-bit forward.  Replaces porechop_tpu/ops/
// kernel_pallas.py _tiled_kernel (:376), launched by
// forward_pallas_tiled_impl (:590), which the middle phase runs on windows
// longer than 16,383 bp, and _forward_kernel (:115), which serves the
// shorter ones (phase 2 end windows, the middle phase's coordinate pass and
// replay rounds).  Writes trace bytes into bits (A, B, L1p) uint8 -- H_EXT
// 1, V_EXT 2, DIAG 4, MAX_V 8, EQ 16 -- for rows < adapter_len and columns
// <= read_len (the rest of each written tile holds leftovers), and best,
// cell_i, cell_j (B,) int32, vflag, hflag (B,) uint8.  L1p is a multiple
// of TILE_T.  Recurrences and tie rules: dp_cell in dp_common.cuh.
//
// Design.  The TPU kernel keeps lanes in vector lanes and walks 2,048-column
// tiles through a sequential grid, carrying each row's tile-edge state in
// VMEM.  Here the parallel work inside one lane is across adapter rows, on
// the anti-diagonal: one warp per lane, thread t owning the R = AMAX / 32
// consecutive rows [R t, R t + R).  At step s of a tile thread t computes
// column j = jlo + s - t for its rows, top to bottom; the row above its
// first row (M and V at column j, M at column j - 1, received one step
// earlier) comes from thread t - 1 by __shfl_up_sync, and thread 0 uses
// row 0's boundary (M = 0, V = NEG).  H, the H_EXT bit and the last M of
// each row stay in the owning thread's registers, so the state at a tile
// edge never leaves registers: that is K2's cm/ch/cb carry without a trip
// through memory.  A tile of TILE_T columns fills and drains the wavefront
// in TILE_T + 31 steps.  Its read codes are staged in shared memory with
// coalesced loads and its trace bytes buffered there (adapter rows x TILE_T
// bytes), then written out a row at a time with 16-byte stores.  A lane
// stops at its own read length, so the work is what each lane's data needs.
//
// Scouts, with the rules of dp_lane_kernel: the thread holding row
// adapter_len keeps the last-row leftmost maximum over columns
// [0, read_len) with a strict > in increasing j; the final-column scout
// (first strict maximum down column read_len from M(0, read_len) = 0) is a
// per-thread scan of its rows then a warp reduction (the largest M, then
// the smallest row holding it); then the same column-against-row election.
//
// What bounds it on an H100: the instruction rate when a launch holds
// many lanes (2,048 lanes at rung 16,384 put ~16 warps on each SM: 3.2 ms
// against a 0.95 ms bound of int32 operations, chip_smoke.py on an H100
// SXM at 700 W), and the dependent chain of one step (two shuffles, then R
// cells of dependent integer operations) when it holds few: a lane takes
// read_len + 31 x tiles steps however wide the card, ~220 cycles each for
// a lone warp (a replay round of 128 lanes at rung 262,144: 32.6 ms).  The
// design accepts the latter: one thread per lane (the design of
// dp_common.cuh's dp_lane_kernel) pays the whole column, AMAX cells, per
// step, and was slower at every shape of the trimming path.
#include "dp_common.cuh"

namespace pdp {

constexpr int TILE_T = 256;            // ops/kernels.py TILE_T
constexpr unsigned FULL_MASK = 0xffffffffu;

// Trace byte of cell (i, j): H_EXT 1 (hbit, from next_hbit at column j-1),
// V_EXT 2, DIAG 4, MAX_V 8, EQ 16.
__device__ __forceinline__ uint32_t trace_byte(const Cell& c, int h,
                                               bool hbit, bool eq) {
  const int vh = c.v >= h ? c.v : h;
  return (hbit ? 1u : 0u) | (c.vbit ? 2u : 0u) | (c.d >= vh ? 4u : 0u)
       | (c.v >= h ? 8u : 0u) | (eq ? 16u : 0u);
}

// H_EXT bit of cell (i, j+1): H(i, j) + ext >= M(i, j) + open.
__device__ __forceinline__ bool next_hbit(const Cell& c, int h, int go,
                                          int ge) {
  return h + ge >= c.m + go;
}

// Column 0: M = 0, V = H = NEG; no H_EXT, no EQ; DIAG and MAX_V from
// NEG >= NEG.
__device__ __forceinline__ uint8_t col0_byte(int go, int ge) {
  return (uint8_t)((((NEG + ge) >= go) ? 2 : 0) | 4 | 8);
}

template <int AMAX>
__global__ void __launch_bounds__(32) dp_tiled_kernel(Args p) {
  constexpr int R = AMAX / 32;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sread = smem;               // TILE_T read codes of the tile
  uint8_t* sbits = smem + TILE_T;      // [adapter row][TILE_T] trace bytes

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int rlen = min(max(p.read_lens[b], 0), p.L);
  const int alen = min(max(p.adapter_lens[b], 0), p.A);
  const int ma = p.match, mm = p.mismatch, go = p.gap_open, ge = p.gap_ext;
  const int8_t* read = p.reads + (size_t)b * p.L;
  const int8_t* adp = p.adapters + (size_t)b * p.A;
  const size_t plane = (size_t)p.B * p.L1p;
  uint8_t* lane_bits = p.bits + (size_t)b * p.L1p;

  const int row0 = R * t;              // this thread's first row slot
  const int nt = (alen + R - 1) / R;   // threads that own rows < alen
  const int last_row = alen - 1;       // slot of row adapter_len
  int acode[R], M[R], Hn[R];
  uint32_t hb = 0;                     // bit r: H_EXT bit of the next column
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acode[r] = row0 + r < alen ? adp[row0 + r] : -1;
    M[r] = 0;
    Hn[r] = h_col1(go, ge);
    if ((NEG + ge) >= go) hb |= 1u << r;
  }

  int m_out = 0, v_out = NEG;  // M, V of this thread's last row, last column
  int m_prev = 0;              // M(row0 - 1, j - 1), received a step earlier
  int tsc = 0, ti = 0;
  bool tvf = false, thf = false;
  int rsc = rlen > 0 ? 0 : -(1 << 30) - (1 << 29), rj = 0;
  bool rvf = false, rhf = false;

  const int ntiles = (rlen + TILE_T) / TILE_T;   // columns 0..rlen
  for (int tile = 0; tile < ntiles; ++tile) {
    const int jlo = tile * TILE_T;
    const int jhi = min(jlo + TILE_T, rlen + 1);
    for (int c = t; c < jhi - jlo; c += 32) {    // column j holds read[j-1]
      const int j = jlo + c;
      sread[c] = j > 0 ? (uint8_t)read[j - 1] : (uint8_t)4;
    }
    if (tile == 0) {
      const uint8_t b0 = col0_byte(go, ge);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (row0 + r < alen) sbits[(row0 + r) * TILE_T] = b0;
    }
    __syncwarp();

    const int jstart = max(jlo, 1);
    const int nsteps = jhi - jlo + (nt > 0 ? nt - 1 : 0);
    for (int s = 0; s < nsteps; ++s) {
      const int m_in = __shfl_up_sync(FULL_MASK, m_out, 1);
      const int v_in = __shfl_up_sync(FULL_MASK, v_out, 1);
      const int j = jlo + s - t;
      if (t < nt && j >= jstart && j < jhi) {
        int mdiag = t == 0 ? 0 : m_prev;
        int mup = t == 0 ? 0 : m_in;
        int vup = t == 0 ? NEG : v_in;
        const int rc = sread[j - jlo];
        const bool last_col = j == rlen;
        uint8_t* col = sbits + (j - jlo);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = row0 + r;
          if (i >= alen) break;
          const bool eq = rc == acode[r];
          const int h = Hn[r];
          const Cell c = dp_cell(mdiag, mup, vup, h, eq, ma, mm, go, ge);
          col[i * TILE_T] = (uint8_t)trace_byte(c, h, (hb >> r) & 1u, eq);
          hb = next_hbit(c, h, go, ge) ? hb | (1u << r) : hb & ~(1u << r);
          mdiag = M[r];
          M[r] = c.m;
          Hn[r] = c.hnext;
          mup = c.m;
          vup = c.v;
          if (last_col) {
            if (c.m > tsc) {
              tsc = c.m;
              ti = i + 1;
              tvf = c.v == c.m;
              thf = !tvf && h == c.m;
            }
          } else if (i == last_row && c.m > rsc) {
            rsc = c.m;
            rj = j;
            rvf = c.v == c.m;
            rhf = !rvf && h == c.m;
          }
        }
        m_out = mup;
        v_out = vup;
        m_prev = m_in;
      }
    }
    __syncwarp();

    // Rows < adapter_len, columns [jlo, jhi) rounded up to 16 bytes.
    const int nq = (jhi - jlo + 15) / 16;
    for (int k = t; k < alen * nq; k += 32) {
      const int i = k / nq, q = k % nq;
      *reinterpret_cast<uint4*>(lane_bits + i * plane + jlo + 16 * q) =
          *reinterpret_cast<const uint4*>(sbits + i * TILE_T + 16 * q);
    }
    __syncwarp();
  }

  // Final-column scout across the warp: the largest M, then the smallest
  // row (ti packs the row and both flags).
  int tkey = (ti << 2) | (tvf ? 2 : 0) | (thf ? 1 : 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int osc = __shfl_xor_sync(FULL_MASK, tsc, off);
    const int okey = __shfl_xor_sync(FULL_MASK, tkey, off);
    if (osc > tsc || (osc == tsc && okey < tkey)) {
      tsc = osc;
      tkey = okey;
    }
  }
  const int owner = alen > 0 ? last_row / R : 0;
  rsc = __shfl_sync(FULL_MASK, rsc, owner);
  rj = __shfl_sync(FULL_MASK, rj, owner);
  const int rflags = __shfl_sync(FULL_MASK, (rvf ? 2 : 0) | (rhf ? 1 : 0),
                                 owner);
  if (t == 0) {
    const bool col_wins = tsc > rsc;
    p.best[b] = col_wins ? tsc : rsc;
    p.cell_i[b] = col_wins ? tkey >> 2 : alen;
    p.cell_j[b] = col_wins ? rlen : rj;
    p.vflag[b] = col_wins ? (tkey >> 1) & 1 : (rflags >> 1) & 1;
    p.hflag[b] = col_wins ? tkey & 1 : rflags & 1;
  }
}

template <int AMAX>
int launch_tiled(const Args& p, cudaStream_t stream) {
  const int smem = TILE_T + AMAX * TILE_T;
  auto kern = dp_tiled_kernel<AMAX>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<p.B, 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace pdp

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A <= 32) return pdp::launch_tiled<32>(p, s);
  if (A <= 64) return pdp::launch_tiled<64>(p, s);
  if (A <= 128) return pdp::launch_tiled<128>(p, s);
  return pdp::ERR_ADAPTER_TOO_LONG;
}
