// Native traceback + alignment statistics for the bitmap engine.
//
// The host forwards (align_host.cpp, align_simd.cpp) emit one packed
// trace byte per DP cell; this module walks those bits exactly as SeqAn's
// traceback does (reference: porechop/include/seqan/align/
// dp_traceback_impl.h, GapsLeft + AffineGaps + SingleTrace, with the
// _correctTraceValue start-cell rule of dp_algorithm_impl.h:1354-1369) and
// derives the alignment statistics of porechop/src/alignment.cpp:26-121
// without materializing gapped strings.
//
// Bit layout per cell (the same as ops/kernels.py's B_* flags):
//   bit0 H_EXT  (h_ext >= h_open; else H_OPEN)
//   bit1 V_EXT  (v_ext >= v_open; else V_OPEN)
//   bit2 DIAG   (diag >= max(V, H))
//   bit3 MAX_V  (V >= H; else MAX_H)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC traceback.cpp -o traceback.so

#include <cstdint>
#include <cstdlib>
#include <algorithm>

namespace {

constexpr int8_t GAP = -1;  // move codes
constexpr int8_t DIAG_MV = 0, HORI_MV = 1, VERT_MV = 2;

inline bool h_ext(uint8_t b) { return b & 1; }
inline bool v_ext(uint8_t b) { return b & 2; }
inline bool diag(uint8_t b) { return b & 4; }
inline bool max_v(uint8_t b) { return b & 8; }

}  // namespace

extern "C" {

// Generalized walker with explicit bit-plane strides, so callers can use
// either a lane-major (A, B, L1) layout (stride_i = B*L1, stride_b = L1,
// stride_j = 1) or the SIMD engine's interleaved (A, L1, B) layout
// (stride_i = L1*B, stride_b = 1, stride_j = B).
//
// bits:      trace bytes; DP row i lives at plane i-1.
// reads:     (B, L) int8 Dna5 codes (0..4)
// adapters:  (B, A) int8
// cell_i/j:  (B,) int32 traceback start cell (the scout's max cell)
// vflag/hflag: (B,) uint8 — V==M / H==M at the max cell (_correctTraceValue)
// read_lens/adapter_lens: (B,) int32
// out:       (B, 8) int64  — read_start, read_end, adapter_start,
//            adapter_end, matches, aligned_len, full_len, path_cols
void traceback_stats_ex(const uint8_t* bits, int64_t stride_i,
                        int64_t stride_b, int64_t stride_j,
                        const int8_t* reads, const int8_t* adapters,
                        const int32_t* cell_i, const int32_t* cell_j,
                        const uint8_t* vflag, const uint8_t* hflag,
                        const int32_t* read_lens,
                        const int32_t* adapter_lens, int64_t B, int64_t L,
                        int64_t A, int64_t* out) {
  int8_t* moves = static_cast<int8_t*>(std::malloc((L + A + 2)));
  for (int64_t b = 0; b < B; ++b) {
    const int64_t lr = read_lens[b], la = adapter_lens[b];
    int64_t i = cell_i[b], j = cell_j[b];
    const int64_t bi = i, bj = j;
    int64_t n_moves = 0;

    auto bit_at = [&](int64_t ii, int64_t jj) -> uint8_t {
      return bits[(ii - 1) * stride_i + b * stride_b + jj * stride_j];
    };

    // Mode flags: 0 = interior dispatch, 1 = forced vertical, 2 = forced
    // horizontal (start-cell gap preference).
    int forced = 0;
    if (i > 0 && j > 0) {
      if (vflag[b]) forced = 1;
      else if (hflag[b]) forced = 2;
    }
    while (i > 0 && j > 0) {
      const uint8_t tv = bit_at(i, j);
      bool go_diag, go_vert;
      if (forced == 1) { go_diag = false; go_vert = true; }
      else if (forced == 2) { go_diag = false; go_vert = false; }
      else { go_diag = diag(tv); go_vert = !go_diag && max_v(tv); }
      forced = 0;
      if (go_diag) {
        moves[n_moves++] = DIAG_MV;
        --i; --j;
      } else if (go_vert) {
        if (v_ext(tv)) {
          // Vertical run: consume while current cell reads V_EXT, then one
          // final opening step (dp_traceback_impl.h:225-265).
          while (i != 1 && v_ext(bit_at(i, j))) { moves[n_moves++] = VERT_MV; --i; }
          moves[n_moves++] = VERT_MV; --i;
        } else {
          moves[n_moves++] = VERT_MV; --i;
        }
      } else {
        if (h_ext(tv)) {
          while (j != 1 && h_ext(bit_at(i, j))) { moves[n_moves++] = HORI_MV; --j; }
          moves[n_moves++] = HORI_MV; --j;
        } else {
          moves[n_moves++] = HORI_MV; --j;
        }
      }
    }
    const int64_t i0 = i, j0 = j;

    // Replay forward: [head][path][read tail][adapter tail]
    // (dp_traceback_impl.h:528-551), computing the column statistics of
    // alignment.cpp:26-121 arithmetically.
    const int8_t* rd = reads + b * L;
    const int8_t* ad = adapters + b * A;
    const int64_t BIGV = int64_t(1) << 60;
    int64_t cols = 0, matches = 0;
    int64_t frc = BIGV, fac = BIGV, lrc = -1, lac = -1;
    int64_t s_ra = 0, s_ar = 0;  // read bases before last adapter col & vice versa

    // Head: leading free gaps (only one of i0/j0 nonzero).
    for (int64_t k = 0; k < i0; ++k) { fac = std::min(fac, cols); lac = cols; ++cols; }
    if (i0 > 0) s_ra = 0;
    for (int64_t k = 0; k < j0; ++k) { frc = std::min(frc, cols); lrc = cols; ++cols; }
    if (j0 > 0) s_ar = 0;

    int64_t ri = j0, ai = i0;
    for (int64_t m = n_moves - 1; m >= 0; --m) {
      const int8_t mv = moves[m];
      if (mv == DIAG_MV) {
        if (rd[ri] == ad[ai]) ++matches;  // Dna5: N==N is a match
        frc = std::min(frc, cols); fac = std::min(fac, cols);
        lrc = cols; lac = cols; s_ra = ri; s_ar = ai;
        ++ri; ++ai; ++cols;
      } else if (mv == HORI_MV) {
        frc = std::min(frc, cols); lrc = cols; s_ar = ai;
        ++ri; ++cols;
      } else {
        fac = std::min(fac, cols); lac = cols; s_ra = ri;
        ++ai; ++cols;
      }
    }
    // Tails: read tail first, then adapter tail.
    if (bj < lr) {
      frc = std::min(frc, cols);
      lrc = cols + (lr - bj) - 1;
      s_ar = bi;
      cols += lr - bj;
    }
    if (bi < la) {
      fac = std::min(fac, cols);
      lac = cols + (la - bi) - 1;
      s_ra = lr;
      cols += la - bi;
    }

    int64_t* o = out + b * 8;
    if (frc >= BIGV || fac >= BIGV) {
      o[0] = -1; o[1] = -1; o[2] = -1; o[3] = -1;
      o[4] = 0; o[5] = 0; o[6] = 0; o[7] = cols;
      continue;
    }
    const int64_t aln_start = std::max(frc, fac);
    const int64_t aln_end = std::min(lrc, lac);
    // Recount matches restricted to [aln_start, aln_end]: every diagonal
    // column lies inside the aligned region by construction (both sequences
    // have started and not ended there), so the running count is already
    // exact; a zero-length region zeroes it.
    int64_t aligned_len = aln_end - aln_start + 1;
    int64_t mm = matches;
    if (aligned_len <= 0) { mm = 0; aligned_len = std::max<int64_t>(aligned_len, 0); }
    o[0] = (fac >= frc) ? fac : 0;                       // read_start
    o[1] = (lrc <= lac) ? (lr - 1) : s_ra;               // read_end (incl.)
    o[2] = (frc >= fac) ? frc : 0;                       // adapter_start
    o[3] = (lac <= lrc) ? (la - 1) : s_ar;               // adapter_end
    o[4] = mm;
    o[5] = aligned_len;
    o[6] = lac - fac + 1;                                // full_len
    o[7] = cols;
  }
  std::free(moves);
}

// Back-compat entry: lane-major (A, B, L1) layout.
void traceback_stats(const uint8_t* bits, const int8_t* reads,
                     const int8_t* adapters, const int32_t* cell_i,
                     const int32_t* cell_j, const uint8_t* vflag,
                     const uint8_t* hflag, const int32_t* read_lens,
                     const int32_t* adapter_lens, int64_t B, int64_t L,
                     int64_t A, int64_t* out) {
  const int64_t L1 = L + 1;
  traceback_stats_ex(bits, B * L1, L1, 1, reads, adapters, cell_i, cell_j,
                     vflag, hflag, read_lens, adapter_lens, B, L, A, out);
}

}  // extern "C"
