// Native host aligner: the CPU fallback engine.
//
// Same algorithm as the device path (score-only affine-gap semi-global DP
// emitting packed trace bits, then the SeqAn-identical walk implemented in
// traceback.cpp), in scalar C++ with a thread pool over jobs.  It is the
// port's host engine for the Gotoh schemes the CUDA kernels refuse
// (gap_open > gap_extend; ops/dispatch.py routes by scheme); semantics are
// held against the executable spec in tests/test_torch_native.py.
//
// Valid for the Gotoh dispatch (gap_open != gap_extend — SeqAn picks the
// affine profile for any such pair, porechop/include/seqan/align/
// global_alignment_unbanded.h:213-220); the linear profile stays in the
// Python executable spec.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread align_host.cpp
//        traceback.cpp -o <out>.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" void traceback_stats(const uint8_t*, const int8_t*, const int8_t*,
                                const int32_t*, const int32_t*,
                                const uint8_t*, const uint8_t*,
                                const int32_t*, const int32_t*, int64_t,
                                int64_t, int64_t, int64_t*);

namespace {

constexpr int32_t NEG = -(1 << 30);
constexpr uint8_t B_HEXT = 1, B_VEXT = 2, B_DIAG = 4, B_MAXV = 8;

struct Scratch {
  std::vector<int32_t> m, v, h;
  std::vector<uint8_t> bits;
};

// One job: forward DP + scout election, then the shared walker.
void align_one(const int8_t* read, int64_t lr, const int8_t* adapter,
               int64_t la, int match, int mismatch, int open_, int ext,
               Scratch& s, int64_t* out9) {
  const int64_t L1 = lr + 1;
  s.m.assign(L1, 0);
  s.v.assign(L1, NEG);
  s.h.assign(L1, NEG);
  if (static_cast<int64_t>(s.bits.size()) < la * L1) s.bits.resize(la * L1);

  int32_t* m = s.m.data();
  int32_t* v = s.v.data();
  int32_t* h = s.h.data();

  // Final-column scout candidate tracking (first strict max over rows,
  // row 0 candidate M(0, lr) = 0).
  int32_t col_best = 0, col_i = 0;
  uint8_t col_vf = 0, col_hf = 0;

  for (int64_t i = 1; i <= la; ++i) {
    uint8_t* brow = s.bits.data() + (i - 1) * L1;
    const int8_t ac = adapter[i - 1];
    int32_t diag_prev = m[0];          // M(i-1, j-1)
    m[0] = 0;                          // boundary M(i, 0)
    int32_t h_prev = NEG;              // H(i, 0)
    brow[0] = 0;
    for (int64_t j = 1; j <= lr; ++j) {
      const int32_t sub = (read[j - 1] == ac) ? match : mismatch;
      const int32_t v_ext = v[j] + ext;
      const int32_t v_open = m[j] + open_;   // m[j] still holds M(i-1, j)
      const bool vbit = v_ext >= v_open;
      const int32_t nv = vbit ? v_ext : v_open;
      const int32_t h_ext = h_prev + ext;
      const int32_t h_open = m[j - 1] + open_;  // M(i, j-1), already updated
      const bool hbit = h_ext >= h_open;
      const int32_t nh = hbit ? h_ext : h_open;
      const int32_t d = diag_prev + sub;
      const bool mvbit = nv >= nh;
      const int32_t gap = mvbit ? nv : nh;
      const bool dbit = d >= gap;
      const int32_t nm = dbit ? d : gap;
      brow[j] = static_cast<uint8_t>((hbit ? B_HEXT : 0) |
                                     (vbit ? B_VEXT : 0) |
                                     (dbit ? B_DIAG : 0) |
                                     (mvbit ? B_MAXV : 0));
      diag_prev = m[j];
      m[j] = nm;
      v[j] = nv;
      h_prev = nh;
      h[j] = nh;
    }
    // Final-column candidate at (i, lr): first strict max in row order.
    if (m[lr] > col_best) {
      col_best = m[lr];
      col_i = static_cast<int32_t>(i);
      col_vf = (v[lr] == m[lr]);
      col_hf = (!col_vf && h[lr] == m[lr]);
    }
  }

  // Last-row scout: first max over j in [0, lr).
  int32_t row_best = m[0];
  int64_t j_star = 0;
  for (int64_t j = 1; j < lr; ++j)
    if (m[j] > row_best) { row_best = m[j]; j_star = j; }
  const uint8_t row_vf = (v[j_star] == row_best);
  const uint8_t row_hf = (!row_vf && h[j_star] == row_best);

  int32_t best, ci, cj;
  uint8_t vf, hf;
  if (col_best > row_best) {
    best = col_best; ci = col_i; cj = static_cast<int32_t>(lr);
    vf = col_vf; hf = col_hf;
  } else {
    best = row_best; ci = static_cast<int32_t>(la);
    cj = static_cast<int32_t>(j_star); vf = row_vf; hf = row_hf;
  }

  const int32_t rl32 = static_cast<int32_t>(lr);
  const int32_t al32 = static_cast<int32_t>(la);
  int64_t stats[8];
  traceback_stats(s.bits.data(), read, adapter, &ci, &cj, &vf, &hf, &rl32,
                  &al32, 1, lr, la, stats);
  out9[0] = stats[0];  // read_start
  out9[1] = stats[1];  // read_end (inclusive)
  out9[2] = stats[2];  // adapter_start
  out9[3] = stats[3];  // adapter_end
  out9[4] = best;      // raw score
  out9[5] = stats[4];  // matches
  out9[6] = stats[5];  // aligned_len
  out9[7] = stats[6];  // full_len
  out9[8] = 0;
}

}  // namespace

extern "C" {

// Batch interface over concatenated code buffers.
//   reads/adapters: int8 Dna5 codes, concatenated; *_off are (N+1) offsets.
//   pair_read/pair_adapter: (P,) indices into the two tables.
//   out: (P, 9) int64, layout documented in align_one.
void align_host_batch(const int8_t* reads, const int64_t* read_off,
                      const int8_t* adapters, const int64_t* adapter_off,
                      const int64_t* pair_read, const int64_t* pair_adapter,
                      int64_t P, int match, int mismatch, int open_, int ext,
                      int64_t n_threads, int64_t* out) {
  n_threads = std::max<int64_t>(1, n_threads);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    Scratch s;
    for (;;) {
      const int64_t k = next.fetch_add(1);
      if (k >= P) break;
      const int64_t ri = pair_read[k], ai = pair_adapter[k];
      const int64_t lr = read_off[ri + 1] - read_off[ri];
      const int64_t la = adapter_off[ai + 1] - adapter_off[ai];
      int64_t* o = out + k * 9;
      if (lr == 0 || la == 0) {
        o[0] = -1; o[1] = -1; o[2] = -1; o[3] = -1;
        o[4] = INT32_MIN; o[5] = 0; o[6] = 0; o[7] = 0; o[8] = 0;
        continue;
      }
      align_one(reads + read_off[ri], lr, adapters + adapter_off[ai], la,
                match, mismatch, open_, ext, s, o);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"
