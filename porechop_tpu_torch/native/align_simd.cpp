// SIMD host aligner: many jobs per core in lockstep.
//
// The scalar engine (align_host.cpp) runs one DP per thread; its inner
// recurrence is a sequential dependency chain along the read, so SIMD must
// go ACROSS jobs instead: jobs of similar length are packed into the lanes
// of a hardware vector (GCC vector extensions; AVX-512 where available) —
// the same lane-vectorization as the device kernels.  Per-lane lengths are
// handled exactly like the device kernels: rows past a lane's adapter freeze,
// and the scout reads each lane's own final column / last row.
//
// Two instantiations:
//   * int16 lanes (32 per 64-byte vector) when the scheme's score range
//     provably fits 16 bits (default Porechop scoring does: |scores| stay
//     under |open| + A*|ext| + A*max|match|,|mismatch| — a few hundred);
//   * int32 lanes (16 per vector) otherwise.
//
// Semantics: identical trace bits and scout election as
// porechop_tpu_torch/ops/kernels.py (SeqAn's tie rules); statistics come
// from the shared walker in traceback.cpp.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

extern "C" void traceback_stats_ex(const uint8_t*, int64_t, int64_t,
                                   int64_t, const int8_t*, const int8_t*,
                                   const int32_t*, const int32_t*,
                                   const uint8_t*, const uint8_t*,
                                   const int32_t*, const int32_t*, int64_t,
                                   int64_t, int64_t, int64_t*);

namespace {

#if defined(__AVX512BW__)
constexpr int VBYTES = 64;
#else
constexpr int VBYTES = 32;
#endif

template <typename E>
struct VecOf {
  typedef E type __attribute__((vector_size(VBYTES)));
  static constexpr int lanes = VBYTES / sizeof(E);
};

template <typename E>
struct Group {
  std::vector<int64_t> jobs;   // job index per lane (-1 = padding)
  int64_t lr_max, la_max;
};

template <typename E>
struct Scratch {
  typedef typename VecOf<E>::type V;
  std::vector<V> m, v, h;
  std::vector<uint8_t> bits;            // (A, L1, G) interleaved layout
  std::vector<int8_t> reads, adapters;  // (G, L) / (G, A) padded (walker)
  std::vector<int8_t> reads_il;         // (L, G) interleaved (DP loads)
};

// Column-tile width: 3 DP arrays x TILE x 64 B = 24 KB stays L1-resident.
// Without tiling the long-read DP streams its m/v/h rows (megabytes at
// L ~ 10 kb) through L2 on every adapter row, capping the engine at
// ~1.4e9 cells/s; short windows that fit L1 run ~3.5e9.
constexpr int64_t TILE = 128;

// SCORE_ONLY (the dispatcher's score-only modes, ops/dispatch.py): skip
// the trace-bit stream (1 byte/cell, the loop's only memory write) and the
// walker entirely — consumers read only the best score (out[4]); the ~1%
// of lanes that survive the score bound re-run through the full path.
template <typename E, bool SCORE_ONLY>
void run_group(const Group<E>& g, const int8_t* rbuf, const int64_t* roff,
               const int8_t* abuf, const int64_t* aoff,
               const int64_t* pair_read, const int64_t* pair_adapter,
               int match, int mismatch, int open_, int ext,
               E neg, Scratch<E>& s, int64_t* out) {
  typedef typename VecOf<E>::type V;
  constexpr int G = VecOf<E>::lanes;
  const int64_t L = g.lr_max, A = g.la_max, L1 = L + 1;

  auto vsplat = [](E x) { V r; for (int l = 0; l < G; ++l) r[l] = x; return r; };

  // Tile-local DP rows + per-adapter-row tile-edge carries (old = edges
  // after the previous tile, new = edges being written by this tile; rows
  // consume row i-1's OLD edge for the diagonal, so the arrays swap).
  s.m.assign(TILE + 1, vsplat(0));
  s.v.assign(TILE + 1, vsplat(neg));
  s.h.assign(TILE + 1, vsplat(neg));
  std::vector<V> cm_old(A + 1, vsplat(0)), ch_old(A + 1, vsplat(neg));
  std::vector<V> cm_new(A + 1, vsplat(0)), ch_new(A + 1, vsplat(neg));
  if (!SCORE_ONLY && (int64_t)s.bits.size() < A * G * L1)
    s.bits.resize(A * G * L1);
  s.reads.assign(G * L, 4);
  s.adapters.assign(G * A, 4);
  s.reads_il.assign(L * G, 4);

  int32_t lr[G], la[G];
  for (int l = 0; l < G; ++l) {
    const int64_t k = g.jobs[l];
    if (k < 0) { lr[l] = 1; la[l] = 1; continue; }
    const int64_t ri = pair_read[k], ai = pair_adapter[k];
    lr[l] = (int32_t)(roff[ri + 1] - roff[ri]);
    la[l] = (int32_t)(aoff[ai + 1] - aoff[ai]);
    std::memcpy(&s.reads[l * L], rbuf + roff[ri], lr[l]);
    std::memcpy(&s.adapters[l * A], abuf + aoff[ai], la[l]);
  }
  for (int l = 0; l < G; ++l)
    for (int64_t j = 0; j < L; ++j)
      s.reads_il[j * G + l] = s.reads[l * L + j];

  V* m = s.m.data();
  V* v = s.v.data();
  V* h = s.h.data();
  const V vmatch = vsplat((E)match), vmismatch = vsplat((E)mismatch);
  const V vopen = vsplat((E)open_), vext = vsplat((E)ext);
  const V one = vsplat(1), two = vsplat(2), four = vsplat(4), eight = vsplat(8);

  int32_t col_best[G], col_i[G];
  uint8_t col_vf[G], col_hf[G];
  int32_t row_best[G];
  int64_t j_star[G];
  uint8_t row_vf[G], row_hf[G];
  for (int l = 0; l < G; ++l) {
    col_best[l] = 0; col_i[l] = 0; col_vf[l] = 0; col_hf[l] = 0;
    row_best[l] = 0; j_star[l] = 0;     // M(last row, 0) == 0 always
    row_vf[l] = 0; row_hf[l] = 0;
  }

  typedef uint8_t VU8 __attribute__((vector_size(VecOf<E>::lanes)));
  typedef int8_t VI8 __attribute__((vector_size(VecOf<E>::lanes)));

  std::vector<V> ac_all(A), active_all(A);  // per-row adapter codes/activity
  for (int64_t i = 1; i <= A; ++i) {
    V ac, active;
    for (int l = 0; l < G; ++l) {
      ac[l] = (E)s.adapters[l * A + (i - 1)];
      active[l] = (E)((i <= la[l]) ? -1 : 0);
    }
    ac_all[i - 1] = ac;
    active_all[i - 1] = active;
  }

  // Column-0 trace bytes (the boundary column every row writes as 0).
  if (!SCORE_ONLY)
    for (int64_t i = 1; i <= A; ++i)
      std::memset(s.bits.data() + (i - 1) * G * L1, 0, G);

  // Tiles over global columns 1..L; carries start at the column-0
  // boundary (M(i, 0) = 0, H(i, 0) = NEG for every row), so the first
  // tile needs no special casing.
  for (int64_t c0 = 1; c0 <= L; c0 += TILE) {
    const int64_t c1 = std::min(L + 1, c0 + TILE);
    const int64_t width = c1 - c0;
    // Row 0 of this tile: M = 0, V/H = boundary.
    for (int64_t t = 0; t < width; ++t) {
      m[t] = vsplat(0);
      v[t] = vsplat(neg);
      h[t] = vsplat(neg);
    }
    for (int64_t i = 1; i <= A; ++i) {
      uint8_t* brow =
          SCORE_ONLY ? nullptr : s.bits.data() + (i - 1) * G * L1 + c0 * G;
      const V ac = ac_all[i - 1];
      const V active = active_all[i - 1];
      V diag_prev = cm_old[i - 1];          // M(i-1, c0-1)
      V h_prev = ch_old[i];                 // H(i, c0-1)
      V m_prev_col = cm_old[i];             // M(i, c0-1)
      for (int64_t t = 0; t < width; ++t) {
        const int64_t j = c0 + t;           // global column (>= 1)
        VI8 rc8;
        std::memcpy(&rc8, &s.reads_il[(j - 1) * G], sizeof(rc8));
        const V rc = __builtin_convertvector(rc8, V);
        const V sub = (rc == ac) ? vmatch : vmismatch;
        const V v_ext = v[t] + vext;
        const V v_open = m[t] + vopen;
        const V vbit = (v_ext >= v_open);
        const V nv = vbit ? v_ext : v_open;
        const V h_ext = h_prev + vext;
        const V h_open = m_prev_col + vopen;    // M(i, j-1), this row
        const V hbit = (h_ext >= h_open);
        const V nh = hbit ? h_ext : h_open;
        const V d = diag_prev + sub;
        const V mvbit = (nv >= nh);
        const V gap = mvbit ? nv : nh;
        const V dbit = (d >= gap);
        const V nm = dbit ? d : gap;
        if (!SCORE_ONLY) {
          const V bits = (hbit & one) | (vbit & two) | (dbit & four) |
                         (mvbit & eight);
          const VU8 b8 = __builtin_convertvector(bits, VU8);
          std::memcpy(brow + t * G, &b8, sizeof(b8));
        }
        diag_prev = m[t];                   // M(i-1, j) before update
        const V m_stored = active ? nm : m[t];
        const V v_stored = active ? nv : v[t];
        const V h_stored = active ? nh : h[t];
        m_prev_col = m_stored;              // frozen rows keep old M chain
        h_prev = h_stored;
        m[t] = m_stored;
        v[t] = v_stored;
        h[t] = h_stored;
      }
      // Edge carries for the next tile; frozen rows inherit the last
      // active row's edge (matching the shared-array semantics).
      cm_new[i] = m_prev_col;
      ch_new[i] = h_prev;
      // Final-column scout: lanes whose read ends inside this tile.
      for (int l = 0; l < G; ++l) {
        if (i > la[l]) continue;
        if (lr[l] < c0 || lr[l] >= c1) continue;
        const int64_t t = lr[l] - c0;       // tile-local index
        const int32_t mm = m[t][l];
        if (mm > col_best[l]) {
          col_best[l] = mm; col_i[l] = (int32_t)i;
          col_vf[l] = (v[t][l] == mm);
          col_hf[l] = (!col_vf[l] && h[t][l] == mm);
        }
      }
    }
    std::swap(cm_old, cm_new);
    std::swap(ch_old, ch_new);
    // Last-row scout over this tile (strict > keeps the leftmost max;
    // tiles run left to right so the running argmax matches a full scan).
    for (int l = 0; l < G; ++l) {
      for (int64_t j = c0; j < std::min<int64_t>(lr[l], c1); ++j) {
        const int64_t t = j - c0;
        const int32_t mm = m[t][l];
        if (mm > row_best[l]) {
          row_best[l] = mm; j_star[l] = j;
          row_vf[l] = (v[t][l] == mm);
          row_hf[l] = (!row_vf[l] && h[t][l] == mm);
        }
      }
    }
  }

  int32_t ci[G], cj[G], best[G];
  uint8_t vf[G], hf[G];
  for (int l = 0; l < G; ++l) {
    if (col_best[l] > row_best[l]) {
      best[l] = col_best[l]; ci[l] = col_i[l]; cj[l] = lr[l];
      vf[l] = col_vf[l]; hf[l] = col_hf[l];
    } else {
      best[l] = row_best[l]; ci[l] = la[l]; cj[l] = (int32_t)j_star[l];
      vf[l] = row_vf[l]; hf[l] = row_hf[l];
    }
  }

  if (SCORE_ONLY) {
    for (int l = 0; l < G; ++l) {
      const int64_t k = g.jobs[l];
      if (k < 0) continue;
      int64_t* o = out + k * 9;
      o[0] = 0; o[1] = 0; o[2] = 0; o[3] = 0;
      o[4] = best[l]; o[5] = 0; o[6] = 0; o[7] = 0; o[8] = 0;
    }
    return;
  }
  std::vector<int64_t> stats(G * 8);
  traceback_stats_ex(s.bits.data(), L1 * G, 1, G, s.reads.data(),
                     s.adapters.data(), ci, cj, vf, hf, lr, la, G, L, A,
                     stats.data());
  for (int l = 0; l < G; ++l) {
    const int64_t k = g.jobs[l];
    if (k < 0) continue;
    int64_t* o = out + k * 9;
    const int64_t* st = stats.data() + l * 8;
    o[0] = st[0]; o[1] = st[1]; o[2] = st[2]; o[3] = st[3];
    o[4] = best[l]; o[5] = st[4]; o[6] = st[5]; o[7] = st[6]; o[8] = 0;
  }
}

template <typename E, bool SCORE_ONLY>
void run_all(const int8_t* reads, const int64_t* read_off,
             const int8_t* adapters, const int64_t* adapter_off,
             const int64_t* pair_read, const int64_t* pair_adapter,
             int64_t P, int match, int mismatch, int open_, int ext,
             E neg, int64_t n_threads, int64_t* out) {
  constexpr int G = VecOf<E>::lanes;
  std::vector<int64_t> order(P);
  std::iota(order.begin(), order.end(), 0);
  // Sort by (read len, adapter len): a lane group pads every lane to the
  // group max in BOTH dimensions, so mixing adapter lengths (detection runs
  // 20-110 bp adapters over equal windows) wastes rows on every lane.
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    const int64_t ra = read_off[pair_read[a] + 1] - read_off[pair_read[a]];
    const int64_t rb = read_off[pair_read[b] + 1] - read_off[pair_read[b]];
    if (ra != rb) return ra < rb;
    const int64_t aa =
        adapter_off[pair_adapter[a] + 1] - adapter_off[pair_adapter[a]];
    const int64_t ab =
        adapter_off[pair_adapter[b] + 1] - adapter_off[pair_adapter[b]];
    return aa < ab;
  });
  const int64_t n_groups = (P + G - 1) / G;
  std::vector<Group<E>> groups(n_groups);
  for (int64_t gi = 0; gi < n_groups; ++gi) {
    Group<E>& g = groups[gi];
    g.jobs.assign(G, -1);
    g.lr_max = 1;
    g.la_max = 1;
    for (int l = 0; l < G; ++l) {
      const int64_t idx = gi * G + l;
      if (idx >= P) break;
      const int64_t k = order[idx];
      g.jobs[l] = k;
      g.lr_max = std::max<int64_t>(
          g.lr_max, read_off[pair_read[k] + 1] - read_off[pair_read[k]]);
      g.la_max = std::max<int64_t>(
          g.la_max,
          adapter_off[pair_adapter[k] + 1] - adapter_off[pair_adapter[k]]);
    }
  }

  n_threads = std::max<int64_t>(1, n_threads);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    Scratch<E> s;
    for (;;) {
      const int64_t gi = next.fetch_add(1);
      if (gi >= n_groups) break;
      run_group<E, SCORE_ONLY>(groups[gi], reads, read_off, adapters,
                               adapter_off, pair_read, pair_adapter, match,
                               mismatch, open_, ext, neg, s, out);
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

template <bool SCORE_ONLY>
void simd_batch_impl(const int8_t* reads, const int64_t* read_off,
                     const int8_t* adapters, const int64_t* adapter_off,
                     const int64_t* pair_read, const int64_t* pair_adapter,
                     int64_t P, int match, int mismatch, int open_, int ext,
                     int64_t n_threads, int64_t* out) {
  // int16 lanes are safe when every reachable score fits comfortably:
  // |M| <= A*max(|match|,|mismatch|) for the path part and the boundary
  // chains stay above NEG16 + accumulated penalties.
  int64_t max_la = 0;
  for (int64_t k = 0; k < P; ++k)
    max_la = std::max(max_la,
                      adapter_off[pair_adapter[k] + 1]
                      - adapter_off[pair_adapter[k]]);
  const int64_t mag = std::max({std::abs((int64_t)match),
                                std::abs((int64_t)mismatch),
                                std::abs((int64_t)open_),
                                std::abs((int64_t)ext)});
  const int64_t bound = (max_la + 2) * mag + std::abs((int64_t)open_);
  if (bound < 8000) {
    run_all<int16_t, SCORE_ONLY>(reads, read_off, adapters, adapter_off,
                                 pair_read, pair_adapter, P, match, mismatch,
                                 open_, ext, (int16_t)-8192, n_threads, out);
  } else {
    run_all<int32_t, SCORE_ONLY>(reads, read_off, adapters, adapter_off,
                                 pair_read, pair_adapter, P, match, mismatch,
                                 open_, ext, -(1 << 30), n_threads, out);
  }

  for (int64_t k = 0; k < P; ++k) {
    const int64_t lr = read_off[pair_read[k] + 1] - read_off[pair_read[k]];
    const int64_t la = adapter_off[pair_adapter[k] + 1]
                       - adapter_off[pair_adapter[k]];
    if (lr == 0 || la == 0) {
      int64_t* o = out + k * 9;
      o[0] = -1; o[1] = -1; o[2] = -1; o[3] = -1;
      o[4] = INT32_MIN; o[5] = 0; o[6] = 0; o[7] = 0; o[8] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Same interface as align_host_batch (align_host.cpp).
void align_simd_batch(const int8_t* reads, const int64_t* read_off,
                      const int8_t* adapters, const int64_t* adapter_off,
                      const int64_t* pair_read, const int64_t* pair_adapter,
                      int64_t P, int match, int mismatch, int open_, int ext,
                      int64_t n_threads, int64_t* out) {
  simd_batch_impl<false>(reads, read_off, adapters, adapter_off, pair_read,
                         pair_adapter, P, match, mismatch, open_, ext,
                         n_threads, out);
}

// Score-only twin (dispatch run_scores prefilter): only out[k*9+4] (best
// score) and the degenerate-lane markers are meaningful.
void align_simd_scores(const int8_t* reads, const int64_t* read_off,
                       const int8_t* adapters, const int64_t* adapter_off,
                       const int64_t* pair_read, const int64_t* pair_adapter,
                       int64_t P, int match, int mismatch, int open_, int ext,
                       int64_t n_threads, int64_t* out) {
  simd_batch_impl<true>(reads, read_off, adapters, adapter_off, pair_read,
                        pair_adapter, P, match, mismatch, open_, ext,
                        n_threads, out);
}

}  // extern "C"
