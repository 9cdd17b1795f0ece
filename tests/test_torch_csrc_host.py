"""The CUDA sources of the PyTorch port (porechop_tpu_torch/csrc/*.cu), built
with g++ for the CPU and held against the kernels' plain versions.

A small stub header stands in for the CUDA runtime: one std::thread per CUDA
thread of a block, blocks run one after another, __shfl_*_sync,
__reduce_max_sync, __ballot_sync and __syncwarp as std::barrier exchanges
among a warp's 32 threads, `extern __shared__` as a buffer per block
(filled with junk, so a read of a byte the kernel never staged shows), the
DPX intrinsics in plain C++, and `k<<<grid, block, smem, stream>>>(args)`
rewritten into a host launch.  The exported pdp_* functions are then
called through ctypes on CPU pointers, bound as ops/kernels.py binds them
on the card.

What it shows: the kernels' arithmetic, tie rules, tile edges, scouts and
warp exchanges equal the plain versions on the outputs the walker reads;
the standalone walk (pdp_walk, csrc/dp_walk.cu) equals walk_plain and the
JAX package's walker (porechop_tpu/ops/engine_v2._traceback, plain XLA on
the CPU) on the same trace bits, from the JAX forward, the plain forward
and the host-built split forward, and on random bytes; the trace-bit call
with its walk (pdp_forward_walk) equals forward_walk_plain and the JAX
walker on the JAX forward's bits on its three routes (one tile, walking
shared memory alone; unsplit; split), and paths that cross the staging
blocks' edges walk right.
What it cannot show: every barrier runs the warp in lockstep, so it hides
races (a missing __syncwarp, a shared-memory hazard between warps of a
block) and anything of the card's compiler; only the card tests
(tests/test_torch_cuda.py) and chip_smoke.py show those.

Tolerance: exact; every output is an integer.
"""

import ctypes
import math
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from porechop_tpu.ops import engine_v2 as jax_engine
from porechop_tpu_torch.ops import engine_v2, kernels

from .test_torch_cases import (H100_WARPS, SCHEME, amax_of, call_tiled,
                               call_walk, dp_batch, gap_run_batch,
                               one_torch_thread, plan_warm, plant,
                               split_batch, tiled_diffs, to_torch)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

STUB = r'''
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) uint4 { unsigned x, y, z, w; };
typedef int cudaError_t;
typedef struct CUstream_st* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// The occupancy queries answer for an H100-like card: 132 SMs, 228 KB of
// shared memory per SM with 1 KB reserved per block, at most 32 blocks and
// 64 warps.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int threads, size_t smem) {
  const int by_smem = (int)(228 * 1024 / (smem + 1024));
  const int by_warps = 64 / ((threads + 31) / 32);
  *n = by_smem < 32 ? by_smem : 32;
  *n = *n < by_warps ? *n : by_warps;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }

namespace stub {
struct Warp {
  std::barrier<> bar{32};
  int buf[2][32];
};
struct Block {
  std::vector<std::unique_ptr<Warp>> warps;
  std::unique_ptr<uint4[]> smem;
};
inline thread_local Block* cur;
inline thread_local int phase;

inline Warp& warp() { return *cur->warps[threadIdx.x / 32]; }

// Every thread of the warp writes its value, waits for the others, and
// reads.  Two buffers in turn: a thread writes one again only after a
// later barrier, which every reader of its last contents has passed.
inline const int* exchange(int v) {
  Warp& w = warp();
  int* buf = w.buf[phase];
  phase ^= 1;
  buf[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  return buf;
}

template <class K, class A>
void launch(K kern, const A& args, dim3 grid, dim3 block, int smem,
            cudaStream_t) {
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    Block blk;
    for (unsigned w = 0; w < block.x / 32; ++w)
      blk.warps.emplace_back(new Warp);
    const size_t n16 = (size_t)(smem + 15) / 16 + 1;
    blk.smem.reset(new uint4[n16]);
    std::memset(blk.smem.get(), 0xa5, n16 * 16);
    std::vector<std::thread> threads;
    for (unsigned tx = 0; tx < block.x; ++tx)
      threads.emplace_back([&, tx] {
        threadIdx = dim3(tx);
        blockIdx = dim3(bx);
        blockDim = block;
        gridDim = grid;
        cur = &blk;
        phase = 0;
        kern(args);
      });
    for (auto& th : threads) th.join();
  }
}
}  // namespace stub

// The shuffles as CUDA defines them with a width: each segment of `width`
// lanes reads within itself (and, for xor, from earlier segments); a source
// outside it gives the caller its own value.
inline int __shfl_up_sync(unsigned, int v, unsigned d, int width = 32) {
  const int lane = threadIdx.x % 32;
  const int* buf = stub::exchange(v);
  return lane % width >= (int)d ? buf[lane - (int)d] : v;
}
inline int __shfl_xor_sync(unsigned, int v, int m, int width = 32) {
  const int lane = threadIdx.x % 32;
  const int src = lane ^ m;
  const int* buf = stub::exchange(v);
  return src < (lane / width + 1) * width ? buf[src] : v;
}
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return stub::exchange(v)[lane / width * width + (src & (width - 1))];
}
inline int __reduce_max_sync(unsigned, int v) {
  const int* buf = stub::exchange(v);
  int m = buf[0];
  for (int k = 1; k < 32; ++k) m = max(m, buf[k]);
  return m;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  stub::warp().bar.arrive_and_wait();
}
inline void __threadfence_block() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline unsigned __ballot_sync(unsigned, int p) {
  const int* buf = stub::exchange(p != 0);
  unsigned m = 0;
  for (int k = 0; k < 32; ++k) m |= (unsigned)(buf[k] != 0) << k;
  return m;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
'''

_LAUNCH = re.compile(r'(\w+)\s*<<<(.*?)>>>\s*\((.*?)\)\s*;', re.S)
_SHARED = re.compile(
    r'extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\]\s*;')


def _host_source(text):
    """A CUDA source rewritten for the stub: launches become
    stub::launch(kernel, args, grid, block, smem, stream), the dynamic
    shared array a pointer to the block's buffer."""
    text = _LAUNCH.sub(r'::stub::launch(\1, \3, \2);', text)
    return _SHARED.sub(
        r'\1* \2 = reinterpret_cast<\1*>(::stub::cur->smem.get());', text)


@pytest.fixture(scope='module')
def host_kernels(tmp_path_factory):
    """{kernel name: bound C function} of csrc/*.cu built with g++ against
    the stub, one g++ per source, all started together (forward_tiled and
    forward_walk share dp_tiled.cu)."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the CUDA sources for the CPU')
    root = tmp_path_factory.mktemp('csrc_host')
    (root / 'cuda_runtime.h').write_text(STUB)
    for src in kernels.CSRC.iterdir():
        if src.suffix in ('.cu', '.cuh'):
            (root / src.name).write_text(_host_source(src.read_text()))
    procs = {}
    for src in sorted(set(kernels.SOURCES.values())):
        procs[src] = subprocess.Popen(
            [gxx, '-std=c++20', '-O1', '-pthread', '-shared', '-fPIC',
             '-I', str(root), '-x', 'c++', '-o', str(root / (src[:-3] + '.so')),
             str(root / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for proc in procs.values():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
    fns = {}
    for name, src in kernels.SOURCES.items():
        fns[name] = kernels.bind(root / (src[:-3] + '.so'), name)
        fns[name].library = root / (src[:-3] + '.so')
    return fns


def _run(fn, batch, ints, outs):
    reads, rl, adps, al = batch
    rc = fn(reads.data_ptr(), rl.data_ptr(), adps.data_ptr(), al.data_ptr(),
            *ints, *(o.data_ptr() for o in outs), None)
    assert rc == 0, rc


def _assert_match_plain(fns, batch, scheme):
    reads, rl, adps, al = batch
    B, L = reads.shape
    A = adps.shape[1]
    score = torch.empty(B, dtype=torch.int32)
    _run(fns['forward_score'], batch, (B, L, A, *scheme, 1), (score,))
    stats = [torch.empty(B, dtype=torch.int32) for _ in range(4)]
    _run(fns['forward_stats'], batch, (B, L, A, *scheme, 1), stats)
    assert torch.equal(score, kernels.forward_score_plain(*batch, *scheme))
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'matches',
                           'full_len'), kernels._decode_stats(*stats, rl, al),
                          kernels.forward_stats_plain(*batch, *scheme)):
        assert torch.equal(g, w), name
    assert tiled_diffs(call_tiled(fns['forward_tiled'], batch, scheme),
                       kernels.forward_tiled_plain(*batch, *scheme),
                       batch) == []


def _edge_batch(seed, L, A, lens):
    """dp_batch lanes whose read lengths are set to lens (tile edges, 0, 1),
    with adapter lengths A (lane 0), 0 (lane 1) and 1 (the last lane), and
    lane 2 a one-base adapter matching only the first of two read bases
    (the best score at the last row's column 1)."""
    reads, rl, adps, al = dp_batch(seed, len(lens), L, A)
    rl[:] = lens
    al[0], al[1], al[-1] = A, 0, 1
    rl[2], al[2] = 2, 1
    reads[2, :2] = adps[2, 0], (adps[2, 0] + 1) % 4
    return to_torch(reads, rl, adps, al)


SCHEMES = [SCHEME, (20, -30, -5, -2)]
T = kernels.TILE_T
# Read lengths of the lanes: empty, one column, the trace-bit tile's edges
# (T = 256 columns, column 0 included) and the full window.
LENS = [0, 1, T - 2, T - 1, T, T + 1, 2 * T - 1, 2 * T, 600, 311, 599, 37]


@pytest.mark.parametrize('scheme', SCHEMES, ids=['default', '20,-30,-5,-2'])
@pytest.mark.parametrize('A', [5, 24, 32, 33, 48, 64, 65, 80, 96, 97, 100,
                               128])
def test_csrc_matches_plain(host_kernels, A, scheme):
    """All three kernels at every register-row count (AMAX 32, 64, 96, 128
    and the edges between them), with lanes of read length 0 and adapter
    length 1 and a lane whose adapter fills A."""
    _assert_match_plain(host_kernels, _edge_batch(A, 600, A, LENS), scheme)


@pytest.mark.parametrize('A', [24, 64, 128])
def test_csrc_matches_plain_across_scan_tiles(host_kernels, A):
    """Score and stats walk 1,024-column tiles: lanes end inside, at and
    past the first two tile edges, in blocks of four lanes of different
    lengths."""
    S = 1024
    lens = [S - 2, S - 1, S, S + 1, 2 * S - 1, 2 * S, 2 * S + 1, 0, 1, 700]
    _assert_match_plain(host_kernels, _edge_batch(40 + A, 2 * S + 1, A, lens),
                        SCHEME)


@pytest.mark.parametrize('C', [T, 2 * T])
@pytest.mark.parametrize('scheme', SCHEMES, ids=['default', '20,-30,-5,-2'])
@pytest.mark.parametrize('A', [24, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
def test_split_matches_plain(host_kernels, A, scheme, C):
    """The trace-bit forward with every lane cut into chunks of C columns,
    each after the plan's warm-up, equals the unsplit plain version: the
    bits in the walker's region and the elected cell and flags."""
    batch = split_batch(A, C)
    got = call_tiled(host_kernels['forward_tiled'], batch, scheme, C,
                     plan_warm(A, scheme))
    assert tiled_diffs(got, kernels.forward_tiled_plain(*batch, *scheme),
                       batch) == []


def test_split_with_a_short_warm_up_goes_wrong(host_kernels):
    """The test sees a warm-up below the bound: with a perfect adapter copy
    ending just before a chunk starts, 16 columns of warm-up leave the
    chunk's values short of the copy's score, and its bits differ; the
    plan's warm-up on the same lanes is exact."""
    A = 24
    reads, rl, adps, al = dp_batch(77, 4, 700, A)
    rl[:] = 700
    al[:] = A
    for k in range(4):
        plant(reads, adps, al, k, T - 1 - 3 * k)
    batch = to_torch(reads, rl, adps, al)
    fn = host_kernels['forward_tiled']
    want = kernels.forward_tiled_plain(*batch, *SCHEME)
    assert tiled_diffs(call_tiled(fn, batch, SCHEME, T, 16), want, batch)
    assert tiled_diffs(call_tiled(fn, batch, SCHEME, T,
                                  plan_warm(A, SCHEME)), want, batch) == []


def _rung96_batch(seed, L, lens):
    """Lanes of one launch at the barcoded middle's adapter rung (A = 96,
    AMAX 96: 3 rows a thread) whose adapters are 65, 80 and 96 bases long in
    turn (22, 27 and 32 threads owning rows), with read lengths `lens`, and
    a pad lane (read and adapter length 0) last."""
    A = 96
    reads, rl, adps, al = dp_batch(seed, len(lens) + 1, L, A)
    rl[:-1] = lens
    al[:-1] = [(65, 80, 96)[k % 3] for k in range(len(lens))]
    rl[-1] = al[-1] = 0
    return reads, rl, adps, al


def test_mixed_adapter_lengths_at_amax_96(host_kernels):
    """Score, stats, the trace-bit forward and the forward with its walk on
    one A = 96 launch of lanes with 65-, 80- and 96-base adapters across
    three tiles (one lane's adapter longer than its read), five carrying
    their adapter: exact against the plain versions."""
    reads, rl, adps, al = _rung96_batch(
        96, 700, [700, 600, 512, 300, 257, 256, 700, 511, 90])
    for k in range(5):
        plant(reads, adps, al, k, int(rl[k]) - 5 * k)
    batch = to_torch(reads, rl, adps, al)
    _assert_match_plain(host_kernels, batch, SCHEME)
    walk, best, ci, cj = call_walk(host_kernels['forward_walk'], batch,
                                   SCHEME)[:4]
    for name, g, w in zip(('walk', 'best', 'cell_i', 'cell_j'),
                          (walk, best, ci, cj),
                          kernels.forward_walk_plain(*batch, *SCHEME)):
        assert torch.equal(g, w), name
    assert (walk[:5, 3] == torch.from_numpy(al[:5])).all()


def test_split_at_the_barcoded_plan(host_kernels):
    """The barcoded middle's trace-bit launch (512 x 10,240 x 96) on an
    H100 plans two chunks of 6,144 columns after a 768-column warm-up
    (warm_bound 530); the host-built forward with its walk, cut so, equals
    the unsplit plain versions on lanes of 65-, 80- and 96-base adapters
    ending around the chunk edge, with copies ending inside the warm-up and
    straddling the edge and an N run across it."""
    A, L = 96, 10240
    assert kernels.warm_bound(A, SCHEME) == 530
    chunk, warm = kernels.split_plan(512, L, A, SCHEME, H100_WARPS[96])
    assert (chunk, warm) == (6144, 768) and L // chunk + 1 == 2
    reads, rl, adps, al = _rung96_batch(
        97, L, [L, chunk, chunk - 1, 8000, chunk + 1, 9000])
    plant(reads, adps, al, 0, chunk - 1)
    plant(reads, adps, al, 1, chunk)
    plant(reads, adps, al, 3, chunk + 40)
    plant(reads, adps, al, 5, chunk - warm + 30)
    reads[4, chunk - 30:chunk + 30] = 4
    batch = to_torch(reads, rl, adps, al)
    walk, best, ci, cj, vf, hf, bits = call_walk(
        host_kernels['forward_walk'], batch, SCHEME, chunk, warm)
    want = kernels.forward_tiled_plain(*batch, *SCHEME)
    assert tiled_diffs((bits, best, ci, cj, vf != 0, hf != 0), want,
                       batch) == []
    assert torch.equal(walk, kernels.walk_plain(*want[:1], *want[2:]))
    assert (walk[[0, 1, 3, 5], 3] == torch.from_numpy(al[[0, 1, 3, 5]])).all()


@pytest.mark.parametrize('A', [24, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
def test_tiled_warps_queries_each_instantiation(host_kernels, A):
    """pdp_tiled_warps asks the runtime's occupancy query for the
    instantiation that serves A, with its shared memory: the stub's
    H100-like card answers what an H100 does."""
    n = ctypes.c_int(0)
    assert host_kernels['forward_tiled'].warps(A, ctypes.byref(n)) == 0
    assert n.value == H100_WARPS[amax_of(A)]


def test_tiled_warps_refuses_past_128_rows(host_kernels):
    n = ctypes.c_int(0)
    assert host_kernels['forward_tiled'].warps(129, ctypes.byref(n)) != 0


def test_wrapper_splits_by_its_plan(host_kernels, monkeypatch):
    """kernels.forward_tiled's own launch path (the card's warps from the
    occupancy query, split_plan, the scratch for the chunks' scouts, the
    launch and shape counters) on the host-built kernel: three 4.5 kb lanes
    split into 2,048-column chunks and equal the plain version."""
    monkeypatch.setattr(kernels, '_check', lambda *args: True)
    monkeypatch.setattr(kernels, '_lib', host_kernels.__getitem__)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    L, A = 4500, 24
    assert kernels.split_plan(3, L, A, SCHEME, H100_WARPS[32]) == (2048, 256)
    reads, rl, adps, al = dp_batch(91, 3, L, A)
    rl[:] = L, 2048, 4097
    al[:] = A
    plant(reads, adps, al, 0, 2047)
    plant(reads, adps, al, 1, 2048)
    plant(reads, adps, al, 2, 4096 + A // 2)
    batch = to_torch(reads, rl, adps, al)
    kernels.reset_launches()
    kernels.card_warps.cache_clear()
    try:
        got = kernels.forward_tiled(*batch, *SCHEME)
        assert kernels.card_warps(32) == H100_WARPS[32]
    finally:
        kernels.card_warps.cache_clear()
    assert kernels.TILED_CALLS == {(3, L, A, 3): 1}
    assert kernels.LAUNCHES['forward_tiled'] == 1
    assert tiled_diffs(got, kernels.forward_tiled_plain(*batch, *SCHEME),
                       batch) == []
    kernels.reset_launches()


def test_host_source_rewrites_launch_and_shared_memory():
    src = ('extern __shared__ __align__(16) uint8_t smem[];\n'
           'kern<<<grid, block, smem, stream>>>(p);')
    got = _host_source(src)
    assert '<<<' not in got and '__shared__' not in got
    assert '::stub::launch(kern, p, grid, block, smem, stream);' in got


# ---------------------------------------------------------------------------
# Lanes narrower than a warp (score and stats: 4 lanes of 8 threads at
# AMAX 24, 2 of 16 at AMAX 48)
# ---------------------------------------------------------------------------

# A shuffle that not every thread of a warp reaches leaves the stub's
# std::barrier waiting forever, so each call of a sub-warp layout runs in a
# child process of its own, cut after this many seconds; after one such
# cut the later calls fail at once (_HUNG), so that a hang costs one limit,
# not one a case.
SUBWARP_TIMEOUT = 120
_HUNG = []

# The child: numpy and ctypes only.  argv: library, C function, file stem,
# then the ints; inputs from <stem>.in.npz, outputs (started as junk) and
# the return code to <stem>.out.npz.
_CHILD = r"""
import ctypes, sys
import numpy as np
lib, name, stem = sys.argv[1:4]
ints = [int(x) for x in sys.argv[4:]]
data = np.load(stem + '.in.npz')
ins = [np.ascontiguousarray(data[k]) for k in ('reads', 'rl', 'adps', 'al')]
outs = [np.full(len(ins[1]), -7, np.int32) for _ in range(int(data['n_out']))]
fn = getattr(ctypes.CDLL(lib), 'pdp_' + name)
fn.restype = ctypes.c_int
rc = fn(*(ctypes.c_void_p(a.ctypes.data) for a in ins),
        *(ctypes.c_int(x) for x in ints),
        *(ctypes.c_void_p(o.ctypes.data) for o in outs), ctypes.c_void_p(None))
np.savez(stem + '.out.npz', np.int32(rc), *outs)
"""


def _child_call(fn, name, batch, ints, n_out, stem):
    """The host-built C function `fn` (pdp_<name>) on the batch in a child
    process with its own time limit: its int32 outputs (B,) as tensors."""
    if _HUNG:
        pytest.fail('an earlier sub-warp call hung: %s' % _HUNG[0])
    reads, rl, adps, al = (np.asarray(x) for x in batch)
    np.savez('%s.in.npz' % stem, reads=reads, rl=rl, adps=adps, al=al,
             n_out=n_out)
    try:
        r = subprocess.run([sys.executable, '-c', _CHILD, str(fn.library),
                            name, str(stem), *(str(x) for x in ints)],
                           capture_output=True, text=True,
                           timeout=SUBWARP_TIMEOUT)
    except subprocess.TimeoutExpired:
        _HUNG.append('%s %s' % (name, ints))
        raise
    assert r.returncode == 0, r.stderr[-3000:]
    got = np.load('%s.out.npz' % stem)
    assert int(got['arr_0']) == 0, int(got['arr_0'])
    return [torch.from_numpy(got['arr_%d' % k]) for k in range(1, n_out + 1)]


def _subwarp(fns, batch, scheme, group, tmp_path):
    """Score and stats of the batch with `group` lanes a warp, each in a
    child: (best,), (best, cell_i, cell_j, matches, full_len)."""
    reads, rl, adps, al = batch
    B, L = reads.shape
    ints = (B, L, adps.shape[1], *scheme, group)
    score = _child_call(fns['forward_score'], 'forward_score', batch, ints, 1,
                        tmp_path / 'score')
    stats = _child_call(fns['forward_stats'], 'forward_stats', batch, ints, 4,
                        tmp_path / 'stats')
    return score, kernels._decode_stats(*stats, torch.as_tensor(rl),
                                        torch.as_tensor(al))


def _assert_subwarp_matches_plain(fns, batch, scheme, group, tmp_path):
    batch = to_torch(*batch)
    score, stats = _subwarp(fns, batch, scheme, group, tmp_path)
    assert torch.equal(score[0], kernels.forward_score_plain(*batch, *scheme))
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'matches',
                           'full_len'), stats,
                          kernels.forward_stats_plain(*batch, *scheme)):
        assert torch.equal(g, w), name


def _group_of(A):
    return 4 if A <= 24 else 2


@pytest.mark.parametrize('scheme', SCHEMES, ids=['default', '20,-30,-5,-2'])
@pytest.mark.parametrize('A', [16, 20, 24, 33, 40, 48])
def test_subwarp_lanes_match_plain(host_kernels, A, scheme, tmp_path):
    """Score and stats at four lanes a warp (A = 16, 20, 24: AMAX 24, 6-8
    threads holding rows) and two (A = 33, 40, 48: AMAX 48, 11-16), on
    _edge_batch's lanes and one more: 13 lanes, not a multiple of either,
    the last warp's other lanes past B; exact against the plain
    versions."""
    batch = _edge_batch(A, 600, A, LENS + [37])
    _assert_subwarp_matches_plain(host_kernels, batch, scheme, _group_of(A),
                                  tmp_path)


@pytest.mark.parametrize('A', [24, 48])
def test_subwarp_lanes_match_pallas(host_kernels, A, tmp_path):
    """128 lanes of 150 bp windows at A = 24 (four lanes a warp) and 48
    (two) against the JAX Pallas kernels in interpret mode: score and stats
    lane-major (_score_kernel, _stats_kernel) and transposed
    (_score_kernel_t, _stats_kernel_t, as detection runs them)."""
    from jax.experimental.pallas import tpu as pltpu
    from porechop_tpu.ops import kernel_pallas
    batch = dp_batch(120 + A, 128, 150, A)
    score, stats = _subwarp(host_kernels, to_torch(*batch), SCHEME,
                            _group_of(A), tmp_path)
    with pltpu.force_tpu_interpret_mode():
        want_score = [kernel_pallas.forward_score_pallas(*batch, *SCHEME),
                      kernel_pallas.forward_score_pallas_t(*batch, *SCHEME)]
        want_stats = [kernel_pallas.forward_stats_pallas(*batch, *SCHEME),
                      kernel_pallas.forward_stats_pallas_t(*batch, *SCHEME)]
    for w in want_score:
        assert np.array_equal(score[0].numpy(), np.asarray(w))
    for w in want_stats:
        for name, g, x in zip(('best', 'cell_i', 'cell_j', 'matches',
                               'full_len'), stats, w):
            assert np.array_equal(g.numpy(), np.asarray(x)), name


def _ragged_batch(case, A):
    """Lanes whose warps are ragged at four lanes a warp (A <= 24) and at
    two: 'read lengths' mixes 0, 1, 37 and 150 with lanes of 1,100 and
    1,030 bp that span two SCAN_T tiles (10 lanes, the last warp part past
    B); 'adapter lengths' mixes A, 1, A / 2, 0 and A - 1 in each warp;
    'past B' is 5 lanes (four a warp) or 3 (two), so that whole warps of
    the block lie past B.  Some lanes carry their adapter."""
    L = 1100
    lens = {'read lengths': [0, 1, 37, 150, L, 1, 37, 0, 1030, 150],
            'adapter lengths': [150, 149, 148, 151, 600, 37, 150, 150],
            'past B': [150, 37, 150, 1, 90][:5 if A <= 24 else 3]}[case]
    reads, rl, adps, al = dp_batch(130 + A + len(lens), len(lens), L, A)
    rl[:] = lens
    if case == 'adapter lengths':
        al[:] = np.resize([A, 1, A // 2, 0, A - 1], len(lens))
    else:
        al[:] = np.resize([A, A - 3, A // 2 + 1], len(lens))
    for k in range(len(lens)):
        if rl[k] > al[k] + 10 and k % 2 == 0:
            plant(reads, adps, al, k, int(rl[k]) - 3 - k)
    return reads, rl, adps, al


@pytest.mark.parametrize('case', ['read lengths', 'adapter lengths',
                                  'past B'])
@pytest.mark.parametrize('A', [24, 48])
def test_subwarp_ragged_warps(host_kernels, A, case, tmp_path):
    """Warps whose lanes end at different columns and rows, or lie past B:
    every lane's loops run to its warp's bounds with its own cells masked,
    and the result equals the plain versions exactly."""
    _assert_subwarp_matches_plain(host_kernels, _ragged_batch(case, A),
                                  SCHEME, _group_of(A), tmp_path)


@pytest.mark.parametrize('A,group', [(25, 4), (49, 2), (20, 3), (129, 1),
                                     (30, 8)])
def test_subwarp_refused_groups(host_kernels, A, group):
    """A group the width does not allow (four lanes past 24 rows, two past
    48, three, eight) or a width past 128 returns an error code before
    any launch; the wrapper raises on it."""
    batch = to_torch(*dp_batch(5, 4, 60, A))
    for name, n_out in (('forward_score', 1), ('forward_stats', 4)):
        outs = [torch.empty(4, dtype=torch.int32) for _ in range(n_out)]
        rc = host_kernels[name](*(x.data_ptr() for x in batch), 4, 60, A,
                                *SCHEME, group,
                                *(o.data_ptr() for o in outs), None)
        assert rc == (100000 if A > 128 else 100004), rc


def test_wrapper_raises_for_a_refused_group(host_kernels, monkeypatch):
    monkeypatch.setattr(kernels, '_check', lambda *args: True)
    monkeypatch.setattr(kernels, '_lib', host_kernels.__getitem__)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    batch = to_torch(*dp_batch(6, 4, 60, 40))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match='100004'):
        kernels.forward_score(*batch, *SCHEME, group=4)
    with pytest.raises(RuntimeError, match='100004'):
        kernels.forward_stats(*batch, *SCHEME, group=3)
    assert kernels.LAUNCHES['forward_score'] == 0
    assert kernels.LAUNCHES['forward_stats'] == 0


@pytest.mark.parametrize('name', ['forward_score', 'forward_stats'])
@pytest.mark.parametrize('A', [16, 24, 48, 64, 96, 128])
def test_wave_warps_query_the_one_lane_instantiation(host_kernels, name, A):
    """pdp_score_warps and pdp_stats_warps ask the occupancy query for the
    one-lane-a-warp instantiation that serves A (four-warp blocks): the
    stub's H100-like card holds 16 of them an SM, 8,448 warps; past 128
    rows the query refuses."""
    n = ctypes.c_int(0)
    assert host_kernels[name].warps(A, ctypes.byref(n)) == 0
    assert n.value == 132 * 64
    assert host_kernels[name].warps(129, ctypes.byref(n)) != 0


def test_lane_group_reads_the_card(host_kernels, monkeypatch):
    """lane_group takes the narrow layout for widths up to 24 (four lanes)
    and 33-48 (two) once a launch holds at least NARROW_FROM of the card's
    one-lane-a-warp warps of that kernel (the stub's 8,448), one lane a
    warp otherwise, at 25-32 and past 48; the wrappers launch with its
    choice unless given one."""
    monkeypatch.setattr(kernels, '_lib', host_kernels.__getitem__)
    kernels.card_warps.cache_clear()
    try:
        for name in ('forward_score', 'forward_stats'):
            warps = kernels.card_warps(24, None, name)
            assert warps == 132 * 64
            least = math.ceil(kernels.NARROW_FROM * warps)
            for B, A, want in ((least, 16, 4), (least, 24, 4), (warps, 25, 1),
                               (warps, 32, 1), (least, 33, 2),
                               (warps, 48, 2), (warps, 49, 1),
                               (warps, 96, 1), (least - 1, 24, 1),
                               (least - 1, 48, 1), (4 * warps, 20, 4)):
                assert kernels.lane_group(name, B, A) == want, (name, B, A)
        seen = []
        monkeypatch.setattr(kernels, '_check', lambda *args: True)
        monkeypatch.setattr(kernels, '_launch',
                            lambda name, *args: seen.append((name,
                                                             args[-2][-1])))
        big = [torch.zeros((warps, 1), dtype=torch.int8), torch.zeros(
            warps, dtype=torch.int32), torch.zeros((warps, 40),
                                                    dtype=torch.int8),
               torch.zeros(warps, dtype=torch.int32)]
        kernels.forward_score(*big, *SCHEME)
        kernels.forward_stats(*big, *SCHEME)
        kernels.forward_score(*big, *SCHEME, group=1)
        kernels.forward_stats(*(x[:8] for x in big), *SCHEME)
    finally:
        kernels.card_warps.cache_clear()
    assert seen == [('forward_score', 2), ('forward_stats', 2),
                    ('forward_score', 1), ('forward_stats', 1)]


def test_wave_layout_names_the_instantiation():
    assert [kernels.narrow_group(A) for A in (1, 16, 24, 25, 32, 33, 48,
                                              49, 96)] == [
        4, 4, 4, None, None, 2, 2, None, None]
    assert [kernels.wave_layout(A, g) for A, g in (
        (16, 4), (24, 4), (40, 2), (48, 2), (20, 1), (48, 1), (80, 1),
        (100, 1))] == ['24/8', '24/8', '48/16', '48/16', '32/32', '64/32',
                       '96/32', '128/32']


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

def _walk_host(fn, bits, ci, cj, vf, hf):
    """The host-built pdp_walk on CPU tensors; the output starts as junk,
    so a lane the kernel does not write shows."""
    B = bits.shape[1]
    out = torch.full((B, kernels.WALK_OUTS), -7, dtype=torch.int32)
    rc = fn(bits.data_ptr(), ci.data_ptr(), cj.data_ptr(), vf.data_ptr(),
            hf.data_ptr(), B, bits.shape[2], out.data_ptr(), None)
    assert rc == 0, rc
    return out


def _assert_walks_agree(fn, bits, ci, cj, vf, hf):
    """The kernel, walk_plain and the JAX walker on the same inputs:
    exact.  Returns the walk."""
    bits, ci, cj, vf, hf = (x.contiguous() for x in (bits, ci, cj, vf, hf))
    got = _walk_host(fn, bits, ci, cj, vf, hf)
    assert torch.equal(got, kernels.walk_plain(bits, ci, cj, vf, hf))
    want = np.asarray(jax_engine._traceback(
        bits.numpy(), ci.numpy(), cj.numpy(), vf.numpy() != 0,
        hf.numpy() != 0))
    assert np.array_equal(got.numpy(), want)
    return got


# Read lengths of the walk's lanes: empty, one column, the trace-bit tile's
# edges, the full window of 2,049 columns.
WALK_LENS = [0, 1, 2, T - 1, T, T + 1, 2 * T, 1000, 2047, 2048, 2049, 2049]


@pytest.mark.parametrize('scheme', SCHEMES, ids=['default', '20,-30,-5,-2'])
@pytest.mark.parametrize('A', [5, 32, 64, 80, 96, 128])
def test_walk_matches_plain_and_jax(host_kernels, A, scheme):
    """The walk on the plain forward's bits of lanes 0-2,049 columns long
    (tile edges, a pad lane of length 0 with adapter length 0, adapter
    lengths 1 and A, adapter copies to walk along)."""
    reads, rl, adps, al = dp_batch(A, len(WALK_LENS), 2049, A)
    rl[:] = WALK_LENS
    al[0], al[1], al[2], al[-1] = 0, 1, A, A
    for k in (4, 7, 8, 11):
        plant(reads, adps, al, k, int(rl[k]) - 3 * k)
    batch = to_torch(reads, rl, adps, al)
    bits, _, ci, cj, vf, hf = kernels.forward_tiled_plain(*batch, *scheme)
    walk = _assert_walks_agree(host_kernels['walk'], bits, ci, cj, vf, hf)
    assert walk[0].tolist() == [ci[0], cj[0], 0, 0, -1, -1, -1, -1, 0, 0]
    for k in (4, 7, 8, 11):              # the copies, walked base by base
        assert walk[k, 3] == al[k], k


@pytest.mark.parametrize('seed,B,L,A', [(21, 32, 90, 16), (22, 64, 150, 24),
                                        (0, 128, 120, 24), (23, 4, 24576, 32)])
def test_walk_on_jax_bits(host_kernels, seed, B, L, A):
    """The walk on the JAX forward's bits (its own tie rules and flags),
    the gap-run lanes included, and 24,576-column windows."""
    batch = gap_run_batch() if seed == 0 else dp_batch(seed, B, L, A)
    if L > 2 ** 14:                                 # a hit at the far end
        reads, rl, adps, al = batch
        rl[1] = L
        plant(reads, adps, al, 1, L - 5)
    bits, _, ci, cj, vf, hf = (torch.from_numpy(np.array(x)) for x in
                               jax_engine._forward(*batch, *SCHEME))
    _assert_walks_agree(host_kernels['walk'], bits, ci, cj,
                        vf.to(torch.uint8), hf.to(torch.uint8))


@pytest.mark.parametrize('C', [T, 2 * T])
@pytest.mark.parametrize('A', [24, 48, 80, 96, 100])  # AMAX 32, 64, 96, 128
def test_walk_on_split_bits(host_kernels, A, C):
    """The walk on the bits and elected cells of the host-built trace-bit
    kernel cut into chunks (the fold's cell_i/cell_j), which equal the
    plain forward's walk."""
    batch = split_batch(A, C)
    bits, _, ci, cj, vf, hf = call_tiled(host_kernels['forward_tiled'],
                                         batch, SCHEME, C,
                                         plan_warm(A, SCHEME))
    got = _assert_walks_agree(host_kernels['walk'], bits, ci, cj, vf, hf)
    assert torch.equal(got, kernels.walk(
        *(x for k, x in enumerate(kernels.forward_tiled_plain(*batch,
                                                              *SCHEME))
          if k != 1)))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_walk_on_random_bytes(host_kernels, seed):
    """Any bytes are a walk: random trace bytes, cells and flags, so runs
    start vertical and horizontal, cross the i == 1 and j == 1 rules and
    stop on row 0 and on column 0, and pad lanes (cell 0) stay put."""
    rng = np.random.default_rng(seed)
    A, B, L1p = 40, 300, 256
    bits = torch.from_numpy(rng.integers(0, 32, (A, B, L1p), dtype=np.uint8))
    ci = torch.from_numpy(rng.integers(0, A + 1, B).astype(np.int32))
    cj = torch.from_numpy(rng.integers(0, L1p, B).astype(np.int32))
    ci[:10] = 0
    cj[5:15] = 0
    vf = torch.from_numpy(rng.random(B) < 0.3)
    hf = torch.from_numpy(rng.random(B) < 0.3)
    walk = _assert_walks_agree(host_kernels['walk'], bits, ci, cj, vf, hf)
    inside = (ci > 0) & (cj > 0)
    assert (inside & vf).any() and (inside & ~vf & hf).any()
    assert ((walk[:, 0] == 0) & inside).any()
    assert ((walk[:, 1] == 0) & inside).any()
    assert torch.equal(walk[~inside, :2], torch.stack([ci, cj], 1)[~inside])
    assert (walk[~inside, 2] == 0).all()


def test_walk_wrapper_launches_per_shard(host_kernels, monkeypatch):
    """kernels.walk's launch path (the kernel bound by bind, the stream,
    the launch counters) on the host-built kernel: one walk launched per
    shard, each on its shard's device, never reaching walk_plain."""
    monkeypatch.setattr(kernels, '_lib', host_kernels.__getitem__)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    batch = to_torch(*dp_batch(31, 40, 300, 24))
    shards = []
    for lo, hi in ((0, 25), (25, 40)):
        out = kernels.forward_tiled_plain(*(x[lo:hi] for x in batch),
                                          *SCHEME)
        shards.append((out[0], *out[2:]))
    want = [kernels.walk_plain(*shard) for shard in shards]

    def refused(*args):
        raise AssertionError('the plain walker ran')
    monkeypatch.setattr(kernels, 'walk_plain', refused)
    monkeypatch.setattr(kernels, '_check_walk', lambda *args: True)
    kernels.reset_launches()
    got = [kernels.walk(*shard) for shard in shards]
    assert kernels.LAUNCHES['walk'] == 2
    assert kernels.DEVICE_LAUNCHES[('walk', 'cpu')] == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# The trace-bit call with its walk (pdp_forward_walk)
# ---------------------------------------------------------------------------

# Rows and columns of the walk's staging block (csrc/dp_walk.cuh
# STAGE_ROWS, STAGE_COLS).
STAGE = 64
WALK_ROUTES = ['one tile', 'unsplit', 'split']


def _route_batch(route, A):
    """Lanes for one route of pdp_forward_walk at adapter width A: 'one
    tile' (200 bp windows: L1p = TILE_T, the walk from shared memory),
    'unsplit' (700 bp, three tiles: staged from the bits the kernel wrote)
    and 'split' (split_batch's 1,300 bp lanes in 256-column chunks: the
    fold kernel walks); each with a full-width adapter copy, a pad lane
    (read and adapter length 0) and a one-base read.  Returns (batch, the
    pad lane)."""
    if route == 'split':
        reads, rl, adps, al = (x.numpy().copy() for x in split_batch(A, T))
        pad = 8                                  # read length 0 there
    else:
        L = 200 if route == 'one tile' else 700
        reads, rl, adps, al = dp_batch(80 + A, 12, L, A)
        rl[0], al[0] = L, A
        plant(reads, adps, al, 0, L - 7)
        rl[2] = 1
        pad = 1
    rl[pad] = al[pad] = 0
    return to_torch(reads, rl, adps, al), pad


def _route_split(route, A):
    return (T, plan_warm(A, SCHEME)) if route == 'split' else (None, 0)


@pytest.mark.parametrize('route', WALK_ROUTES)
@pytest.mark.parametrize('A', [16, 32, 48, 80, 96, 128])
def test_forward_walk_matches_plain_and_jax(host_kernels, A, route):
    """The walk inside the trace-bit launch, on every route and at every
    register-row count: the aggregates and cells equal forward_walk_plain
    and the JAX walker on the JAX forward's own bits; best, cells and
    flags equal pdp_forward_tiled's bit for bit, and so do the bits it
    writes, except on a one-tile launch, which leaves the bits buffer
    untouched (its walk read shared memory alone)."""
    batch, pad = _route_batch(route, A)
    chunk, warm = _route_split(route, A)
    walk, best, ci, cj, vf, hf, bits = call_walk(
        host_kernels['forward_walk'], batch, SCHEME, chunk, warm)
    for name, g, w in zip(('walk', 'best', 'cell_i', 'cell_j'),
                          (walk, best, ci, cj),
                          kernels.forward_walk_plain(*batch, *SCHEME)):
        assert torch.equal(g, w), name
    tiled = call_tiled(host_kernels['forward_tiled'], batch, SCHEME, chunk,
                       warm)
    for name, g, w in zip(('best', 'cell_i', 'cell_j', 'vflag', 'hflag'),
                          (best, ci, cj, vf != 0, hf != 0), tiled[1:]):
        assert torch.equal(g, w), name
    if route == 'one tile':
        assert (bits == 0xa5).all()
    else:
        assert tiled_diffs((bits, *tiled[1:]), tiled, batch) == []
    jbits, jbest, jci, jcj, jvf, jhf = (np.asarray(x) for x in
                                        jax_engine._forward(
                                            *(x.numpy() for x in batch),
                                            *SCHEME))
    assert np.array_equal(walk.numpy(), np.asarray(jax_engine._traceback(
        jbits, jci, jcj, jvf, jhf)))
    for g, w in ((best, jbest), (ci, jci), (cj, jcj)):
        assert np.array_equal(g.numpy(), w)
    assert walk[pad].tolist() == [0, 0, 0, 0, -1, -1, -1, -1, 0, 0]
    assert walk[0, 3] > 0                  # the copy, walked base by base


def _block_exits(bits, k, i, j, vf, hf):
    """How lane k's walk from cell (i, j) leaves the staging blocks of
    csrc/dp_walk.cuh walk_staged (16-byte loads): the set of the edges,
    'top' and 'left', that its path crosses."""
    exits = set()
    mode = (1 if vf else 2 if hf else 0) if i > 0 and j > 0 else 0
    while i > 0 and j > 0:
        r0 = max(i - STAGE, 0)
        c0 = max(((j + 16) & ~15) - STAGE, 0)
        while i > r0 and j > 0 and j >= c0:
            tv = int(bits[i - 1, k, j])
            go_diag = mode == 0 and bool(tv & kernels.B_DIAG)
            go_vert = mode == 1 or (mode == 0 and not go_diag
                                    and bool(tv & kernels.B_MAXV))
            go_hori = not go_diag and not go_vert
            mode = (1 if go_vert and i != 1 and tv & kernels.B_VEXT else
                    2 if go_hori and j != 1 and tv & kernels.B_HEXT else 0)
            i -= not go_hori
            j -= not go_vert
        if i > 0 and j > 0:
            exits |= {'top'} if i == r0 else set()
            exits |= {'left'} if j < c0 else set()
    return exits


def _block_edge_batch(A=128, L=700):
    """Lanes whose walks leave a staging block through its top edge only
    (lane 0: a 100-base adapter with 60 bases deleted, a vertical run over
    40 columns), through its left edge only (lane 1: a 40-base adapter
    with 60 bases inserted, a horizontal run) and through both (lane 2: a
    full-width adapter with 80 bases deleted and 70 inserted), on random
    reads, beside dp_batch's lanes and a pad lane.  Each copy is placed as
    (adapter slice, first read column)."""
    rng = np.random.default_rng(95)
    reads, rl, adps, al = dp_batch(95, 10, L, A)
    reads[:3] = rng.integers(0, 4, (3, L))
    adps[:3] = rng.integers(0, 4, (3, A))
    rl[:3] = L
    al[:3] = 100, 40, A
    for k, copies in enumerate(([(0, 20, 500), (80, 100, 520)],
                                [(0, 20, 500), (20, 40, 580)],
                                [(0, 20, 500), (20, 30, 590),
                                 (A - 18, A, 600)])):
        for lo, hi, col in copies:
            reads[k, col:col + hi - lo] = adps[k, lo:hi]
    rl[9] = al[9] = 0
    return to_torch(reads, rl, adps, al)


EDGE_SCHEME = (5, -6, -12, -1)     # long gap runs pay, wandering does not


@pytest.mark.parametrize('route', ['unsplit', 'split', 'standalone'])
def test_walks_cross_staging_block_edges(host_kernels, route):
    """Paths that leave a staging block through its top edge, its left
    edge and both (each shown by a model of the blocks on the plain
    forward's bits), walked by the unsplit kernel's epilogue, by the fold
    kernel of a split launch (256-column chunks) and by the standalone
    walk: each equals walk_plain."""
    batch = _block_edge_batch()
    scheme = EDGE_SCHEME
    bits, _, ci, cj, vf, hf = kernels.forward_tiled_plain(*batch, *scheme)
    exits = [_block_exits(bits, k, int(ci[k]), int(cj[k]), bool(vf[k]),
                          bool(hf[k])) for k in range(3)]
    assert exits == [{'top'}, {'left'}, {'top', 'left'}]
    want = kernels.walk_plain(bits, ci, cj, vf, hf)
    if route == 'standalone':
        got = _walk_host(host_kernels['walk'], bits, ci, cj,
                         vf.to(torch.uint8), hf.to(torch.uint8))
    else:
        chunk, warm = (T, plan_warm(128, scheme)) if route == 'split' else (
            None, 0)
        got = call_walk(host_kernels['forward_walk'], batch, scheme, chunk,
                        warm)[0]
    assert torch.equal(got, want)


def test_forward_walk_wrapper(host_kernels, monkeypatch):
    """kernels.forward_walk's launch path on the host-built kernel: one
    launch counted under its own name per call (a split call's fold runs
    inside it), the call's shape and chunks in TILED_CALLS, no standalone
    walk, never the plain version; a one-tile call allocates no trace-bit
    tensor (the launch here is handed a sentinel buffer instead of the
    wrapper's None, since a stub kernel touching a null pointer would take
    the test process down, and the buffer stays untouched)."""
    monkeypatch.setattr(kernels, '_check', lambda *args: True)
    monkeypatch.setattr(kernels, '_lib', host_kernels.__getitem__)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    L, A = 4500, 24
    reads, rl, adps, al = dp_batch(91, 3, L, A)
    rl[:] = L, 2048, 4097
    al[:] = A
    plant(reads, adps, al, 0, 2047)
    plant(reads, adps, al, 2, 4096 + A // 2)
    split = to_torch(reads, rl, adps, al)
    short = to_torch(*dp_batch(92, 20, 150, A))
    want = [kernels.forward_walk_plain(*b, *SCHEME) for b in (split, short)]

    def refused(*args):
        raise AssertionError('a plain version ran')
    monkeypatch.setattr(kernels, 'forward_walk_plain', refused)
    monkeypatch.setattr(kernels, 'walk_plain', refused)
    handed = []
    launch = kernels._launch

    def sentinel_bits(name, *args):
        *rest, outs = args
        handed.append(outs[0])
        if outs[0] is None:
            outs = (torch.full((A, 20, T), 0xa5, dtype=torch.uint8),
                    *outs[1:])
            handed.append(outs[0])
        return launch(name, *rest, outs)
    monkeypatch.setattr(kernels, '_launch', sentinel_bits)
    kernels.reset_launches()
    kernels.card_warps.cache_clear()
    try:
        got = [kernels.forward_walk(*b, *SCHEME) for b in (split, short)]
    finally:
        kernels.card_warps.cache_clear()
    assert kernels.LAUNCHES == {'forward_score': 0, 'forward_stats': 0,
                                'forward_tiled': 0, 'forward_walk': 2,
                                'walk': 0}
    assert kernels.DEVICE_LAUNCHES == {('forward_walk', 'cpu'): 2}
    assert kernels.TILED_CALLS == {(3, L, A, 3): 1, (20, 150, A, 1): 1}
    assert handed[0].shape == (A, 3, kernels.tiled_l1p(L))
    assert handed[1] is None and (handed[2] == 0xa5).all()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    kernels.reset_launches()
