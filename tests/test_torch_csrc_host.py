"""The CUDA sources of the PyTorch port (porechop_tpu_torch/csrc/*.cu), built
with g++ for the CPU and held against the kernels' plain versions.

A small stub header stands in for the CUDA runtime: one std::thread per CUDA
thread of a block, blocks run one after another, __shfl_*_sync,
__reduce_max_sync and __syncwarp as std::barrier exchanges among a warp's 32
threads, `extern __shared__` as a buffer per block (filled with junk, so a
read of a byte the kernel never staged shows), the DPX intrinsics in plain
C++, and `k<<<grid, block, smem, stream>>>(args)` rewritten into a host
launch.  The exported pdp_forward_* functions are then called through
ctypes on CPU pointers, bound as ops/kernels.py binds them on the card.

What it shows: the kernels' arithmetic, tie rules, tile edges, scouts and
warp exchanges equal the plain versions on the outputs the walker reads.
What it cannot show: every barrier runs the warp in lockstep, so it hides
races (a missing __syncwarp, a shared-memory hazard between warps of a
block) and anything of the card's compiler; only the card tests
(tests/test_torch_cuda.py) and chip_smoke.py show those.

Tolerance: exact; every output is an integer.
"""

import ctypes
import re
import shutil
import subprocess
import types

import pytest
import torch

from porechop_tpu_torch.ops import kernels

from .test_torch_cases import (H100_WARPS, SCHEME, call_tiled, dp_batch,
                               one_torch_thread, plan_warm, plant,
                               split_batch, tiled_diffs, to_torch)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

STUB = r'''
#pragma once
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
// shared memory per SM with 1 KB reserved per block, at most 32 blocks.
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
    int* n, F, int, size_t smem) {
  const int by_smem = (int)(228 * 1024 / (smem + 1024));
  *n = by_smem < 32 ? by_smem : 32;
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

inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int lane = threadIdx.x % 32;
  const int* buf = stub::exchange(v);
  return lane >= (int)d ? buf[lane - (int)d] : v;
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  return stub::exchange(v)[(threadIdx.x % 32) ^ m];
}
inline int __shfl_sync(unsigned, int v, int src) {
  return stub::exchange(v)[src & 31];
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
    the stub, one g++ per source, all started together."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the CUDA sources for the CPU')
    root = tmp_path_factory.mktemp('csrc_host')
    (root / 'cuda_runtime.h').write_text(STUB)
    for src in kernels.CSRC.iterdir():
        if src.suffix in ('.cu', '.cuh'):
            (root / src.name).write_text(_host_source(src.read_text()))
    procs = {}
    for name, src in kernels.SOURCES.items():
        lib = root / (src[:-3] + '.so')
        procs[name] = (subprocess.Popen(
            [gxx, '-std=c++20', '-O1', '-pthread', '-shared', '-fPIC',
             '-I', str(root), '-x', 'c++', '-o', str(lib), str(root / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        fns[name] = kernels.bind(lib, name)
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
    _run(fns['forward_score'], batch, (B, L, A, *scheme), (score,))
    stats = [torch.empty(B, dtype=torch.int32) for _ in range(4)]
    _run(fns['forward_stats'], batch, (B, L, A, *scheme), stats)
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
@pytest.mark.parametrize('A', [5, 24, 32, 33, 48, 64, 100, 128])
def test_csrc_matches_plain(host_kernels, A, scheme):
    """All three kernels at every register-row count (AMAX 32, 64, 128 and
    the edges between them), with lanes of read length 0 and adapter length
    1 and a lane whose adapter fills A."""
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
@pytest.mark.parametrize('A', [24, 48, 100])         # AMAX 32, 64 and 128
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


@pytest.mark.parametrize('A', [24, 48, 100])        # AMAX 32, 64 and 128
def test_tiled_warps_queries_each_instantiation(host_kernels, A):
    """pdp_tiled_warps asks the runtime's occupancy query for the
    instantiation that serves A, with its shared memory: the stub's
    H100-like card answers what an H100 does."""
    n = ctypes.c_int(0)
    assert host_kernels['forward_tiled'].warps(A, ctypes.byref(n)) == 0
    assert n.value == H100_WARPS[{24: 32, 48: 64, 100: 128}[A]]


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
