"""The DP forwards of the aligner: hand-written Hopper kernels, their plain
PyTorch versions, and a launch counter per kernel.

Counterpart of porechop_tpu/ops/kernel_pallas.py.  Its six Pallas kernels
compute three functions; each function here is one CUDA kernel (csrc/),
and all three are instantiations of one wavefront body,
dp_wave_kernel<MODE, AMAX> in csrc/dp_common.cuh (design notes there):

  forward_score   _score_kernel, _score_kernel_t   best score only
  forward_stats   _stats_kernel, _stats_kernel_t   best cell + (matches,
                                                   full_len) of its path
  forward_tiled   _forward_kernel, _tiled_kernel   best cell + trace bits,
                                                   in TILE_T-column tiles

One warp per lane (one read window against one adapter) on the
anti-diagonal: thread t owns adapter rows [R t, R t + R), R = AMAX / 32,
and the row above arrives by a warp shuffle.  AMAX is 32, 64, 96 or 128,
the narrowest that covers the adapter width: the barcoded runs' adapter
rung 96 computes its 96 rows, not 128 (on an H100 SXM at 700 W,
time_kernels.py: score at 4,096 x 10,240 x 96 3.97 ms against 4.74 on
AMAX 128, stats at 512 lanes 2.64 against 3.21, and the trace-bit call
with its walk at 512 lanes 2.10 against 3.91, since on AMAX 96 the card
holds enough warps for its plan to split them).  Score and stats also run
adapter rungs 16-24 as four lanes of 8 threads a warp (AMAX 24) and rung
48 as two of 16 (AMAX 48), three rows a thread, so that those lanes
compute no padding rows; lane_group takes that layout for a launch of at
least NARROW_FROM (3/4) as many lanes as the card holds one-lane-a-warp
warps of the kernel (card_warps, from the runtime's occupancy query),
where the launch is bound by issue, and keeps one lane a warp for fewer,
whose chain of steps three rows a thread would lengthen.  On a card,
wider adapters raise.  Every kernel takes any L: a lane stops at its own
read length.  Score and stats run four warps to a block in SCAN_T-column
tiles, the trace-bit forward one lane to a block in TILE_T-column tiles
whose trace bytes are staged in shared memory; a launch of few long lanes cuts
each lane into column chunks, one warp each, after a proven warm-up, so
that it fills the card (split_plan, card_warps, csrc/dp_tiled.cu), and a
small second kernel there folds the chunks' scouts.

The walk of a trace-bit launch (counterpart of the XLA loop
porechop_tpu/ops/engine_v2._traceback_impl) folds each lane's traceback
from its elected cell into ten aggregates on the card.  forward_walk, the
trimming path's trace-bit call, walks each lane inside the launch that
elects its cell (csrc/dp_walk.cuh: one warp per lane, walking blocks of
trace bytes staged in shared memory), so that a call returns the walk in
the one or two launches of the forward, nothing waits for the host
before its harvest, and a launch of one tile writes no trace bits at all.
walk (csrc/dp_walk.cu) is the same walk over any trace bits.

A wrapper runs its plain version when the tensors it is given lie on the
CPU, launches its kernel on the CUDA device they lie on (under that
device's context and on its current stream), and raises for anything
else.  Kernels are built from the package's csrc/ with nvcc at
first use (build()) into build/kernels/ beside the package, and bound with
ctypes; a build or launch failure raises.

Semantics (ops/spec.py of the JAX package): semi-global alignment, adapter
on rows and read on columns, free end gaps, Gotoh affine gaps, SeqAn tie
rules.  The plain versions loop over adapter rows and are vectorised over
(lanes, columns), like porechop_tpu/ops/engine_v2._forward_impl, but with
the exact (unwindowed) H prefix max: results on every elected path equal
the JAX kernels'; trace bits off that path may differ from theirs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import spans
from .spec import NEG

# L + 1 bound of the JAX package's single-tile kernels.  The planner keeps
# its routing: longer rungs of the stats and score modes take the trace-bit
# forward and the walk (dispatch.AlignJobs._is_stats_rung).
MAX_L1P = 1 << 14
MAX_A = 128                # adapter rows of the widest instantiation
TILE_T = 256               # columns per tile of forward_tiled (csrc/)
SCAN_T = 1024              # columns per tile of forward_score, forward_stats
_JKEY_BITS = 32            # leftmost-max key, int64: value * 2^32 + (2^32 - 1
_JKEY = 1 << _JKEY_BITS    # - j); any column of any rung fits the low word
_PAY_G_BIAS = 1 << 14      # stats payload: mat * 2^15 + (g + 2^14)
_PAY_MAT = 1 << 15
_OKEY = 1 << 24            # earliest-opener key of the plain stats H scan

# Trace byte of a cell: H_EXT, V_EXT, DIAG, MAX_V and EQ (read base ==
# adapter base); the complementary choices (H_OPEN, V_OPEN, MAX_H) are the
# cleared states.
B_HEXT, B_VEXT, B_DIAG, B_MAXV, B_EQ = 1, 2, 4, 8, 16

# forward_tiled's column split (split_plan): the least chunk, in warm-ups.
MIN_CHUNK_WARMS = 8
PART_INTS = 5              # ints per (chunk, lane) partial scout (csrc/)

# Launches of each kernel since the counter was last reset.  A wrapper adds
# one where it launches its kernel, and nowhere else.  (While a traced CLI
# job runs, utils/spans.py also keeps a record of every entry-point call,
# the plain versions' included: _note.)
LAUNCHES = {'forward_score': 0, 'forward_stats': 0, 'forward_tiled': 0,
            'forward_walk': 0, 'walk': 0}
# The same by (kernel, device), e.g. ('forward_tiled', 'cuda:1'), reset with
# LAUNCHES.
DEVICE_LAUNCHES = collections.Counter()
# Trace-bit calls (forward_tiled and forward_walk) by (lanes, L, A, chunks
# per lane), reset with LAUNCHES.
TILED_CALLS = collections.Counter()
# Score and stats launches by (kernel, instantiation 'AMAX/LW'), reset with
# LAUNCHES.
WAVE_CALLS = collections.Counter()

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = {'forward_score': 'dp_score.cu', 'forward_stats': 'dp_stats.cu',
           'forward_tiled': 'dp_tiled.cu', 'forward_walk': 'dp_tiled.cu',
           'walk': 'dp_walk.cu'}
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def supports(scoring) -> bool:
    """The H recurrence from `pre` (csrc/dp_common.cuh) is exact for
    affine schemes with gap_open < gap_ext."""
    _, _, gap_open, gap_ext = scoring
    return gap_open < gap_ext


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DEVICE_LAUNCHES.clear()
    TILED_CALLS.clear()
    WAVE_CALLS.clear()


def warm_bound(A: int, scoring):
    """Warm-up columns D after which a chunk of forward_tiled started from
    the lower-bound boundary holds exact M, V and H (proof in
    csrc/dp_tiled.cu): D = A + 2 + ceil(A (s_hi - s_lo) / |gap_ext|), or
    None when gap_ext >= 0 gives no bound."""
    match, mismatch, _, gap_ext = scoring
    if gap_ext >= 0:
        return None
    spread = max(match, mismatch, 0) - min(match, mismatch, 0)
    return A + 2 + -(-A * spread // -gap_ext)


def split_plan(B: int, L: int, A: int, scoring, warps: int):
    """(chunk_cols, warm_cols) of a forward_tiled launch of B lanes of
    window L at adapter width A on a card that holds `warps` of the
    kernel's warps at once (card_warps): chunks of a lane's columns, one
    warp each, so that B x chunks warps fill the card in one wave, every
    chunk at least MIN_CHUNK_WARMS warm-ups long.  One chunk
    (tiled_l1p(L), 0) when B alone fills the card, when gap_ext >= 0, or
    when the window is too short to pay the warm-up."""
    one = (tiled_l1p(L), 0)
    D = warm_bound(A, scoring)
    n = warps // B
    if D is None or n < 2:
        return one
    warm = -(-D // TILE_T) * TILE_T
    chunk = max(-(-(L + 1) // (n * TILE_T)) * TILE_T, MIN_CHUNK_WARMS * warm)
    return one if chunk >= L + 1 else (chunk, warm)


def score_prefilter_coef(threshold, match, mismatch, gap_open, gap_ext):
    """The per-adapter-base score floor coefficient of the score prefilter
    (porechop_tpu/ops/kernel_pallas.py _score_kernel note): a lane can only
    reach full_pct >= threshold if its best score is >= coef * alen.
    Returns 0.0 when the bound is vacuous (threshold too low or a
    non-positive match score); callers must then skip the prefilter.  tau
    is shaved by 1e-6 to absorb the reference's 6-decimal percent round
    trip."""
    if match <= 0:
        return 0.0
    Q = max(abs(mismatch), abs(gap_open), abs(gap_ext))
    tau = threshold / 100.0 - 1e-6
    coef = (match + Q) * tau - Q
    return coef if coef > 0 else 0.0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built '
                       '(run on the CPU with device="cpu" instead)')


def build(build_dir: Path = BUILD_DIR) -> dict:
    """Compiles every kernel source that is missing or older than its
    sources, one nvcc process per source, all started together.  Returns
    {source file: ptxas register/spill report} of the sources it built;
    raises with nvcc's output if any build fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    newest_src = max(p.stat().st_mtime for p in CSRC.iterdir()
                     if p.suffix in ('.cu', '.cuh'))
    procs = {}
    for src in sorted(set(SOURCES.values())):
        lib = build_dir / (Path(src).stem + '.so')
        if lib.is_file() and lib.stat().st_mtime >= newest_src:
            continue
        tmp = lib.with_suffix('.so.tmp%d' % os.getpid())
        procs[src] = (subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, '-o', str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, proc.returncode, out))
            continue
        os.replace(tmp, lib)
        lib.with_suffix('.log').write_text(out)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return reports


@functools.cache
def _lib(name: str):
    build()
    return bind(BUILD_DIR / (Path(SOURCES[name]).stem + '.so'), name)


def bind(path, name: str):
    """The C function pdp_<name> of the shared library at path, with its
    argument types set; for forward_tiled, forward_score and
    forward_stats, with the library's occupancy query pdp_<mode>_warps(A,
    int *warps) as its attribute `warps`."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, 'pdp_' + name)
    # The forwards: reads, read_lens, adapters, adapter_lens; the ints
    # (score and stats: B, L, A, the scheme, lanes a warp); the outputs;
    # the stream.  The walk: bits, cell_i, cell_j, vflag, hflag; B, L1p;
    # the output; the stream.
    n_in, n_int, n_out = {'forward_score': (4, 8, 1),
                          'forward_stats': (4, 8, 4),
                          'forward_tiled': (4, 10, 7),
                          'forward_walk': (4, 10, 8),
                          'walk': (5, 2, 1)}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_in + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * (n_out + 1))
    fn.restype = ctypes.c_int
    query = {'forward_tiled': 'tiled', 'forward_score': 'score',
             'forward_stats': 'stats'}.get(name)
    if query:
        fn.warps = getattr(lib, 'pdp_%s_warps' % query)
        fn.warps.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.warps.restype = ctypes.c_int
    return fn


def _on(device):
    """The CUDA device context of `device` (a launch and a query run on
    the current device); none for a device that is not a card."""
    if isinstance(device, int) or getattr(device, 'type', None) == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@functools.cache
def card_warps(A: int, device_index=None, name='forward_tiled') -> int:
    """The warps of kernel `name`'s one-lane-a-warp instantiation for
    adapter width A (forward_tiled: one-warp blocks; forward_score and
    forward_stats: four-warp blocks) that card `device_index` (None: the
    current device) holds at once, as its runtime reports them (the
    occupancy at the kernel's shared memory and registers times the SMs),
    read once per kernel, adapter width and device."""
    if A > MAX_A:
        raise NotImplementedError(
            '%s: adapters longer than %d bp are not supported by the CUDA '
            'kernel' % (name, MAX_A))
    n = ctypes.c_int(0)
    with _on(device_index):
        rc = _lib(name).warps(A, ctypes.byref(n))
    if rc != 0 or n.value <= 0:
        raise RuntimeError('%s: occupancy query failed with code %d (%d '
                           'warps)' % (name, rc, n.value))
    return n.value


# The narrow layouts of forward_score and forward_stats (csrc/dp_common.cuh,
# three rows a thread): adapter widths (lo, hi], lanes a warp there, and
# the instantiation's AMAX.  Rungs 16 and 24 take four lanes of 8 threads,
# rung 48 two of 16; rung 32 has no padding rows to save.
_NARROW = ((0, 24, 4, 24), (32, 48, 2, 48))
# lane_group's threshold, a share of the card's one-lane-a-warp warps of the
# kernel: on an H100 the narrow layout won at 0.86 of them and more at
# every measured shape of both kernels and rungs (L = 150, 1,024, 10,240),
# and lost at 0.65 and less for stats at rung 24, at 0.39 and less for the
# others (time_kernels.py --layouts, PERF.md).
NARROW_FROM = 0.75


def narrow_group(A):
    """The lanes a warp of the narrow layout for adapter width A, or None
    where there is none."""
    return next((g for lo, hi, g, _ in _NARROW if lo < A <= hi), None)


def lane_group(name, B, A, device=None) -> int:
    """Lanes a warp for a forward_score or forward_stats launch of B lanes
    at adapter width A on `device` (a torch.device or index; None: the
    current one): narrow_group(A) when B is at least NARROW_FROM of the
    warps the card holds of the kernel's one-lane-a-warp instantiation
    (card_warps), else 1.  A launch of fewer lanes is bound by its chain
    of read_len + rows/R - 1 steps, which three rows a thread lengthen; one
    of more is bound by issue, where narrow lanes compute no padding
    rows."""
    narrow = narrow_group(A)
    if narrow is None:
        return 1
    warps = card_warps(A, getattr(device, 'index', device), name)
    return narrow if B >= NARROW_FROM * warps else 1


def wave_layout(A, group=1) -> str:
    """The dp_wave_kernel instantiation that a launch at adapter width A
    with `group` lanes a warp runs (csrc/dp_common.cuh launch), as
    'AMAX/LW'."""
    if group > 1:
        amax = next(a for _, _, g, a in _NARROW if g == group)
        return '%d/%d' % (amax, 32 // group)
    return '%d/32' % min(a for a in (32, 64, 96, 128) if A <= a)


def _launch(name, reads, read_lens, adapters, adapter_lens, ints, outs):
    if adapters.shape[1] > MAX_A:
        raise NotImplementedError(
            '%s: adapters longer than %d bp are not supported by the CUDA '
            'kernel' % (name, MAX_A))
    _call(name, (reads, read_lens, adapters, adapter_lens), ints, outs)


def _call(name, ins, ints, outs):
    """Launches kernel `name` on the device of ins[0], under its context
    and on its current stream, and counts the launch; raises on a non-zero
    return."""
    fn = _lib(name)
    dev = ins[0].device
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), *ints,
                *(None if o is None else o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError('%s: kernel launch failed with code %d' % (name,
                                                                      rc))
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[(name, str(dev))] += 1


def _note(name, reads, adapters, inst):
    """The launch record of an entry-point call (utils/spans.launch)."""
    spans.launch(name, reads.device, inst, reads.shape[0], reads.shape[1],
                 adapters.shape[1])


def _check(reads, read_lens, adapters, adapter_lens):
    if reads.dim() != 2:
        raise ValueError('reads must be (B, L), got %s' % (reads.shape,))
    B = reads.shape[0]
    if adapters.dim() != 2 or adapters.shape[0] != B:
        raise ValueError('adapters must be (B, A), got %s' % (adapters.shape,))
    if read_lens.shape != (B,) or adapter_lens.shape != (B,):
        raise ValueError('read_lens and adapter_lens must be (B,)')
    for t, dt in ((reads, torch.int8), (adapters, torch.int8),
                  (read_lens, torch.int32), (adapter_lens, torch.int32)):
        if t.dtype != dt:
            raise TypeError('expected %s, got %s' % (dt, t.dtype))
        if t.device != reads.device:
            raise ValueError('all inputs must lie on one device')
        if not t.is_contiguous():
            raise ValueError('inputs must be contiguous')
    if reads.device.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device %s' % reads.device)
    return reads.device.type == 'cuda'


def tiled_l1p(L: int) -> int:
    """Bitmap row width of forward_tiled: L + 1 rounded up to TILE_T."""
    return ((L + 1 + TILE_T - 1) // TILE_T) * TILE_T


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def forward_score(reads, read_lens, adapters, adapter_lens,
                  match, mismatch, gap_open, gap_ext, group=None):
    """Best semi-global score per lane: (B,) int32.  reads (B, L) int8
    codes 0..4, adapters (B, A) int8, lens (B,) int32.  group: lanes a
    warp on a card (None: lane_group's choice; a width refuses any other
    than 1, 2 up to A = 48 and 4 up to A = 24)."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        _note('forward_score', reads, adapters, 'plain')
        return forward_score_plain(reads, read_lens, adapters, adapter_lens,
                                   match, mismatch, gap_open, gap_ext)
    B, L = reads.shape
    best = torch.empty(B, dtype=torch.int32, device=reads.device)
    if B:
        _launch_wave('forward_score', reads, read_lens, adapters,
                     adapter_lens, (match, mismatch, gap_open, gap_ext),
                     group, (best,))
    return best


def forward_stats(reads, read_lens, adapters, adapter_lens,
                  match, mismatch, gap_open, gap_ext, group=None):
    """(best, cell_i, cell_j, matches, full_len), each (B,) int32, with the
    free-tail terms of full_len applied (kernel_pallas.forward_stats_*).
    group as forward_score's."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        _note('forward_stats', reads, adapters, 'plain')
        return forward_stats_plain(reads, read_lens, adapters, adapter_lens,
                                   match, mismatch, gap_open, gap_ext)
    B, L = reads.shape
    outs = tuple(torch.empty(B, dtype=torch.int32, device=reads.device)
                 for _ in range(4))
    if B:
        _launch_wave('forward_stats', reads, read_lens, adapters,
                     adapter_lens, (match, mismatch, gap_open, gap_ext),
                     group, outs)
    return _decode_stats(*outs, read_lens, adapter_lens)


def _launch_wave(name, reads, read_lens, adapters, adapter_lens, scoring,
                 group, outs):
    """A forward_score or forward_stats launch with `group` lanes a warp
    (None: lane_group's)."""
    B, L = reads.shape
    A = adapters.shape[1]
    if group is None:
        group = lane_group(name, B, A, reads.device)
    _launch(name, reads, read_lens, adapters, adapter_lens,
            (B, L, A, *scoring, group), outs)
    WAVE_CALLS[(name, wave_layout(A, group))] += 1
    _note(name, reads, adapters, wave_layout(A, group))


def forward_tiled(reads, read_lens, adapters, adapter_lens,
                  match, mismatch, gap_open, gap_ext):
    """(bits (A, B, L1p) uint8, best, cell_i, cell_j (B,) int32, vflag,
    hflag (B,) bool) for a window of any length L >= 1, L1p =
    tiled_l1p(L).  Bits are specified for rows < adapter_len and columns
    <= read_len, the region the walker reads.  The trace-bit forward of
    the JAX package (kernel_pallas.forward_pallas for short windows,
    forward_pallas_tiled for long ones) with its bits; the trimming path
    takes forward_walk.  The kernel cuts each lane into the column chunks
    of split_plan."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        _note('forward_tiled', reads, adapters, 'plain')
        return forward_tiled_plain(reads, read_lens, adapters, adapter_lens,
                                   match, mismatch, gap_open, gap_ext)
    out = _trace_bits('forward_tiled', reads, read_lens, adapters,
                      adapter_lens, (match, mismatch, gap_open, gap_ext))
    return out[:4] + tuple(f.view(torch.bool) for f in out[4:6])


WALK_OUTS = 10             # aggregates per lane of walk and forward_walk


def forward_walk(reads, read_lens, adapters, adapter_lens,
                 match, mismatch, gap_open, gap_ext):
    """(walk (B, 10) int32, best, cell_i, cell_j (B,) int32): forward_tiled
    and the walk of its bits from each lane's elected cell (the aggregates
    walk lists), in the same launches: the trace-bit kernel walks each
    lane of an unsplit launch where it elects its cell, and the fold
    kernel each lane of a split one.  A launch of one tile (L1p = TILE_T,
    every window up to 255 bp) walks from shared memory and allocates no
    trace bits.  The trimming path's one trace-bit call."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        _note('forward_walk', reads, adapters, 'plain')
        return forward_walk_plain(reads, read_lens, adapters, adapter_lens,
                                  match, mismatch, gap_open, gap_ext)
    _, best, ci, cj, _, _, walk = _trace_bits(
        'forward_walk', reads, read_lens, adapters, adapter_lens,
        (match, mismatch, gap_open, gap_ext))
    return walk, best, ci, cj


def _trace_bits(name, reads, read_lens, adapters, adapter_lens, scoring):
    """Allocates the outputs of trace-bit kernel `name` ('forward_tiled' or
    'forward_walk') on the inputs' card, cuts the lanes by split_plan and
    launches it: (bits or None, best, cell_i, cell_j, vflag, hflag, walk
    or None), the flags uint8."""
    B, L = reads.shape
    A = adapters.shape[1]
    L1p = tiled_l1p(L)
    dev = reads.device
    i32 = dict(dtype=torch.int32, device=dev)
    best, ci, cj = (torch.empty(B, **i32) for _ in range(3))
    vf, hf = (torch.empty(B, dtype=torch.uint8, device=dev)
              for _ in range(2))
    walk = (torch.empty((B, WALK_OUTS), **i32) if name == 'forward_walk'
            else None)
    # A walked launch of one tile keeps its trace bits in shared memory.
    bits = (None if walk is not None and L1p == TILE_T
            else torch.empty((A, B, L1p), dtype=torch.uint8, device=dev))
    if B:
        chunk, warm = split_plan(B, L, A, scoring, card_warps(A, dev.index))
        nch = L // chunk + 1
        part = (torch.empty((nch, B, PART_INTS), **i32) if nch > 1
                else None)
        outs = (bits, best, ci, cj, vf, hf, part)
        _launch(name, reads, read_lens, adapters, adapter_lens,
                (B, L, A, L1p, *scoring, chunk, warm),
                outs if walk is None else outs + (walk,))
        TILED_CALLS[(B, L, A, nch)] += 1
        _note(name, reads, adapters, wave_layout(A))
    # The kernel writes each flag as 0 or 1, a valid bool byte.
    return bits, best, ci, cj, vf, hf, walk


def walk(bits, cell_i, cell_j, vflag, hflag):
    """The traceback of every lane of a trace-bit launch from its elected
    cell (forward_tiled's outputs: bits (A, B, L1p) uint8, cell_i, cell_j
    (B,) int32, vflag, hflag (B,) bool or uint8), replicating SeqAn's
    GapsLeft walker (porechop_tpu/ops/engine_v2 _traceback_impl), folded
    into (B, 10) int32 aggregates: i0, j0 (the cell where the walk
    stopped), n_path, matches, rd_tmin/rd_tmax and ad_tmin/ad_tmax
    (first/last reverse-step index holding a read / adapter base, -1 when
    none), s_ar_rev (adapter bases before the last read column), s_ra_rev
    (read bases before the last adapter column).  The walk over any trace
    bits; the trimming path walks inside forward_walk.  On a card the
    launch is enqueued on the current stream and nothing waits for it, so
    the kernel trusts cell_i <= A and cell_j < L1p, as forward_tiled makes
    them: checking values on the card would wait for it."""
    if not _check_walk(bits, cell_i, cell_j, vflag, hflag):
        _note_walk(bits, 'plain')
        return walk_plain(bits, cell_i, cell_j, vflag, hflag)
    B = bits.shape[1]
    out = torch.empty((B, WALK_OUTS), dtype=torch.int32, device=bits.device)
    if B:
        _call('walk', (bits, cell_i, cell_j, vflag, hflag),
              (B, bits.shape[2]), (out,))
        _note_walk(bits, 'walk')
    return out


def _note_walk(bits, inst):
    """The launch record of a walk call: its lanes at (L1p - 1) x A, with
    no needed cells (the walk reads no lengths)."""
    A, B, L1p = bits.shape
    spans.launch('walk', bits.device, inst, B, L1p - 1, A)


def _check_walk(bits, cell_i, cell_j, vflag, hflag):
    if bits.dim() != 3:
        raise ValueError('bits must be (A, B, L1p), got %s' % (bits.shape,))
    B = bits.shape[1]
    for t, dts in ((bits, (torch.uint8,)), (cell_i, (torch.int32,)),
                   (cell_j, (torch.int32,)),
                   (vflag, (torch.bool, torch.uint8)),
                   (hflag, (torch.bool, torch.uint8))):
        if t.dtype not in dts:
            raise TypeError('expected %s, got %s' % (dts[0], t.dtype))
        if t is not bits and t.shape != (B,):
            raise ValueError('cell_i, cell_j, vflag and hflag must be (B,)')
        if t.device != bits.device:
            raise ValueError('all inputs must lie on one device')
        if not t.is_contiguous():
            raise ValueError('inputs must be contiguous')
    if bits.device.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device %s' % bits.device)
    return bits.device.type == 'cuda'


def _decode_stats(best, ci, cj, pay, read_lens, adapter_lens):
    mat = pay >> 15
    g = (pay & (_PAY_MAT - 1)) - _PAY_G_BIAS
    tail = torch.where(ci < adapter_lens, read_lens - cj,
                       torch.zeros_like(cj))
    return best, ci, cj, mat, adapter_lens + g + tail


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _plain(reads, read_lens, adapters, adapter_lens, match, mismatch,
           gap_open, gap_ext, mode, l1p=None):
    """One DP body for the plain versions (mode 'score', 'stats' or
    'bitmap', the last with bits l1p columns wide): a Python loop over
    adapter rows, each row a handful of (B, L + 1) tensor ops.  Lanes
    freeze once their adapter has ended, as in the TPU kernels."""
    B, L = reads.shape
    A = adapters.shape[1]
    L1 = L + 1
    dev = reads.device
    i32, i64 = torch.int32, torch.int64
    stats, bitmap = mode == 'stats', mode == 'bitmap'
    go, ge = gap_open, gap_ext
    rl = read_lens.to(i64)
    al = adapter_lens.to(i32)
    jcol = torch.arange(L1, dtype=i32, device=dev)
    rp = torch.full((B, L1), 4, dtype=torch.int8, device=dev)
    rp[:, 1:] = reads                       # column j holds read[j - 1]
    negs = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zeros = torch.zeros((B, 1), dtype=i32, device=dev)
    P0 = _PAY_G_BIAS

    m = torch.zeros((B, L1), dtype=i32, device=dev)
    v = torch.full((B, L1), NEG, dtype=i32, device=dev)
    h = torch.full((B, L1), NEG, dtype=i32, device=dev)
    if stats:
        pm = torch.full((B, L1), P0, dtype=i32, device=dev)
        pv = pm.clone()
        ph = pm.clone()
    if bitmap:
        bits = torch.zeros((A, B, l1p), dtype=torch.uint8, device=dev)
    tsc = torch.zeros(B, dtype=i32, device=dev)
    ti = torch.zeros(B, dtype=i32, device=dev)
    tvf = torch.zeros(B, dtype=torch.bool, device=dev)
    thf = torch.zeros(B, dtype=torch.bool, device=dev)
    tpay = torch.full((B,), P0, dtype=i32, device=dev)

    def at_len(x):
        return x.gather(1, rl[:, None])[:, 0]

    for row in range(1, A + 1):
        active = row <= al                               # (B,)
        act2 = active[:, None]
        a_code = adapters[:, row - 1:row]

        v_ext = v + ge
        v_open = m + go
        vbit = v_ext >= v_open
        nv = torch.where(vbit, v_ext, v_open)
        nv[:, 0] = NEG

        eq = rp == a_code
        eq[:, 0] = False
        sub = torch.where(eq, match, mismatch).to(i32)
        d = torch.cat([negs, m[:, :-1] + sub[:, 1:]], dim=1)
        dwin = d >= nv
        pre = torch.where(dwin, d, nv)
        pre[:, 0] = 0

        # H(j) = max over openers k < j of pre(k) + open + (j-k-1) ext, the
        # earliest opener winning ties (the longest run).
        f = pre + go - (jcol + 1) * ge
        if stats:
            key = f.to(i64) * _OKEY + (_OKEY - 1 - jcol)
            ck = torch.cummax(key, dim=1).values
            cum = (ck >> 24).to(i32)
            k_open = (_OKEY - 1) - (ck & (_OKEY - 1))      # (B, L1) int64
        else:
            cum = torch.cummax(f, dim=1).values
        nh = torch.cat([negs, cum[:, :-1] + jcol[1:] * ge], dim=1)
        nh = torch.maximum(nh, negs)
        prewin = pre >= nh
        nm = torch.where(prewin, pre, nh)
        nm[:, 0] = 0

        if stats:
            npv = torch.where(vbit, pv, pm)
            pd = torch.cat([zeros + P0, pm[:, :-1]
                            + torch.where(eq[:, 1:], _PAY_MAT, 0).to(i32)],
                           dim=1)
            ppre = torch.where(dwin, pd, npv)
            ppre[:, 0] = P0
            w = (row <= al - 1).to(i32)[:, None]
            kk = k_open[:, :-1]
            nph = torch.cat([zeros + P0, ppre.gather(1, kk)
                             + w * (jcol[1:].to(i64) - kk).to(i32)], dim=1)
            npm = torch.where(prewin, ppre, nph)
            npm[:, 0] = P0

        if bitmap:
            hbit = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                          device=dev),
                              nh[:, :-1] + ge >= nm[:, :-1] + go], dim=1)
            dbit = d >= torch.maximum(nv, nh)
            mvbit = nv >= nh
            byte = (hbit.to(torch.uint8) | (vbit.to(torch.uint8) << 1)
                    | (dbit.to(torch.uint8) << 2)
                    | (mvbit.to(torch.uint8) << 3)
                    | (eq.to(torch.uint8) << 4))
            bits[row - 1, :, :L1] = byte

        # Final-column scout: first strict max down column read_len.
        if mode == 'score':
            fold = (jcol == rl[:, None]) | ((row == al)[:, None]
                                            & (jcol < rl[:, None]))
            cand = torch.where(fold, nm, negs).amax(dim=1)
            tsc = torch.where(active, torch.maximum(tsc, cand), tsc)
        else:
            cand_m, cand_v, cand_h = at_len(nm), at_len(nv), at_len(nh)
            better = active & (cand_m > tsc)
            uv = cand_v == cand_m
            uh = ~uv & (cand_h == cand_m)
            tsc = torch.where(better, cand_m, tsc)
            ti = torch.where(better, torch.full_like(ti, row), ti)
            tvf = torch.where(better, uv, tvf)
            thf = torch.where(better, uh, thf)
            if stats:
                cand_p = torch.where(uv, at_len(npv),
                                     torch.where(uh, at_len(nph),
                                                 at_len(npm)))
                tpay = torch.where(better, cand_p, tpay)

        m = torch.where(act2, nm, m)
        v = torch.where(act2, nv, v)
        h = torch.where(act2, nh, h)
        if stats:
            pm = torch.where(act2, npm, pm)
            pv = torch.where(act2, npv, pv)
            ph = torch.where(act2, nph, ph)

    if mode == 'score':
        return tsc

    # Last-row scout: leftmost max of M over columns [0, read_len).
    j64 = jcol.to(i64)
    valid = j64[None, :] < rl[:, None]
    key = torch.where(valid, m.to(i64) * _JKEY + (_JKEY - 1 - j64),
                      torch.full_like(m, NEG, dtype=i64) * _JKEY)
    best_key = key.amax(dim=1)
    row_sc = (best_key >> _JKEY_BITS).to(i32)
    j_star = ((_JKEY - 1) - (best_key & (_JKEY - 1))).clamp(max=L)
    sel = j_star[:, None]
    row_v = v.gather(1, sel)[:, 0]
    row_h = h.gather(1, sel)[:, 0]
    row_vf = row_v == row_sc
    row_hf = ~row_vf & (row_h == row_sc)

    col_wins = tsc > row_sc
    best = torch.where(col_wins, tsc, row_sc)
    cell_i = torch.where(col_wins, ti, al)
    cell_j = torch.where(col_wins, rl.to(i32), j_star.to(i32))
    if stats:
        row_p = torch.where(row_vf, pv.gather(1, sel)[:, 0],
                            torch.where(row_hf, ph.gather(1, sel)[:, 0],
                                        pm.gather(1, sel)[:, 0]))
        return best, cell_i, cell_j, torch.where(col_wins, tpay, row_p)
    vflag = torch.where(col_wins, tvf, row_vf)
    hflag = torch.where(col_wins, thf, row_hf)
    return bits, best, cell_i, cell_j, vflag, hflag


def forward_score_plain(reads, read_lens, adapters, adapter_lens,
                        match, mismatch, gap_open, gap_ext):
    """Plain PyTorch version of forward_score."""
    return _plain(reads, read_lens, adapters, adapter_lens, match, mismatch,
                  gap_open, gap_ext, 'score')


def forward_stats_plain(reads, read_lens, adapters, adapter_lens,
                        match, mismatch, gap_open, gap_ext):
    """Plain PyTorch version of forward_stats."""
    best, ci, cj, pay = _plain(reads, read_lens, adapters, adapter_lens,
                               match, mismatch, gap_open, gap_ext, 'stats')
    return _decode_stats(best, ci, cj, pay, read_lens, adapter_lens)


def forward_tiled_plain(reads, read_lens, adapters, adapter_lens,
                        match, mismatch, gap_open, gap_ext):
    """Plain PyTorch version of forward_tiled."""
    return _plain(reads, read_lens, adapters, adapter_lens, match, mismatch,
                  gap_open, gap_ext, 'bitmap', tiled_l1p(reads.shape[1]))


def forward_walk_plain(reads, read_lens, adapters, adapter_lens,
                       match, mismatch, gap_open, gap_ext):
    """Plain PyTorch version of forward_walk: forward_tiled_plain, then
    walk_plain."""
    bits, best, ci, cj, vf, hf = forward_tiled_plain(
        reads, read_lens, adapters, adapter_lens, match, mismatch, gap_open,
        gap_ext)
    return walk_plain(bits, ci, cj, vf, hf), best, ci, cj


# Moves of every lane that walk_plain enqueues between its checks of "any
# lane still walking".
TB_UNROLL = 8


def walk_plain(bits, cell_i, cell_j, vflag, hflag):
    """Plain PyTorch version of walk: one move of every lane per step of a
    few tensor ops, TB_UNROLL steps between checks that wait for the
    device."""
    w = _PlainWalk(bits, cell_i, cell_j, vflag, hflag)
    while w.walking():
        w.steps(TB_UNROLL)
    return w.result()


class _PlainWalk:
    """walk_plain's state of one launch's lanes (tensors on its device)."""

    def __init__(self, bits, cell_i, cell_j, vflag, hflag):
        A, B, L1 = bits.shape
        dev = bits.device
        self.flat = bits.reshape(-1)
        self.lane_off = torch.arange(B, dtype=torch.int64, device=dev) * L1
        self.plane = B * L1
        self.i = cell_i.to(torch.int64)
        self.j = cell_j.to(torch.int64)
        inside = (self.i > 0) & (self.j > 0)
        zero = torch.zeros(B, dtype=torch.int64, device=dev)
        self.mode = torch.where((vflag != 0) & inside, 1,
                                torch.where((hflag != 0) & inside, 2, 0))
        self.t = zero.clone()
        self.matches = zero.clone()
        self.rd_tmin, self.rd_tmax, self.ad_tmin, self.ad_tmax = (
            zero - 1 for _ in range(4))
        self.s_ar_rev = zero.clone()
        self.s_ra_rev = zero.clone()

    def walking(self) -> bool:
        """Whether any lane is still walking (waits for the device)."""
        return bool(((self.i > 0) & (self.j > 0)).any())

    def steps(self, n):
        """Enqueues n moves of every lane; finished lanes stay put."""
        i, j, mode, t = self.i, self.j, self.mode, self.t
        matches = self.matches
        rd_tmin, rd_tmax = self.rd_tmin, self.rd_tmax
        ad_tmin, ad_tmax = self.ad_tmin, self.ad_tmax
        s_ar_rev, s_ra_rev = self.s_ar_rev, self.s_ra_rev
        for _ in range(n):
            act = (i > 0) & (j > 0)
            # Finished lanes read a harmless in-bounds cell; act masks them.
            tv = self.flat[(i - 1).clamp_min(0) * self.plane + self.lane_off
                           + j]
            hx = (tv & B_HEXT) != 0
            vx = (tv & B_VEXT) != 0
            dg = (tv & B_DIAG) != 0
            mv = (tv & B_MAXV) != 0

            disp = mode == 0
            go_diag = disp & dg
            go_vert = (mode == 1) | (disp & ~dg & mv)
            go_hori = (mode == 2) | (disp & ~dg & ~mv)
            new_mode = torch.where(go_vert & (i != 1) & vx, 1,
                                   torch.where(go_hori & (j != 1) & hx, 2,
                                               0))
            # A column holds a read base for D/H moves, an adapter base
            # for D/V moves.
            has_rd = act & (go_diag | go_hori)
            has_ad = act & (go_diag | go_vert)
            matches = matches + (act & go_diag & ((tv & B_EQ) != 0))
            first_rd = has_rd & (rd_tmin < 0)
            rd_tmin = torch.where(first_rd, t, rd_tmin)
            rd_tmax = torch.where(has_rd, t, rd_tmax)
            s_ar_rev = torch.where(first_rd, torch.where(go_diag, i - 1, i),
                                   s_ar_rev)
            first_ad = has_ad & (ad_tmin < 0)
            ad_tmin = torch.where(first_ad, t, ad_tmin)
            ad_tmax = torch.where(has_ad, t, ad_tmax)
            s_ra_rev = torch.where(first_ad, torch.where(go_diag, j - 1, j),
                                   s_ra_rev)

            i = i - (act & (go_diag | go_vert)).long()
            j = j - (act & (go_diag | go_hori)).long()
            mode = torch.where(act, new_mode, mode)
            t = t + act
        self.i, self.j, self.mode, self.t = i, j, mode, t
        self.matches = matches
        self.rd_tmin, self.rd_tmax = rd_tmin, rd_tmax
        self.ad_tmin, self.ad_tmax = ad_tmin, ad_tmax
        self.s_ar_rev, self.s_ra_rev = s_ar_rev, s_ra_rev

    def result(self):
        return torch.stack([self.i, self.j, self.t, self.matches,
                            self.rd_tmin, self.rd_tmax, self.ad_tmin,
                            self.ad_tmax, self.s_ar_rev, self.s_ra_rev],
                           dim=1).to(torch.int32)
