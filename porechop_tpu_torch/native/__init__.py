"""The port's host engine (counterpart of porechop_tpu/native/__init__.py):
for the Gotoh schemes the CUDA kernels refuse, and for every Gotoh job
under PORECHOP_TPU_FORCE_HOST (the planner's host route, ops/dispatch.py).

The kernels take only gap_open < gap_ext (ops/kernels.supports).  SeqAn
aligns every scheme with gap_open != gap_ext under Gotoh's affine profile,
and the JAX package runs the ones its device engines refuse on a native C++
engine; so does the port, from its own copies of the JAX package's sources:

  align_host.cpp  scalar DP, one job per thread      align_host_batch
  align_simd.cpp  many jobs per vector, in lockstep  align_simd_batch,
                                                     align_simd_scores
  traceback.cpp   SeqAn's GapsLeft walk over the trace bits and the
                  statistics of the reference's alignment.cpp

All three entry points take the same arguments and fill a (P, 9) int64 row
per job (align_host.cpp); align_simd_scores skips the trace bits and the
walk, so only column 4 (best score) and the degenerate marker (column 0 ==
-1) are meaningful.  This is host code: nothing of it goes to the card.

The library builds with g++ at first use into build/native/ beside the
package, named by a digest of the sources and the host CPU (it is built
with -march=native), through a per-process temporary file and os.replace
so that concurrent processes never collide.  Without g++, or when the
build fails, it raises and names the scheme.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
SOURCES = ('traceback.cpp', 'align_host.cpp', 'align_simd.cpp')
ENTRY_POINTS = ('align_host_batch', 'align_simd_batch', 'align_simd_scores')
FIELDS = ('read_start', 'read_end', 'adapter_start', 'adapter_end',
          'raw_score', 'matches', 'aligned_len', 'full_len')

_LIB = None


def _host_key() -> bytes:
    """What -march=native compiles for: the machine and its CPU flags."""
    key = platform.machine().encode()
    try:
        with open('/proc/cpuinfo', 'rb') as f:
            key += b''.join(ln for ln in f if ln.startswith(b'flags'))[:4096]
    except OSError:
        pass
    return key


def build(scoring=None) -> Path:
    """The engine's shared library in BUILD_DIR, built with g++ unless it
    is there.  Raises (naming `scoring` when given) without g++ or when
    g++ fails."""
    h = hashlib.sha256(_host_key())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    lib = BUILD_DIR / ('core-%s.so' % h.hexdigest()[:16])
    if lib.is_file():
        return lib
    what = ('scoring scheme %s runs on the native host engine, but '
            % (tuple(scoring),) if scoring is not None else '')
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError(what + 'g++ was not found to build it '
                           '(porechop_tpu_torch/native/*.cpp)')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name('%s.tmp%d' % (lib.name, os.getpid()))
    cmd = [gxx, '-O3', '-std=c++17', '-shared', '-fPIC', '-pthread',
           '-march=native', *(str(SRC_DIR / s) for s in SOURCES),
           '-o', str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        # Some toolchains reject -march=native.
        cmd.remove('-march=native')
        r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(what + 'g++ failed to build it:\n' + r.stderr)
    os.replace(tmp, lib)
    return lib


def library(scoring=None):
    """The loaded engine (built on first use), with its argument types
    set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(scoring)))
        i8p = ctypes.POINTER(ctypes.c_int8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [i8p, i64p, i8p, i64p, i64p, i64p, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int64, i64p]
            fn.restype = None
        _LIB = lib
    return _LIB


def _concat(seqs):
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    buf = np.empty(int(off[-1]), dtype=np.int8)
    for k, s in enumerate(seqs):
        buf[off[k]:off[k + 1]] = s
    return buf, off


def threads() -> int:
    """The engine's default thread count: one per core, at most 16."""
    return min(os.cpu_count() or 1, 16)


def align_batch(windows, adapters, pairs, scoring,
                entry='align_simd_batch', n_threads=None) -> np.ndarray:
    """Aligns every (window, adapter) pair of `pairs` (P, 2) through the
    C entry point `entry` (ENTRY_POINTS) on n_threads host threads
    (default threads()).  windows/adapters: lists of np.int8 Dna5 codes.
    Returns the (P, 9) int64 rows (columns: FIELDS, then a reserved
    one)."""
    match, mismatch, gap_open, gap_ext = (int(x) for x in scoring)
    if gap_open == gap_ext:
        raise ValueError('scoring scheme %s is linear: the native engine '
                         'runs only Gotoh schemes (ops/spec.align_linear '
                         'runs linear ones)' % (tuple(scoring),))
    if entry not in ENTRY_POINTS:
        raise ValueError('unknown entry point %r' % (entry,))
    fn = getattr(library(scoring), entry)
    rbuf, roff = _concat(windows)
    abuf, aoff = _concat(adapters)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if len(pairs) and (pairs.min() < 0 or pairs[:, 0].max() >= len(windows)
                       or pairs[:, 1].max() >= len(adapters)):
        raise IndexError('a pair names a window or adapter that is not '
                         'there')
    pr = np.ascontiguousarray(pairs[:, 0])
    pa = np.ascontiguousarray(pairs[:, 1])
    out = np.zeros((len(pairs), 9), dtype=np.int64)
    n_threads = threads() if n_threads is None else int(n_threads)
    if n_threads < 1:
        raise ValueError('n_threads must be at least 1')

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    fn(p(rbuf, ctypes.c_int8), p(roff, ctypes.c_int64),
       p(abuf, ctypes.c_int8), p(aoff, ctypes.c_int64),
       p(pr, ctypes.c_int64), p(pa, ctypes.c_int64), len(pairs),
       match, mismatch, gap_open, gap_ext, n_threads,
       p(out, ctypes.c_int64))
    return out
