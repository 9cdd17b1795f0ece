"""glibc allocator tuning (the port's copy of
porechop_tpu/utils/malloc_tune.py), applied by the CLI's entry point
(cli.main: `python -m porechop_tpu_torch`, every rank of a multi-process
run) and not when the package is imported, so that a process which only
imports the library keeps glibc's defaults.

numpy allocates large buffers with mmap, which glibc unmaps on free, so
every pipeline phase faults its working set in afresh.  Raising
M_MMAP_THRESHOLD keeps large allocations on the brk heap, and raising
M_TRIM_THRESHOLD stops glibc returning the freed heap to the kernel: the
working set stays resident and is reused across phases.  The cost is a
persistently higher RSS (bounded by the peak working set, which the
streaming layer bounds); PORECHOP_TPU_NO_MALLOC_TUNE=1 opts out.

mallopt is callable at run time through ctypes, so no MALLOC_* variable
has to be set before the interpreter starts.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

# glibc malloc.h parameter numbers.
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def configure(mmap_threshold: int = 1 << 30,
              trim_threshold: int = 1 << 30) -> bool:
    """Applies the tuning once; returns True when mallopt succeeded (or
    already had), False under the opt-out or off glibc."""
    global _done
    if _done:
        return True
    if os.environ.get('PORECHOP_TPU_NO_MALLOC_TUNE'):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library('c') or 'libc.so.6',
                           use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    _done = (mallopt(M_MMAP_THRESHOLD, mmap_threshold) == 1
             and mallopt(M_TRIM_THRESHOLD, trim_threshold) == 1)
    return _done
