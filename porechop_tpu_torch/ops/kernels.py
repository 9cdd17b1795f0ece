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
anti-diagonal: thread t owns adapter rows [R t, R t + R), R = AMAX / 32
(AMAX 32, 64 or 128 by the adapter width), and the row above arrives by a
warp shuffle.  Every kernel takes any L: a lane stops at its own read
length.  Score and stats run four lanes to a block in SCAN_T-column tiles,
the trace-bit forward one lane to a block in TILE_T-column tiles whose
trace bytes are staged in shared memory; a launch of few long lanes cuts
each lane into column chunks, one warp each, after a proven warm-up, so
that it fills the card (split_plan, card_warps, csrc/dp_tiled.cu), and a
small second kernel there folds the chunks' scouts.

A wrapper runs its plain version when the tensors it is given lie on the
CPU, launches its kernel when they lie on a CUDA device, and raises for
anything else.  Kernels are built from the package's csrc/ with nvcc at
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
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

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

B_HEXT, B_VEXT, B_DIAG, B_MAXV, B_EQ = 1, 2, 4, 8, 16

# forward_tiled's column split (split_plan): the least chunk, in warm-ups.
MIN_CHUNK_WARMS = 8
PART_INTS = 5              # ints per (chunk, lane) partial scout (csrc/)

# Launches of each kernel since the counter was last reset.  A wrapper adds
# one where it launches its kernel, and nowhere else.
LAUNCHES = {'forward_score': 0, 'forward_stats': 0, 'forward_tiled': 0}
# forward_tiled launches by (lanes, L, A, chunks per lane), reset with
# LAUNCHES.
TILED_CALLS = collections.Counter()

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = {'forward_score': 'dp_score.cu', 'forward_stats': 'dp_stats.cu',
           'forward_tiled': 'dp_tiled.cu'}
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
    TILED_CALLS.clear()


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
    {kernel name: ptxas register/spill report} of the sources it built;
    raises with nvcc's output if any build fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    newest_src = max(p.stat().st_mtime for p in CSRC.iterdir()
                     if p.suffix in ('.cu', '.cuh'))
    procs = {}
    for name, src in SOURCES.items():
        lib = build_dir / (Path(src).stem + '.so')
        if lib.is_file() and lib.stat().st_mtime >= newest_src:
            continue
        tmp = lib.with_suffix('.so.tmp%d' % os.getpid())
        procs[name] = (subprocess.Popen(
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
    argument types set; for forward_tiled, with the library's
    pdp_tiled_warps(A, int *warps) as its attribute `warps`."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, 'pdp_' + name)
    n_int, n_out = {'forward_score': (7, 1), 'forward_stats': (7, 4),
                    'forward_tiled': (10, 7)}[name]
    # reads, read_lens, adapters, adapter_lens; the ints; the outputs; the
    # stream.
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * (n_out + 1))
    fn.restype = ctypes.c_int
    if name == 'forward_tiled':
        fn.warps = lib.pdp_tiled_warps
        fn.warps.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.warps.restype = ctypes.c_int
    return fn


@functools.cache
def card_warps(A: int, device_index=None) -> int:
    """The one-warp blocks of forward_tiled's kernel for adapter width A
    that the card holds at once, as its runtime reports them (the
    occupancy at the kernel's shared memory times the SMs), read once per
    adapter width and device.  The kernels run on the current device."""
    if A > MAX_A:
        raise NotImplementedError(
            'forward_tiled: adapters longer than %d bp are not supported by '
            'the CUDA kernel' % MAX_A)
    n = ctypes.c_int(0)
    rc = _lib('forward_tiled').warps(A, ctypes.byref(n))
    if rc != 0 or n.value <= 0:
        raise RuntimeError('forward_tiled: occupancy query failed with code '
                           '%d (%d warps)' % (rc, n.value))
    return n.value


def _launch(name, reads, read_lens, adapters, adapter_lens, ints, outs):
    if adapters.shape[1] > MAX_A:
        raise NotImplementedError(
            '%s: adapters longer than %d bp are not supported by the CUDA '
            'kernel' % (name, MAX_A))
    fn = _lib(name)
    stream = torch.cuda.current_stream(reads.device).cuda_stream
    rc = fn(reads.data_ptr(), read_lens.data_ptr(), adapters.data_ptr(),
            adapter_lens.data_ptr(), *ints,
            *(None if o is None else o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError('%s: kernel launch failed with code %d' % (name,
                                                                      rc))
    LAUNCHES[name] += 1


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
                  match, mismatch, gap_open, gap_ext):
    """Best semi-global score per lane: (B,) int32.  reads (B, L) int8
    codes 0..4, adapters (B, A) int8, lens (B,) int32."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        return forward_score_plain(reads, read_lens, adapters, adapter_lens,
                                   match, mismatch, gap_open, gap_ext)
    B, L = reads.shape
    best = torch.empty(B, dtype=torch.int32, device=reads.device)
    if B:
        _launch('forward_score', reads, read_lens, adapters, adapter_lens,
                (B, L, adapters.shape[1], match, mismatch, gap_open,
                 gap_ext), (best,))
    return best


def forward_stats(reads, read_lens, adapters, adapter_lens,
                  match, mismatch, gap_open, gap_ext):
    """(best, cell_i, cell_j, matches, full_len), each (B,) int32, with the
    free-tail terms of full_len applied (kernel_pallas.forward_stats_*)."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        return forward_stats_plain(reads, read_lens, adapters, adapter_lens,
                                   match, mismatch, gap_open, gap_ext)
    B, L = reads.shape
    outs = tuple(torch.empty(B, dtype=torch.int32, device=reads.device)
                 for _ in range(4))
    if B:
        _launch('forward_stats', reads, read_lens, adapters, adapter_lens,
                (B, L, adapters.shape[1], match, mismatch, gap_open,
                 gap_ext), outs)
    return _decode_stats(*outs, read_lens, adapter_lens)


def forward_tiled(reads, read_lens, adapters, adapter_lens,
                  match, mismatch, gap_open, gap_ext):
    """(bits (A, B, L1p) uint8, best, cell_i, cell_j (B,) int32, vflag,
    hflag (B,) bool) for a window of any length L >= 1, L1p =
    tiled_l1p(L).  Bits are specified for rows < adapter_len and columns
    <= read_len, the region the walker reads.  Every trace-bit forward of
    the port, short windows (kernel_pallas.forward_pallas) and long
    (forward_pallas_tiled) alike.  The kernel cuts each lane into the
    column chunks of split_plan."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        return forward_tiled_plain(reads, read_lens, adapters, adapter_lens,
                                   match, mismatch, gap_open, gap_ext)
    B, L = reads.shape
    A = adapters.shape[1]
    L1p = tiled_l1p(L)
    dev = reads.device
    bits = torch.empty((A, B, L1p), dtype=torch.uint8, device=dev)
    best, ci, cj = (torch.empty(B, dtype=torch.int32, device=dev)
                    for _ in range(3))
    vf, hf = (torch.empty(B, dtype=torch.uint8, device=dev)
              for _ in range(2))
    if B:
        chunk, warm = split_plan(B, L, A, (match, mismatch, gap_open,
                                           gap_ext), card_warps(A, dev.index))
        nch = L // chunk + 1
        part = (torch.empty((nch, B, PART_INTS), dtype=torch.int32,
                            device=dev) if nch > 1 else None)
        _launch('forward_tiled', reads, read_lens, adapters, adapter_lens,
                (B, L, A, L1p, match, mismatch, gap_open, gap_ext, chunk,
                 warm), (bits, best, ci, cj, vf, hf, part))
        TILED_CALLS[(B, L, A, nch)] += 1
    return bits, best, ci, cj, vf != 0, hf != 0


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
