"""The three DP forwards of the aligner: hand-written Hopper kernels, their
plain PyTorch versions, and a launch counter per kernel.

Counterpart of porechop_tpu/ops/kernel_pallas.py.  Its six Pallas kernels
compute three functions, and each function here is one CUDA kernel
(csrc/, design notes in csrc/dp_common.cuh):

  forward_score   _score_kernel, _score_kernel_t   best score only
  forward_stats   _stats_kernel, _stats_kernel_t   best cell + (matches,
                                                   full_len) of its path
  forward_bitmap  _forward_kernel                  best cell + trace bits

The column-tiled bitmap kernel (_tiled_kernel, L + 1 > 16,384) is not
ported yet; every function here takes L + 1 <= MAX_L1P.

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

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .spec import NEG

MAX_L1P = 1 << 14          # L + 1 bound of the JAX single-tile kernels
MAX_A = 128                # rows of the kernels' register-resident DP column
_JKEY = 1 << 20            # leftmost-max key: value * _JKEY + (_JKEY - 1 - j)
_PAY_G_BIAS = 1 << 14      # stats payload: mat * 2^15 + (g + 2^14)
_PAY_MAT = 1 << 15
_OKEY = 1 << 24            # earliest-opener key of the plain stats H scan

B_HEXT, B_VEXT, B_DIAG, B_MAXV, B_EQ = 1, 2, 4, 8, 16

# Launches of each kernel since the counter was last reset.  A wrapper adds
# one where it launches its kernel, and nowhere else.
LAUNCHES = {'forward_score': 0, 'forward_stats': 0, 'forward_bitmap': 0}

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = {'forward_score': 'dp_score.cu', 'forward_stats': 'dp_stats.cu',
           'forward_bitmap': 'dp_bitmap.cu'}
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
    lib = ctypes.CDLL(str(BUILD_DIR / (Path(SOURCES[name]).stem + '.so')))
    fn = getattr(lib, 'pdp_' + name)
    n_int, n_out = {'forward_score': (7, 1), 'forward_stats': (7, 4),
                    'forward_bitmap': (8, 6)}[name]
    # reads, read_lens, adapters, adapter_lens; the ints; the outputs; the
    # stream.
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * (n_out + 1))
    fn.restype = ctypes.c_int
    return fn


def _launch(name, reads, read_lens, adapters, adapter_lens, ints, outs):
    if adapters.shape[1] > MAX_A:
        raise NotImplementedError(
            '%s: adapters longer than %d bp are not supported by the CUDA '
            'kernel' % (name, MAX_A))
    fn = _lib(name)
    stream = torch.cuda.current_stream(reads.device).cuda_stream
    rc = fn(reads.data_ptr(), read_lens.data_ptr(), adapters.data_ptr(),
            adapter_lens.data_ptr(), *ints, *(o.data_ptr() for o in outs),
            stream)
    if rc != 0:
        raise RuntimeError('%s: kernel launch failed with code %d' % (name,
                                                                      rc))
    LAUNCHES[name] += 1


def _check(reads, read_lens, adapters, adapter_lens):
    B, L = reads.shape
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
    if L + 1 > MAX_L1P:
        raise ValueError('L + 1 = %d exceeds %d: the column-tiled kernel is '
                         'not ported' % (L + 1, MAX_L1P))
    if reads.device.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device %s' % reads.device)
    return reads.device.type == 'cuda'


def l1p_for(L: int) -> int:
    """Padded bitmap row width: L + 1 rounded up to 128 (the JAX layout)."""
    return ((L + 1 + 127) // 128) * 128


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


def forward_bitmap(reads, read_lens, adapters, adapter_lens,
                   match, mismatch, gap_open, gap_ext):
    """(bits (A, B, L1p) uint8, best, cell_i, cell_j (B,) int32, vflag,
    hflag (B,) bool), L1p = l1p_for(L).  Bits are specified for rows
    < adapter_len and columns <= read_len, the region the walker reads."""
    if not _check(reads, read_lens, adapters, adapter_lens):
        return forward_bitmap_plain(reads, read_lens, adapters,
                                    adapter_lens, match, mismatch, gap_open,
                                    gap_ext)
    B, L = reads.shape
    A = adapters.shape[1]
    L1p = l1p_for(L)
    dev = reads.device
    bits = torch.empty((A, B, L1p), dtype=torch.uint8, device=dev)
    best, ci, cj = (torch.empty(B, dtype=torch.int32, device=dev)
                    for _ in range(3))
    vf, hf = (torch.empty(B, dtype=torch.uint8, device=dev)
              for _ in range(2))
    if B:
        _launch('forward_bitmap', reads, read_lens, adapters, adapter_lens,
                (B, L, A, L1p, match, mismatch, gap_open, gap_ext),
                (bits, best, ci, cj, vf, hf))
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
           gap_open, gap_ext, mode):
    """One DP body for the three plain versions (mode 'score', 'stats' or
    'bitmap'): a Python loop over adapter rows, each row a handful of
    (B, L + 1) tensor ops.  Lanes freeze once their adapter has ended, as
    in the TPU kernels."""
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
        bits = torch.zeros((A, B, l1p_for(L)), dtype=torch.uint8, device=dev)
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
    valid = jcol[None, :].to(i64) < rl[:, None]
    key = torch.where(valid, m.to(i64) * _JKEY + (_JKEY - 1 - jcol),
                      torch.full_like(m, NEG, dtype=i64) * _JKEY)
    best_key = key.amax(dim=1)
    row_sc = (best_key >> 20).to(i32)
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


def forward_bitmap_plain(reads, read_lens, adapters, adapter_lens,
                         match, mismatch, gap_open, gap_ext):
    """Plain PyTorch version of forward_bitmap."""
    return _plain(reads, read_lens, adapters, adapter_lens, match, mismatch,
                  gap_open, gap_ext, 'bitmap')
