#!/usr/bin/env python3
"""Times the port's three DP kernels at chip_smoke.py's shapes on one NVIDIA
GPU, for the porechop_tpu_torch package of the checkout at --root (default:
this one).  Two commits are compared in one call on one card by running it
on both checkouts in turn, for example parent, change, change, parent:

    python3 time_kernels.py --root build/parent
    python3 time_kernels.py
    python3 time_kernels.py
    python3 time_kernels.py --root build/parent

The shapes and inputs are this checkout's (chip_smoke.KERNELS and
chip_smoke._inputs, same seeds), whichever package is timed, and so is
the timing (chip_smoke._time_ms: CUDA events over ~100 ms of launches
after a warm-up).  It prints the card's name and power limit, the
trace-bit kernel's resident warps by adapter width (kernels.card_warps),
then one JSON line per kernel and shape (chip_smoke.KERNELS' and, for
score and stats, RUN_SHAPES), naming the instantiation that ran
('AMAX/LW') and its lanes a warp (score and stats at adapter rungs 16-24
and 48 take 4 or 2 when kernels.lane_group says so).

    python3 time_kernels.py --layouts [--root DIR]

times the score and stats kernels (their C functions, no wrapper) in both
layouts of adapter rungs 16-24 and 48 (one lane a warp; four lanes of 8
threads, or two of 16) at chip_smoke.py's shapes of those rungs, at the
runs' own launches (RUN_SHAPES) and at a sweep of lane counts
(LAYOUT_SWEEP), beside the kernel's one-lane-a-warp warps (card_warps)
and lane_group's choice: the measurements that set lane_group's
threshold.  A time under ~0.1 ms is the kernel's durations under
torch.profiler (chip_smoke._kernel_ms).

    python3 time_kernels.py --chunks

times instead the trace-bit kernel of this checkout at chip_smoke.py's
shapes that split, cut into chunks of 4 to 16 warm-ups and into
kernels.split_plan's chunks, through the built C function (the wrapper
takes no chunk size); one JSON line per shape and chunk size, the plan's
marked.  Each forced split is checked against the wrapper's cells.

    python3 time_kernels.py --walk [--root DIR]

times the trace-bit call at chip_smoke.WALK's shapes (the main path's):
forward_tiled alone, forward_tiled and then the standalone walk on its
bits, and forward_walk (the walk inside the forward's launches) where
the package has it; each by CUDA events and by its kernels' durations
under torch.profiler (chip_smoke._cupti_ms), one JSON line each.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(chip_smoke.ROOT),
                    help='checkout whose porechop_tpu_torch is timed')
    ap.add_argument('--chunks', action='store_true',
                    help='time the trace-bit kernel at forced chunk sizes')
    ap.add_argument('--walk', action='store_true',
                    help='time the trace-bit call with and without its walk')
    ap.add_argument('--layouts', action='store_true',
                    help='time score and stats in each lane layout')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('time_kernels: no CUDA device', file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from porechop_tpu_torch.ops import kernels
    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise RuntimeError('imported %s, not the package under %s'
                           % (kernels.__file__, root))
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.build()
    # The trace-bit kernel's resident warps by adapter width, which
    # split_plan divides among a launch's lanes.
    print(json.dumps(dict(root=str(root), card_warps={
        A: kernels.card_warps(A) for A in (32, 64, 96, 128)})), flush=True)
    if args.chunks:
        return sweep_chunks(kernels, root)
    if args.walk:
        return time_walks(kernels, root)
    if args.layouts:
        return time_layouts(kernels, root)
    for n, (name, spec_) in enumerate(chip_smoke.KERNELS.items()):
        kern = getattr(kernels, name)
        shapes = spec_['shapes'] + [('run', *s_)
                                    for s_ in RUN_SHAPES.get(name, ())]
        for m, (what, B, L, A) in enumerate(shapes):
            x = chip_smoke._inputs(B, L, A, seed=10 * n + m, what=what)
            ms = chip_smoke._time_ms(lambda: kern(*x, *chip_smoke.SCHEME))
            print(json.dumps(dict(root=str(root), name=name, what=what,
                                  lanes=B, L=L, A=A, ms=ms,
                                  **layout_of(kernels, name, B, A))),
                  flush=True)
            del x
    return 0


def layout_of(kernels, name, B, A):
    """The instantiation ('AMAX/LW') and lanes a warp of a launch; for a
    package without lane layouts, one lane a warp on the narrowest AMAX
    of 32, 64, 96 and 128 that covers A."""
    if not hasattr(kernels, 'lane_group'):
        return dict(layout='%d/32' % min(a for a in (32, 64, 96, 128)
                                         if A <= a), group=1)
    group = chip_smoke.layouts(kernels, name, B, A)[0]
    return dict(layout=kernels.wave_layout(A, group), group=group)


# The score and stats launches at adapter rungs 24 and 48 that the 10 kb
# and barcoded runs make at -v 0 (profile_torch.py, H100), by kernel.
RUN_SHAPES = {
    'forward_score': [(8192, 10240, 24), (16384, 10240, 24),
                      (8192, 10240, 48), (32768, 150, 48),
                      (1048576, 150, 24)],
    'forward_stats': [(32, 10240, 48), (512, 10240, 24), (1024, 10240, 24),
                      (8192, 150, 24), (16384, 150, 48), (32768, 150, 48),
                      (1048576, 150, 24)]}
# (lanes, L, A) swept by --layouts: detection windows, 1 kb rounds and 10 kb
# rounds at both rungs, from few lanes to many.
LAYOUT_SWEEP = ([(B, L, A) for L in (150, 1024) for A in (24, 48)
                 for B in (1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384,
                           65536)]
                + [(B, 10240, A) for A in (24, 48)
                   for B in (2048, 4096, 6144, 8192, 12288)])


def raw_call(kernels, name, x, group):
    """A call of kernel `name`'s C function on inputs x with `group` lanes a
    warp, into outputs allocated once: the kernel alone."""
    fn = kernels._lib(name)
    B, L = x[0].shape
    outs = [torch.empty(B, dtype=torch.int32, device=x[0].device)
            for _ in range(1 if name == 'forward_score' else 4)]
    ints = (B, L, x[2].shape[1], *chip_smoke.SCHEME, group)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*(t.data_ptr() for t in x), *ints,
                *(o.data_ptr() for o in outs), stream)
        if rc != 0:
            raise RuntimeError('%s: launch failed with code %d' % (name, rc))
    return call


def time_layouts(kernels, root):
    """Score and stats in both layouts at chip_smoke.py's shapes of adapter
    rungs 16-24 and 48, at RUN_SHAPES and at LAYOUT_SWEEP."""
    for n, name in enumerate(('forward_score', 'forward_stats')):
        shapes = [s_ for s_ in chip_smoke.KERNELS[name]['shapes']
                  if kernels.narrow_group(s_[3])]
        shapes += [('run', *s_) for s_ in RUN_SHAPES[name]]
        shapes += [('sweep', *s_) for s_ in LAYOUT_SWEEP]
        for m, (what, B, L, A) in enumerate(shapes):
            x = chip_smoke._inputs(B, L, A, seed=500 + 100 * n + m,
                                   what=what)
            rule, allowed = chip_smoke.layouts(kernels, name, B, A)
            for g in allowed:
                ms, ms_events, timing = chip_smoke._kernel_ms(
                    raw_call(kernels, name, x, g))
                print(json.dumps(dict(
                    root=str(root), name=name, what=what, lanes=B, L=L, A=A,
                    group=g, layout=kernels.wave_layout(A, g), ms=ms,
                    ms_events=ms_events, timing=timing, rule=rule,
                    card_warps=kernels.card_warps(A, None, name))),
                    flush=True)
            del x
    return 0


def time_walks(kernels, root):
    """forward_tiled, forward_tiled + walk and forward_walk at each of
    chip_smoke.WALK's shapes, with chip_smoke.check_trace_bits' inputs."""
    scheme = chip_smoke.SCHEME
    for m, (what, B, L, A) in enumerate(chip_smoke.WALK['shapes']):
        x = chip_smoke._inputs(B, L, A, seed=200 + m, what=what)

        def tiled_walk():
            bits, _, ci, cj, vf, hf = kernels.forward_tiled(*x, *scheme)
            return kernels.walk(bits, ci, cj, vf, hf)
        calls = {'forward_tiled': lambda: kernels.forward_tiled(*x, *scheme),
                 'forward_tiled + walk': tiled_walk}
        if hasattr(kernels, 'forward_walk'):
            calls['forward_walk'] = lambda: kernels.forward_walk(*x, *scheme)
        for name, fn in calls.items():
            print(json.dumps(dict(root=str(root), name=name, what=what,
                                  lanes=B, L=L, A=A,
                                  ms=chip_smoke._time_ms(fn),
                                  cupti_ms=chip_smoke._cupti_ms(fn))),
                  flush=True)
        del x
    return 0


def sweep_chunks(kernels, root):
    """The trace-bit kernel at each chip_smoke.py shape that the plan
    splits, with chunks of 4, 6, 8, 12 and 16 warm-ups and the plan's."""
    n = list(chip_smoke.KERNELS).index('forward_tiled')
    fn = kernels._lib('forward_tiled')
    scheme = chip_smoke.SCHEME
    stream = torch.cuda.current_stream().cuda_stream
    for m, (what, B, L, A) in enumerate(
            chip_smoke.KERNELS['forward_tiled']['shapes']):
        warps = kernels.card_warps(A)
        plan, warm = kernels.split_plan(B, L, A, scheme, warps)
        if warm == 0:
            continue
        x = chip_smoke._inputs(B, L, A, seed=10 * n + m, what=what)
        want = kernels.forward_tiled(*x, *scheme)
        for chunk in sorted({k * warm for k in (4, 6, 8, 12, 16)} | {plan}):
            nch = L // chunk + 1
            outs = [torch.empty_like(w, dtype=w.dtype if w.dtype != torch.bool
                                     else torch.uint8) for w in want]
            part = (torch.empty((nch, B, kernels.PART_INTS), dtype=torch.int32,
                                device='cuda') if nch > 1 else None)
            ptrs = [o.data_ptr() for o in outs] + [
                None if part is None else part.data_ptr()]
            ints = (B, L, A, kernels.tiled_l1p(L), *scheme, chunk, warm)

            def call():
                rc = fn(*(t.data_ptr() for t in x), *ints, *ptrs, stream)
                if rc != 0:
                    raise RuntimeError('launch failed with code %d' % rc)

            call()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(outs[1:4],
                                                          want[1:4])):
                raise AssertionError('%s: chunks of %d disagree with the '
                                     'wrapper' % (what, chunk))
            ms = chip_smoke._time_ms(call)
            print(json.dumps(dict(root=str(root), name='forward_tiled',
                                  what=what, lanes=B, L=L, A=A, chunk=chunk,
                                  warm=warm, chunks=nch, warps=B * nch,
                                  card_warps=warps, plan=chunk == plan,
                                  ms=ms)), flush=True)
            del outs, part
        del x, want
    return 0


if __name__ == '__main__':
    sys.exit(main())
