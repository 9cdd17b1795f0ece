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
after a warm-up).  It prints the card's name and power limit, then one
JSON line per kernel and shape.

    python3 time_kernels.py --chunks

times instead the trace-bit kernel of this checkout at chip_smoke.py's
shapes that split, cut into chunks of 4 to 16 warm-ups and into
kernels.split_plan's chunks, through the built C function (the wrapper
takes no chunk size); one JSON line per shape and chunk size, the plan's
marked.  Each forced split is checked against the wrapper's cells.
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
    if args.chunks:
        return sweep_chunks(kernels, root)
    for n, (name, spec_) in enumerate(chip_smoke.KERNELS.items()):
        kern = getattr(kernels, name)
        for m, (what, B, L, A) in enumerate(spec_['shapes']):
            x = chip_smoke._inputs(B, L, A, seed=10 * n + m)
            ms = chip_smoke._time_ms(lambda: kern(*x, *chip_smoke.SCHEME))
            print(json.dumps(dict(root=str(root), name=name, what=what,
                                  lanes=B, L=L, A=A, ms=ms)), flush=True)
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
        x = chip_smoke._inputs(B, L, A, seed=10 * n + m)
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
