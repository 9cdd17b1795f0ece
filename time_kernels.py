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
    for n, (name, spec_) in enumerate(chip_smoke.KERNELS.items()):
        kern = getattr(kernels, name)
        for m, (what, B, L, A) in enumerate(spec_['shapes']):
            x = chip_smoke._inputs(B, L, A, seed=10 * n + m)
            ms = chip_smoke._time_ms(lambda: kern(*x, *chip_smoke.SCHEME))
            print(json.dumps(dict(root=str(root), name=name, what=what,
                                  lanes=B, L=L, A=A, ms=ms)), flush=True)
            del x
    return 0


if __name__ == '__main__':
    sys.exit(main())
