"""The benchmark's tests: the harness's files by name, the kernels'
floor, the reference against the JAX package, the control and the faults
that the check has to catch (on the CPU), and one run on a card
(`cuda` marker).  Run from the repository's root:

    python -m pytest -q benchmark/tests          # CPU
    python -m pytest -q -m cuda benchmark/tests  # on a card
"""

import os
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# Several test workers share the host's cores: one intra-op thread each,
# as OpenMP's waiting threads slow an oversubscribed host by far more.
torch.set_num_threads(1)
