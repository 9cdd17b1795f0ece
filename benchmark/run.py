"""The benchmark of porechop_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

See benchmark/README.md.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pcbench.harness import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main())
