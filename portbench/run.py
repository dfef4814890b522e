"""Run one cell of the benchmark once; see harness.py and README.md.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # the checkout's root, in place of this script's folder
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from portbench.harness import main
    sys.exit(main(t_start=T_START))
