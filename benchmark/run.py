"""Run one cell of the benchmark: see ``benchmark/README.md``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import time

T_START = time.perf_counter()       # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from benchmark.harness.cli import main

    sys.exit(main(t_start=T_START))
