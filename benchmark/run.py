"""The benchmark's command: python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>.  See benchmark/harness.py and
benchmark/README.md."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The repository's root, in place of this folder: the package `benchmark`
# is imported whole, and none of its modules shadows a library's.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
