"""``python3 -m msm_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>``:
one run of one cell; the last line of standard output is its JSON result."""

import time

T0 = time.perf_counter()  # set-up is timed from here: before any import

import sys  # noqa: E402

from msm_bench.core import main  # noqa: E402

sys.exit(main(t0=T0))
