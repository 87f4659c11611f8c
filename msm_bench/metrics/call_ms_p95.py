"""call_ms_p95: the 95th percentile (linear between order statistics) of the
wall time of every call in the window, from the call to its affine points
on the host."""

import numpy as np


def read(run):
    return float(np.percentile([(end - start) * 1e3 for start, end in run.calls], 95))
