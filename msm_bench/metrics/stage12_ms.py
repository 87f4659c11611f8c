"""stage12_ms: device time a MSM of stages 1-2, summed over cards: every
kernel that is not the program's own (PyTorch's unpack, decompose, sort,
gathers and elementwise ops) and the histogram (K3, ``k_hist``)."""

from msm_bench.trace import our_kernel


def claims(op: str) -> bool:
    return op == "k_hist" or (our_kernel(op) is None and not op.startswith(("memcpy", "memset")))


def read(run):
    return run.device_ms_per_msm(claims)
