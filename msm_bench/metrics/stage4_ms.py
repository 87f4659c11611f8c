"""stage4_ms: device time a MSM of stage 4 and the finish, summed over
cards: the point total (K6, two kernels) and the Horner ladders (K7)."""

KERNELS = frozenset({"k_point_total", "k_point_total_finish", "k_horner"})


def claims(op: str) -> bool:
    return op in KERNELS


def read(run):
    return run.device_ms_per_msm(claims)
