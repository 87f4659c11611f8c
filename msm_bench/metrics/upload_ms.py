"""upload_ms: device time of the host-to-device copies a MSM (the serving
plan's scalar upload from its pinned buffer), summed over cards."""


def claims(op: str) -> bool:
    return op == "memcpy HtoD"


def read(run):
    return run.device_ms_per_msm(claims)
