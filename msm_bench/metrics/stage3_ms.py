"""stage3_ms: device time a MSM of stage 3, summed over cards: the scan
(K4), the row offsets (K5, three kernels), the point add (K1: bucket-boundary
prefixes, and the merge trees of chunks and shards), and on a compressed
config the suffix products (K12), the inversion (K9) and the emission and
scan (K13), GLV modes included."""

KERNELS = frozenset({
    "k_scan", "k_scan_glv", "k_ro_totals", "k_ro_blocks", "k_ro_write", "k_point_add", "k_point_add_lanes",
    "k_pair_suffix", "k_pair_suffix_glv", "k_mont_pow", "k_emit_scan", "k_emit_scan_glv",
})


def claims(op: str) -> bool:
    return op in KERNELS


def read(run):
    return run.device_ms_per_msm(claims)
