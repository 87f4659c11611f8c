"""Launch plans of the histogram (kernel 3), row-offsets (kernel 5) and
point-total (kernel 6) kernels, pure Python: every key and bucket of the
histogram, every lane of the row offsets and every point and partial sum of
the point total is covered exactly once, and each block stays within the
shared memory a block may use and the thread limit. The index arithmetic
mirrors csrc/hist.cu, csrc/prefix.cu and csrc/point_total.cu(h). Also the
point add's choice of a warp per add (kernel 1) at the paths' batches, and
the compressed path's geometry rule at every padded size."""

import pytest

import _torch_helpers  # noqa: F401  (one torch thread per test process)
from msm_tpu_torch.models.geometry import PE3_BYTES_MAX, pe3_row_bytes, pick_geometry
from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.cuda_hist import KEYS_PER_COUNTER, HistPlan, hist_plan
from msm_tpu_torch.ops.cuda_curve import point_add_lanes
from msm_tpu_torch.ops.cuda_prefix import PointTotalPlan, RowOffsetsPlan, point_total_plan, row_offsets_plan
from msm_tpu_torch.params import BN254, MsmConfig

#: bucket counts the configs give: signed 2^(c-1) + 1 and unsigned 2^c
BUCKETS = [(1 << (c - 1)) + 1 for c in range(8, 17)] + [1 << c for c in range(8, 17)]
#: the config the plans are sized for (13-bit limbs, 8 words an element)
BN254_CFG = MsmConfig(curve=BN254)
#: the point formulas' bytes in shared memory per thread (a projective point)
POINT_BYTES = 3 * 20 * 4


def _tiling(step: int, count: int, total: int) -> list[int]:
    """Items of [0, total) covered by `count` ranges of `step`, each cut at
    total; every range must be non-empty."""
    out = []
    for i in range(count):
        lo, hi = i * step, min((i + 1) * step, total)
        assert lo < hi, (i, step, count, total)
        out.extend(range(lo, hi))
    return out


@pytest.mark.parametrize("num_buckets", BUCKETS)
def test_hist_plan_covers_keys_and_buckets_once(num_buckets):
    for groups in (1, 4, 16, 32):
        for n in (1, 2, 3, 64, 1000, 1 << 16, 1 << 20, 1 << 22):
            plan = hist_plan(groups, n, num_buckets)
            assert plan.threads <= 1024
            assert plan.smem_bytes <= _build.SMEM_PER_BLOCK
            assert _tiling(plan.bucket_tile, plan.tiles, num_buckets) == list(range(num_buckets))
            if n <= 1 << 16:
                assert _tiling(plan.key_chunk, plan.blocks_per_row, n) == list(range(n))
            else:  # the same conditions without listing every key
                assert plan.blocks_per_row * plan.key_chunk >= n
                assert (plan.blocks_per_row - 1) * plan.key_chunk < n
            if plan.blocks_per_row > 1:  # the flush stays small beside the keys
                assert plan.key_chunk >= KEYS_PER_COUNTER * plan.bucket_tile


@pytest.mark.parametrize("groups, n, num_buckets, want", [
    # plain 2^20: 16 windows of 32769 signed buckets, one 128 KiB tile,
    # eight blocks per row (one per SM)
    (16, 1 << 20, (1 << 15) + 1, HistPlan(1 << 17, 8, (1 << 15) + 1, 1)),
    # naive 2^20: 32 windows of 256 buckets, two resident blocks per SM
    (32, 1 << 20, 256, HistPlan(1 << 17, 8, 256, 1)),
    # unsigned c = 16: 65536 counters exceed a block's shared memory
    (16, 1 << 20, 1 << 16, HistPlan(1 << 18, 4, 1 << 15, 2)),
    # the edge MSM (n = 64): one block per row
    (16, 64, (1 << 12) + 1, HistPlan(64, 1, (1 << 12) + 1, 1)),
], ids=["plain", "naive", "unsigned16", "edge"])
def test_hist_plan_at_the_paths_shapes(groups, n, num_buckets, want):
    assert hist_plan(groups, n, num_buckets) == want


@pytest.mark.parametrize("log_r", range(15))
def test_row_offsets_plan_covers_every_lane_once(log_r):
    R = 1 << log_r
    for groups in (1, 4, 5, 16, 64):
        plan = row_offsets_plan(groups, R)
        k, T = plan.lanes_per_thread, plan.threads
        assert k in (1, 2, 4, 8) and k <= R and R % k == 0
        assert T <= 1024 and T * POINT_BYTES <= 48 * 1024  # static shared memory
        lanes = []
        for b in range(plan.blocks):
            starts = [(b * T + j) * k for j in range(T) if (b * T + j) * k < R]
            assert starts, "an empty block"
            for r0 in starts:
                assert r0 + k <= R
                lanes.extend(range(r0, r0 + k))
        assert lanes == list(range(R))
        # the block-offset scan: thread j owns m consecutive block totals
        m = -(-plan.blocks // plan.scan_threads)
        owned = [j * m + c for j in range(plan.scan_threads) for c in range(m) if j * m + c < plan.blocks]
        assert owned == list(range(plan.blocks)) and 1 <= plan.scan_threads <= T
        # one wave of threads, unless k is at its cap
        if k < min(8, R):
            assert groups * R // k <= _build.SMS * 256


@pytest.mark.parametrize("groups, R, want", [
    (4, 1 << 14, RowOffsetsPlan(2, 64, 64)),  # 2^20 plain, naive
    (4, 1 << 13, RowOffsetsPlan(1, 64, 64)),  # 2^16 plain
    (4, 1 << 10, RowOffsetsPlan(1, 8, 8)),  # compressed
    (4, 8, RowOffsetsPlan(1, 1, 1)),  # the n = 35 edge MSM
    # more subtasks per launch, as chip_smoke checks them on the card
    (8, 1 << 14, RowOffsetsPlan(4, 32, 32)),
    (16, 1 << 14, RowOffsetsPlan(8, 16, 16)),
], ids=["plain20", "plain16", "compressed", "edge", "k4", "k8"])
def test_row_offsets_plan_at_the_paths_shapes(groups, R, want):
    assert row_offsets_plan(groups, R) == want


def _point_total_coverage(G: int, N: int, plan: PointTotalPlan) -> None:
    """Kernel 6 over this plan sums every point of a subtask once: thread j
    of block b runs over points [j' k, min(j' k + k, N)), j' = b T + j; no
    block is empty; the finishing warp's lane l takes partials l, l + 32,
    ... of the nb; and the plan passes the entry point's check."""
    k, nb, T = plan.points_per_thread, plan.blocks, plan.threads
    assert k >= 1 and nb >= 1 and nb * T * k >= N > (nb - 1) * T * k or (N == 0 and nb == 1)
    if N <= 1 << 13:
        seen = []
        for b in range(nb):
            block = [i for j in range(b * T, (b + 1) * T) for i in range(j * k, min(j * k + k, N))]
            assert block or N == 0, "an empty block"
            seen.extend(block)
        assert seen == list(range(N))
    assert sorted(i for lane in range(32) for i in range(lane, nb, 32)) == list(range(nb))


@pytest.mark.parametrize("G, N", [(16, 1 << 15), (20, 1 << 12), (16, 512), (1, 0), (1, 1), (3, 127),
                                  (3, 129), (5, 1000), (1, 1 << 20), (64, 1 << 15)])
def test_point_total_plan_covers_every_point_once(G, N):
    plan = point_total_plan(BN254_CFG, G, N)
    _point_total_coverage(G, N, plan)
    # about one wave: the fewest points per thread that keep G N / k threads
    # within the resident ones
    resident = _build.SMS * _build.word_threads_per_sm(BN254_CFG)  # 4 blocks of 128
    k = plan.points_per_thread
    assert G * N <= k * resident and (k == 1 or G * N > (k - 1) * resident)


@pytest.mark.parametrize("G, N, want", [
    (16, 1 << 15, PointTotalPlan(8, 32)),  # 2^20 window sums: 512 blocks, one wave
    (20, 1 << 12, PointTotalPlan(2, 16)),  # 2^16 window sums: 320 blocks
    (16, 512, PointTotalPlan(1, 4)),  # the blocked tail
], ids=["plain20", "plain16", "blocked"])
def test_point_total_plan_at_the_paths_shapes(G, N, want):
    assert point_total_plan(BN254_CFG, G, N) == want


@pytest.mark.parametrize("B, lanes", [
    (32, True),  # the naive running sum's 510 serial launches
    (16, True),  # the edge MSM's boundary prefixes
    (2112, True),  # 2112 warps: one wave of 4 blocks of 128 threads per SM
    (2113, False),
    (32 * 256, False),  # bucket_accumulate (naive) and the blocked suffix ladder
    (4 * ((1 << 15) + 1), False),  # the 2^20 MSM's boundary prefixes
])
def test_point_add_takes_a_warp_per_add_for_batches_within_one_wave(B, lanes):
    assert point_add_lanes(BN254_CFG, B) is lanes


@pytest.mark.parametrize("log_n", range(4, 23))
def test_compressed_geometry_fits_every_padded_size(log_n):
    """Under compression, at every power of two from 16 to 2^22: R divides
    n, C = n / R is even and >= 2 (no pair straddles two lanes), and one
    launch's pe3 buffer (batch x n/2 rows) stays within the rule's cap. The
    plain rule is the TPU reference's, R = min(n/8, 2^14), 4 subtasks."""
    n = 1 << log_n
    geo = pick_geometry(n, MsmConfig(curve=BN254, compress=True))
    R, G = geo.num_rows, geo.subtask_batch
    assert n % R == 0 and (n // R) % 2 == 0 and n // R >= 2
    assert G >= 1 and G * (n // 2) * pe3_row_bytes(BN254_CFG) <= PE3_BYTES_MAX
    plain = pick_geometry(n, BN254_CFG)
    assert (plain.num_rows, plain.subtask_batch) == (max(1, min(n // 8, 1 << 14)), 4)
