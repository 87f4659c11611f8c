"""The sharded MSM over several devices, its serving plan, and several
processes on ``torch.distributed`` (``multihost``): the point-add tree of
kernel 1 merges the shards' window sums."""

from msm_tpu_torch.parallel.multihost import init_multihost, run_msm_multihost
from msm_tpu_torch.parallel.sharded import compute_msm_sharded, default_mesh, sharded_window_sums
from msm_tpu_torch.parallel.sharded_plan import ShardedMsmPlan, plan_sharded

__all__ = [
    "ShardedMsmPlan",
    "compute_msm_sharded",
    "default_mesh",
    "init_multihost",
    "plan_sharded",
    "run_msm_multihost",
    "sharded_window_sums",
]
