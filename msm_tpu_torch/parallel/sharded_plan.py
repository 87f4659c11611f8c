"""The sharded serving plan — the PyTorch port of
``msm_tpu/parallel/sharded_plan.py``: the plan's point table (``models/plan``)
cut into the sharded MSM's shards (``parallel/sharded``).

    splan = msm_tpu_torch.plan_sharded(points, devices=devs)  # each device converts its shard
    xy1 = splan(scalars_1)                 # per call: the scalars only
    xy2 = splan(words)                     # u16 words [n or N, 16]
    many = splan.run_batch([ks_a, ks_b])   # B sets, one Horner launch

Each device builds its shard's table once (kernel 2, chunk by chunk above
``cuzk.CHUNK_MAX`` rows). A call packs the scalars once into the plan's
one pinned host buffer (``MsmPlan._stage``), uploads each shard's rows to
its device without waiting (``non_blocking``), runs the scalar side there
(``cuzk.window_sums_from_table``), copies the shards' KB-size window sums
to the first device and merges them by the point-add tree; one Horner
launch over the B ladders and one copy back finish the call. Nothing waits
on an upload: the copy back at the end of a call is the only wait, and it
also keeps a later call from overwriting the buffer under an upload still
in flight (the JAX plan blocks on every upload).
"""

from __future__ import annotations

import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.models.plan import MsmPlan
from msm_tpu_torch.params import MsmConfig
from msm_tpu_torch.parallel.sharded import default_mesh, merge_shards, shard_count, split_rows


class ShardedMsmPlan(MsmPlan):
    """A reusable MSM over a fixed point set, its table sharded over
    ``devices`` (a power of two of them; one may repeat). Build with
    ``msm_tpu_torch.plan_sharded``. ``tables[i]`` holds shard i's chunk
    tables on ``devices[i]``; ``slices`` a shard's chunk rows. Calls must
    not overlap: they share the plan's host buffer."""

    def __init__(
        self,
        points: list[tuple[int, int]],
        devices=None,
        config: MsmConfig | None = None,
        geometry: MsmGeometry | None = None,
        validate: bool = False,
    ):
        self.devices = default_mesh(devices)
        d = shard_count(self.devices)
        words = self._setup(points, config, validate, self.devices[0], d)
        self.shard_n = self.N // d
        self.slices = cuzk.chunk_slices(self.shard_n)
        self.geom = geometry or pick_geometry(self.slices[0].stop, self.cfg)
        self.tables = [
            [common.prepare_points(self.cfg, xd, yd) for xd, yd in cuzk.chunks(rows, dev)]
            for rows, dev in zip(split_rows(words, d), self.devices)
        ]

    def _upload(self, slot: int, rows: slice) -> torch.Tensor:
        """Rows ``rows`` of slot ``slot`` (within one shard), packed, on
        that shard's device."""
        return self._staging[slot, rows].to(self.devices[rows.start // self.shard_n], non_blocking=True)

    def window_sums(self, rows_of) -> torch.Tensor:
        """One scalar set's Montgomery window sums [S, 3, L] on
        ``devices[0]``: ``rows_of`` gives a chunk's scalar words (global
        rows -> [rows, W] on the shard's device); each shard's chunks run
        against its tables and merge on its device, then the tree."""
        parts = []
        for i, tables in enumerate(self.tables):
            lo = i * self.shard_n
            parts.append(cuzk.merge_window_sums(
                (cuzk.window_sums_from_table(t, rows_of(slice(lo + s.start, lo + s.stop)), self.cfg, self.geom)
                 for t, s in zip(tables, self.slices)),
                self.cfg))
        return merge_shards(parts, self.cfg, self.devices[0])


def plan_sharded(points, devices=None, config: MsmConfig | None = None, geometry: MsmGeometry | None = None,
                 validate: bool = False) -> ShardedMsmPlan:
    """Prepare a sharded MSM plan over a fixed point set (module
    docstring)."""
    return ShardedMsmPlan(points, devices=devices, config=config, geometry=geometry, validate=validate)
