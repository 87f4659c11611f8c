"""The sharded MSM — the PyTorch port of ``msm_tpu/parallel/sharded.py``.

The n points and scalars are cut into D equal contiguous row ranges, one a
shard, and each shard runs stages 1-4 on its own device: a partial MSM of
a shard is an MSM, and window sums are points, so the shards' window sums
add in the group. The merge is a point-add tree over the D [S, 3, L]
results (``cuzk.tree_add_points``: kernel 1, one launch a level), not a
sum of limbs. The results are KB-size (S x 3 x L int32: 3.8 KB for BN254 at c =
16), so they are copied to the first device and merged there; one Horner
launch (kernel 7) and one copy of its rows finish the MSM.

The "mesh" is a list of ``torch.device``: by default every visible CUDA
device. A device may repeat, and D shards on one device then run in turn
(the CPU tests pass ``[torch.device("cpu")] * D``). Each shard's work is
issued in turn from this thread, with no thread per device: shards on
different cards overlap only as far as nothing in a shard's pipeline
waits for its device.

Size scaling composes with the shards: a shard above ``cuzk.CHUNK_MAX``
rows runs host-level chunks on its device, merged there by the same tree,
as the single-device path chunks (``cuzk.chunked_window_sums``). The JAX
package instead cuts the global rows into chunks of D x ``CHUNK_MAX`` and
merges their window sums in exact integers on the host; both sum the same
points, so the MSM is the same point. Its 2^20-point ``SLICE`` (a v5e VMEM
rule) is not ported.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.cuzk import tree_add_points  # noqa: F401  (the JAX module's _tree_add_points)
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.oracle.pyecc import IDENTITY, JPoint
from msm_tpu_torch.params import MsmConfig, pick_config


def default_mesh(devices=None) -> list[torch.device]:
    """The given devices as ``torch.device``s, or every visible CUDA
    device; with neither, ``RuntimeError`` (no fallback to the CPU)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices (e.g. [torch.device('cpu')] * D) to run elsewhere")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_count(devices) -> int:
    """D, the number of shards; ``ValueError`` unless a power of two."""
    d = len(devices)
    if d < 1 or d & (d - 1):
        raise ValueError(f"device count {d} must be a power of two")
    return d


def split_rows(arrays, d: int) -> list[tuple]:
    """Arrays [n, ...] (numpy or tensors; n a multiple of d) -> each
    shard's rows, as views: shard i holds rows i n/d .. (i + 1) n/d."""
    m = len(arrays[0]) // d
    return [tuple(a[i * m : (i + 1) * m] for a in arrays) for i in range(d)]


def shard_window_sums(shards, cfg: MsmConfig, geom: MsmGeometry, devices) -> list[torch.Tensor]:
    """Each shard's (x, y, scalar words) rows -> its Montgomery window sums
    [S, 3, L] on its device, issued shard after shard. Rows already on the
    device are used as they are; host rows are uploaded chunk by chunk."""
    return [cuzk.chunked_window_sums(cuzk.chunks(rows, dev), cfg, geom) for rows, dev in zip(shards, devices)]


def merge_shards(parts: list[torch.Tensor], cfg: MsmConfig, device) -> torch.Tensor:
    """The shards' window sums, copied to ``device`` and summed by the
    point-add tree (``cuzk.merge_window_sums``) -> [S, 3, L] Montgomery."""
    return cuzk.merge_window_sums([p.to(device, non_blocking=True) for p in parts], cfg)


def window_sums_of_shards(shards, cfg: MsmConfig, geom: MsmGeometry, devices) -> torch.Tensor:
    """Each shard's (x, y, scalar words) rows, on its device or on the
    host -> the MSM's Montgomery window sums [S, 3, L] on ``devices[0]``:
    shard i through stages 1-4 on ``devices[i]``, then the tree."""
    return merge_shards(shard_window_sums(shards, cfg, geom, devices), cfg, devices[0])


def sharded_window_sums(x_u16, y_u16, s_u16, cfg: MsmConfig, geom: MsmGeometry, devices) -> torch.Tensor:
    """Padded word inputs [n, 16] (host arrays or tensors; n a multiple of
    D) -> the MSM's Montgomery window sums [S, 3, L] on ``devices[0]``
    (``window_sums_of_shards`` over D equal contiguous row ranges)."""
    devices = [torch.device(d) for d in devices]
    return window_sums_of_shards(split_rows((x_u16, y_u16, s_u16), shard_count(devices)), cfg, geom, devices)


def compute_msm_sharded(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    devices=None,
    geometry: MsmGeometry | None = None,
) -> JPoint:
    """End-to-end sharded MSM -> the oracle JPoint. The inputs are padded
    to a power of two of at least 16 D rows (equal shards), each shard
    runs on its device, the tree merges on ``devices[0]``, and kernel 7
    and one copy finish there. ``geometry`` is a pass's (default: from a
    shard's rows, at most ``CHUNK_MAX``)."""
    if len(points) == 0:
        return IDENTITY
    config = config or pick_config(len(points))
    devices = default_mesh(devices)
    common.check_config(config, *devices)
    d = shard_count(devices)
    arrays = common.pad_inputs(points, scalars, config, multiple=16 * d)
    geom = geometry or pick_geometry(min(arrays[0].shape[0] // d, cuzk.CHUNK_MAX), config)
    ws = sharded_window_sums(*arrays, config, geom, devices)
    return common.std_ints_to_jpoint(*cuzk.msm_point_from_ws(ws, config), config)
