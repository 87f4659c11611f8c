"""Batched MSM: many independent MSMs with one copy back — the PyTorch
port of ``msm_tpu/models/batched.py``.

The instances are padded to one size; each then runs convert and the
window sums on the device (``batched_window_sums``), one after the other
with no host sync between them (one instance's scan already fills the
card); one Horner launch takes the B ladders, and the B results come back
in one copy. Only each instance's [S, 3, L] window sums outlive it on the
device. Host inputs are uploaded one instance's chunk at a time, so device
memory holds one pass's inputs whatever B and n. Instances above
``cuzk.CHUNK_MAX`` points run as chunks, merged as ``cuzk`` merges them.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.oracle.pyecc import JPoint
from msm_tpu_torch.params import DEFAULT_CONFIG, MsmConfig


def batched_window_sums(xb, yb, sb, cfg: MsmConfig, geom: MsmGeometry, device=None) -> torch.Tensor:
    """B instances' word inputs [B, n, 16] -> their Montgomery window
    sums [B, S, 3, L] on the device: K2 and the window sums of each
    instance, chunk by chunk above ``CHUNK_MAX``. The inputs are tensors on
    the device, or host arrays (or B arrays each) that each pass uploads
    to ``device``."""
    if device is None:
        if not isinstance(xb, torch.Tensor):
            raise TypeError("host inputs need an explicit device")
        device = xb.device
    return torch.stack([cuzk.chunked_window_sums(cuzk.chunks(inst, device), cfg, geom)
                        for inst in zip(xb, yb, sb)])


def compute_msm_batched(
    instances: list[tuple[list[tuple[int, int]], list[int]]],
    config: MsmConfig = DEFAULT_CONFIG,
    geometry: MsmGeometry | None = None,
    device="cuda",
) -> list[JPoint]:
    """Compute many independent MSMs. ``instances``: (points, scalars)
    pairs, padded to a common power-of-two size. Returns one oracle JPoint
    per instance. The geometry is ``compute_msm``'s for the padded size and
    the config (compress and GLV included; the JAX package's takes the
    plain rule for every config, which changes only the launch plan)."""
    common.check_config(config, device)
    if not instances:
        return []
    nmax = max(len(p) for p, _ in instances)
    padded = [common.pad_inputs(pts, ks, config, multiple=nmax) for pts, ks in instances]
    N = padded[0][0].shape[0]
    geom = geometry or pick_geometry(min(N, cuzk.CHUNK_MAX), config)
    return cuzk.msm_jpoints_from_ws(list(batched_window_sums(*zip(*padded), config, geom, device)), config)
