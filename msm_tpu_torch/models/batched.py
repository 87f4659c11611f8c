"""Batched MSM: many independent MSMs with one upload and one copy back —
the PyTorch port of ``msm_tpu/models/batched.py``.

The instances are padded to one size and shipped as one stacked upload;
each then runs convert and the window sums on the device, one after the
other with no host sync between them (one instance's scan already fills
the card); one Horner launch takes the B ladders, and the B results come
back in one copy. Only each instance's [S, 3, L] window sums outlive it on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.oracle.pyecc import JPoint
from msm_tpu_torch.params import DEFAULT_CONFIG, MsmConfig


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
    if not instances:
        return []
    nmax = max(len(p) for p, _ in instances)
    N = common.pad_size(nmax)
    if N > cuzk.CHUNK_MAX:
        raise NotImplementedError(f"n = {N} > {cuzk.CHUNK_MAX}: chunked MSM is not ported")
    padded = [common.pad_inputs(pts, ks, config, multiple=nmax) for pts, ks in instances]
    geom = geometry or pick_geometry(N, config.chunk_size, config.compress, config.glv)
    xb, yb, sb = (torch.from_numpy(np.stack(a)).to(device) for a in zip(*padded))
    ws = [cuzk.window_sums_from_table(common.prepare_points(config, x, y), s, config, geom)
          for x, y, s in zip(xb, yb, sb)]
    return cuzk.msm_jpoints_from_ws(ws, config)
