"""The naive Pippenger MSM on PyTorch — the port of
``msm_tpu/models/naive.py``.

A fixed-window Pippenger that shares the sort/scan bucket machinery of the
cuZK model, with unsigned digits (no signed recode: 2^c buckets per window
instead of 2^(c-1)+1, no sign bits) and the serial running-sum bucket
reduction (2(B-1) batched point additions over all S windows at once).

  convert points (kernel 2); unsigned windows; one sort of all windows'
  keys and the bucket ends (histogram, 3); per subtask batch the gather +
  mixed-add prefix scan (4), the row offsets (5) and the boundary prefixes
  (point add, 1); per-bucket sums (1); the running-sum reduction (1); the
  S window sums exported to standard form on the device; the host folds
  them by Horner's rule in exact integers.

Above ``cuzk.CHUNK_MAX`` points the MSM runs as chunks, as the cuZK model
does: each chunk's Montgomery window sums are added to the others' on the
device (point add, 1) before the export. The JAX naive model has no cap;
the port's is its device-memory bound.

On CUDA tensors every step runs on the kernels, on CPU tensors on their
plain twins; either for every curve of ``params.CURVES``.
"""

from __future__ import annotations

import dataclasses

import torch

from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx
from msm_tpu_torch.ops.decompose import extract_windows
from msm_tpu_torch.ops.scan import bucket_accumulate, bucket_reduce_running
from msm_tpu_torch.oracle.pyecc import IDENTITY, JPoint
from msm_tpu_torch.params import BN254, MsmConfig

#: 8-bit unsigned windows: S = 32 windows of 256 buckets
NAIVE_CONFIG = MsmConfig(curve=BN254, chunk_size=8)


def naive_window_sums(
    packed: torch.Tensor, s_u16: torch.Tensor, cfg: MsmConfig, geom: MsmGeometry
) -> torch.Tensor:
    """Scalar-side naive pipeline on a prepared point table: unsigned
    windows, per-bucket sums of every window, running-sum reduction ->
    Montgomery window sums [S, 3, L] on the device."""
    ec = get_curve_ctx(cfg)
    S = cfg.num_subtasks
    keys = extract_windows(s_u16, cfg.chunk_size, S)  # [S, n]
    buckets = bucket_accumulate(
        ec, packed, keys, None, 1 << cfg.chunk_size, geom.num_rows,
        batch=min(geom.subtask_batch, S),
    )
    w = bucket_reduce_running(ec, buckets)
    return torch.stack([w.x, w.y, w.z], dim=1)


def naive_result(ws: torch.Tensor, cfg: MsmConfig) -> JPoint:
    """Montgomery window sums [S, 3, L] -> exported to standard form on the
    device, copied to the host once, folded by Horner's rule in exact
    integers."""
    std = common.export_points_std(get_curve_ctx(cfg), PointBatch(*ws.unbind(1)))
    return common.window_sums_to_result(std.cpu().numpy(), cfg)


def compute_msm_naive(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig = NAIVE_CONFIG,
    geometry: MsmGeometry | None = None,
    device="cuda",
) -> JPoint:
    """End-to-end naive MSM: affine int points + int scalars -> the oracle
    JPoint of the result."""
    if config.glv:  # as the JAX package's naive model asserts
        raise NotImplementedError("the naive model has no GLV mode")
    common.check_config(config, device)
    if len(points) == 0:
        return IDENTITY
    arrays = common.pad_inputs(points, scalars, config)
    # the plain path's geometry, as the JAX naive model takes it (by window
    # width alone)
    geom = geometry or pick_geometry(min(arrays[0].shape[0], cuzk.CHUNK_MAX),
                                     dataclasses.replace(config, compress=False))
    ws = cuzk.merge_window_sums(
        (naive_window_sums(common.prepare_points(config, x, y), s, config, geom)
         for x, y, s in cuzk.chunks(arrays, device)), config)
    return naive_result(ws, config)
