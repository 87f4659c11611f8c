"""The cuZK MSM pipeline on PyTorch — the port of ``msm_tpu/models/cuzk.py``.

  stage 1   convert points (kernel 2) + signed scalar decomposition; under
            ``cfg.glv`` the table rows carry x, beta x and y (kernel 2's
            GLV mode) and each scalar is split first (``ops/glv``: k = k1 +
            k2 lambda), so every subtask sorts and scans 2n entries over
            half the windows, through the GLV modes of kernels 4, 12, 13
  stage 2   one unstable torch.sort of all windows' bucket keys, and the
            bucket ends from the histogram kernel (3)
  stage 3   per subtask batch: the gather + mixed-add prefix scan (4), the
            row offsets (5), the bucket-boundary prefixes (point add, 1);
            under ``cfg.compress`` the scan runs over the pair-compressed
            stream instead: suffix products (12), one Fermat inversion per
            lane (9), fused pair emission + scan (13)
  stage 4   telescoped window sums: point total (6), then one Horner
            launch (7) over the S two-point ladders for the doublings
  finish    Horner over the window sums (7); the host takes the single
            projective point out of Montgomery form in exact integers and
            maps it to affine with one inversion

On CUDA tensors every stage runs on the kernels; on CPU tensors on their
plain twins. An MSM of up to ``CHUNK_MAX`` points runs as one pass; the
reference's 2^20-point slicing and host-level chunking above 2^22 are not
ported.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.models import common
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.ops.cuda_prefix import horner
from msm_tpu_torch.ops.curve import get_curve_ctx
from msm_tpu_torch.ops.decompose import decompose_signed
from msm_tpu_torch.ops.glv import decompose_signed_glv
from msm_tpu_torch.ops.scan import bucket_boundary_prefix, window_sum_from_pe
from msm_tpu_torch.oracle.pyecc import IDENTITY, JPoint
from msm_tpu_torch.params import MsmConfig, pick_config

#: largest MSM run as one pass
CHUNK_MAX = 1 << 22


def decompose_scalars(s_u16: torch.Tensor, cfg: MsmConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Scalar words [n, 16] -> signed-window keys and signs [S, n], under
    GLV [S, 2n] (columns n..2n-1: the phi copies)."""
    if cfg.glv:
        return decompose_signed_glv(s_u16, cfg.chunk_size, cfg.num_subtasks, cfg)
    return decompose_signed(s_u16, cfg.chunk_size, cfg.num_subtasks)


def window_sums_from_table(
    packed: torch.Tensor, s_u16: torch.Tensor, cfg: MsmConfig, geom: MsmGeometry
) -> torch.Tensor:
    """Scalar-side pipeline on a prepared point table: signed decompose,
    bucket-boundary prefixes of every subtask, telescoped reduction ->
    Montgomery window sums [S, 3, L]."""
    keys, signs = decompose_scalars(s_u16, cfg)
    return window_sums_from_keys(packed, keys, signs, cfg, geom)


def window_sums_from_keys(
    packed: torch.Tensor, keys: torch.Tensor, signs: torch.Tensor, cfg: MsmConfig,
    geom: MsmGeometry,
) -> torch.Tensor:
    """``window_sums_from_table`` after the decomposition."""
    ec = get_curve_ctx(cfg)
    pe = bucket_boundary_prefix(
        ec, packed, keys, signs, cfg.num_buckets, geom.num_rows,
        batch=min(geom.subtask_batch, cfg.num_subtasks),
    )
    w = window_sum_from_pe(ec, pe)
    return torch.stack([w.x, w.y, w.z], dim=1)


def horner_rows(ws: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """Montgomery window sums [S, 3, L], or B instances' [B, S, 3, L] ->
    each MSM's projective point as Montgomery limb rows [3, L] ([B, 3, L]),
    on the device: one Horner launch, B ladders at once."""
    return torch.stack(horner(cfg, ws[..., 0, :], ws[..., 1, :], ws[..., 2, :], cfg.chunk_size), dim=-2)


def msm_point_from_ws(ws: torch.Tensor, cfg: MsmConfig) -> tuple[int, int, int]:
    """Montgomery window sums [S, 3, L] -> ONE standard-form projective
    point (X, Y, Z) as python ints: the Horner kernel, one copy of its
    three limb rows to the host, then the export in exact integers."""
    return common.mont_rows_to_ints(horner_rows(ws, cfg).cpu().numpy(), cfg)


def msm_jpoints_from_ws(ws: list[torch.Tensor], cfg: MsmConfig) -> list[JPoint]:
    """B instances' window sums [S, 3, L] -> B oracle JPoints: one Horner
    launch over the B ladders, one copy of their [B, 3, L] rows to the
    host, the export in exact integers."""
    host = horner_rows(torch.stack(ws), cfg).cpu().numpy()
    return [common.std_ints_to_jpoint(*common.mont_rows_to_ints(r, cfg), cfg) for r in host]


def compute_msm_jpoint(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
    device="cuda",
) -> JPoint:
    """End-to-end MSM returning the oracle JPoint."""
    config = config or pick_config(len(points))
    if len(points) == 0:
        return IDENTITY
    n = common.pad_size(len(points))
    if n > CHUNK_MAX:
        raise NotImplementedError(f"n = {n} > {CHUNK_MAX}: chunked MSM is not ported")
    x_u16, y_u16, s_u16 = common.pad_inputs(points, scalars, config, validate=validate)
    geom = geometry or pick_geometry(n, config.chunk_size, config.compress, config.glv)
    xd, yd, sd = (torch.from_numpy(a).to(device) for a in (x_u16, y_u16, s_u16))
    packed = common.prepare_points(config, xd, yd)
    ws = window_sums_from_table(packed, sd, config, geom)
    return common.std_ints_to_jpoint(*msm_point_from_ws(ws, config), config)


def compute_msm(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
    device="cuda",
) -> tuple[int, int] | None:
    """End-to-end MSM: affine int points + int scalars -> affine (x, y), or
    None for the identity."""
    config = config or pick_config(len(points))
    res = compute_msm_jpoint(points, scalars, config, geometry, validate, device)
    return common.result_to_affine(res, config)
