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
plain twins. An MSM of up to ``CHUNK_MAX`` points runs as one pass
(``cuzk_msm_point``). Above it the padded inputs run as host-level chunks
of ``CHUNK_MAX`` points, as the JAX package's ``compute_msm_jpoint`` does:
each chunk is uploaded, converted and reduced to its window sums, and since
window sums are linear in the points the chunks' sums are added on the
device by the point-add tree (``tree_add_points``: kernel 1, one launch a
level, the sharded MSM's merge too); one Horner launch and one copy
follow. One pass is the same code with one
chunk and no merge. With ``MSM_TPU_DEBUG`` set, each chunk is logged to
stderr as its pass starts. The JAX package's 2^20-point ``SLICE``
is not ported: it keeps a TPU's coordinate table in VMEM and computes the
same function.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator

import torch

from msm_tpu_torch.models import common
from msm_tpu_torch.models.geometry import MsmGeometry, pick_geometry
from msm_tpu_torch.ops.cuda_prefix import horner
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch, get_curve_ctx
from msm_tpu_torch.ops.decompose import decompose_signed
from msm_tpu_torch.ops.glv import decompose_signed_glv
from msm_tpu_torch.ops.scan import bucket_boundary_prefix, window_sum_from_pe
from msm_tpu_torch.oracle.pyecc import IDENTITY, JPoint
from msm_tpu_torch.params import MsmConfig, pick_config
from msm_tpu_torch.utils.log import debug

#: largest MSM run as one pass; above it, host-level chunks of CHUNK_MAX
#: points. One pass's peak device memory at 2^22 on an NVIDIA H100 80GB
#: HBM3 (79.18 GiB) at 700.00 W, inputs included (GiB; chip_smoke.py's
#: "one-pass peak memory at 2^22" line): plain 5.465, compressed 11.855,
#: naive 5.690, GLV 9.547, GLV compressed 11.975. 2^24 is the largest power
#: of two whose peak, scaled linearly from those, stays under 75% of the
#: card's memory in every config (GLV compressed ~47.9 GiB; ~95.8 at 2^25).
#: Read at call time, so tests can shrink it.
CHUNK_MAX = 1 << 24


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


def cuzk_window_sums(
    xd: torch.Tensor, yd: torch.Tensor, sd: torch.Tensor, cfg: MsmConfig, geom: MsmGeometry
) -> torch.Tensor:
    """One pass: coordinate and scalar words [n, 16] on the device ->
    Montgomery window sums [S, 3, L] (the convert kernel, then
    ``window_sums_from_table``)."""
    return window_sums_from_table(common.prepare_points(cfg, xd, yd), sd, cfg, geom)


def tree_add_points(ec: CurveCtx, stacked: torch.Tensor) -> torch.Tensor:
    """[D, S, 3, L] Montgomery points -> their sum over axis 0, [S, 3, L]:
    each level adds the first half to the second (an odd tail carried), as
    the JAX package's ``_tree_add_points`` pairs them; one kernel-1 launch
    of half x S lanes a level, D - 1 additions in ceil(log2 D) launches."""
    while stacked.shape[0] > 1:
        d = stacked.shape[0]
        half = d // 2
        s = ec.add(PointBatch(*stacked[:half].unbind(2)), PointBatch(*stacked[half : 2 * half].unbind(2)))
        merged = torch.stack(s, dim=2)
        stacked = torch.cat([merged, stacked[2 * half :]]) if d % 2 else merged
    return stacked[0]


def merge_window_sums(parts: Iterable[torch.Tensor], cfg: MsmConfig) -> torch.Tensor:
    """The sum of passes' Montgomery window sums [S, 3, L] (chunks, or
    shards on one device) by the point-add tree (window sums are curve
    points, so the complete formulas hold); one part is returned as it
    is."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    return tree_add_points(get_curve_ctx(cfg), torch.stack(parts))


def chunk_slices(n: int) -> list[slice]:
    """Row ranges of the passes over n padded rows (a power of two): one,
    or n / CHUNK_MAX chunks of CHUNK_MAX rows."""
    c = min(n, CHUNK_MAX)
    return [slice(lo, lo + c) for lo in range(0, n, c)]


def chunks(arrays, device) -> Iterator[tuple[torch.Tensor, ...]]:
    """Each pass's rows of the arrays [n, ...] (numpy on the host, or
    tensors) as tensors on ``device``; a host chunk is uploaded only when
    the consumer reaches it."""
    slices = chunk_slices(len(arrays[0]))
    for i, s in enumerate(slices):
        if len(slices) > 1:
            debug(f"chunk {i + 1}/{len(slices)}: rows {s.start}..{s.stop}")
        yield tuple(torch.as_tensor(a[s], device=device) for a in arrays)


def chunked_window_sums(parts, cfg: MsmConfig, geom: MsmGeometry) -> torch.Tensor:
    """Chunks (x, y, scalar words) on the device, as ``chunks`` yields them
    -> their merged Montgomery window sums [S, 3, L]."""
    return merge_window_sums((cuzk_window_sums(x, y, s, cfg, geom) for x, y, s in parts), cfg)


def cuzk_msm_point(
    x, y, s, cfg: MsmConfig, geom: MsmGeometry, device=None
) -> tuple[int, int, int]:
    """The device MSM of padded word inputs [n, 16] -> the standard-form
    projective (X, Y, Z) as ints: K2, the window sums, the Horner kernel
    and one copy of its three rows. The inputs are tensors already on the
    device, or host arrays that each pass uploads to ``device`` as it
    starts. Above ``CHUNK_MAX`` rows, one pass per chunk, merged on the
    device. ``geom`` is a pass's."""
    if device is None:
        if not isinstance(x, torch.Tensor):
            raise TypeError("host inputs need an explicit device")
        device = x.device
    return msm_point_from_ws(chunked_window_sums(chunks((x, y, s), device), cfg, geom), cfg)


def compute_msm_jpoint(
    points: list[tuple[int, int]],
    scalars: list[int],
    config: MsmConfig | None = None,
    geometry: MsmGeometry | None = None,
    validate: bool = False,
    device="cuda",
) -> JPoint:
    """End-to-end MSM returning the oracle JPoint: ``cuzk_msm_point`` on
    the padded host inputs, each chunk uploaded as its pass starts."""
    config = config or pick_config(len(points))
    common.check_config(config, device)
    if len(points) == 0:
        return IDENTITY
    arrays = common.pad_inputs(points, scalars, config, validate=validate, device=device)
    n = arrays[0].shape[0]
    geom = geometry or pick_geometry(min(n, CHUNK_MAX), config)
    return common.std_ints_to_jpoint(*cuzk_msm_point(*arrays, config, geom, device=device), config)


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
