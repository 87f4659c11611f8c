"""Host <-> device plumbing of the MSM pipeline — the PyTorch port of
``msm_tpu/models/common.py`` (its numpy helpers are carried over here, not
imported, since that module imports JAX).

The host pads inputs to a power of two, serializes coordinates and scalars
as 16-bit words, and finishes with the single result point in exact
integers (``mont_rows_to_ints``: no field op on any device). Uploads are
plain ``torch.from_numpy(...).to(device)``: the coordinate words travel as
int16 (the u16 bits, ceil(modulus_bits / 16) words a coordinate: 32 B for
BN254, 48 B for BLS12; what the convert kernel reads), the scalar words as
int32 (what ``ops/decompose`` reads). The serving plan
sends scalars packed instead, two u16 words to an int32 (``pack_scalar_words``,
32 B per scalar), from a pinned host buffer (``staging_buffer``), and
widens them on the device (``unpack_scalar_words``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from msm_tpu_torch.ops.cuda_convert import convert_pack
from msm_tpu_torch.ops.curve import CurveCtx, PointBatch, get_curve_ctx
from msm_tpu_torch.oracle.pyecc import IDENTITY, Curve, JPoint
from msm_tpu_torch.params import MsmConfig, coord_words
from msm_tpu_torch.utils import limbs as L


def check_config(cfg: MsmConfig, *devices) -> None:
    """Refuse, before any work, a config that an entry cannot run on
    ``devices``: on a CUDA device the kernels' rule first
    (``_build.check_cuda_config``: ``NotImplementedError``), then on every
    device the field layer's int32 column budget (``FieldCtx``:
    ``ValueError`` at word_size 14 to 16, as the JAX package raises)."""
    from msm_tpu_torch.ops._build import check_cuda_config
    from msm_tpu_torch.ops.field import get_field_ctx

    if any(torch.device(d).type == "cuda" for d in devices):
        check_cuda_config(cfg)
    get_field_ctx(cfg)


def pad_size(n: int) -> int:
    """Next power of two >= max(n, 16)."""
    n = max(n, 16)
    return 1 << (n - 1).bit_length()


def ints_to_u16_array(xs: list[int], nbytes: int = 32) -> np.ndarray:
    """python ints -> [n, nbytes/2] little-endian uint16 words (writable)."""
    buf = bytearray().join(x.to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), nbytes // 2)


#: points per pass of the subgroup ladder: its batches stay a few GiB
SUBGROUP_ROWS = 1 << 22


def validate_inputs(points: list[tuple[int, int]], cfg: MsmConfig, device="cuda") -> None:
    """Raise ``ValueError`` at the first coordinate outside [0, q), the
    first point off the curve (both on the host, in exact integers), and,
    on a curve with cofactor > 1, the first point outside the order-r
    subgroup: [r]P == O checked for the whole padded batch at once on
    ``device`` (``subgroup_mask_device``). The generator padding is in the
    subgroup, so padded rows always pass."""
    q, a, b = cfg.curve.modulus, cfg.curve.a, cfg.curve.b
    for i, (x, y) in enumerate(points):
        if not (0 <= x < q and 0 <= y < q):
            raise ValueError(f"point {i} coordinates out of field range [0, q)")
        if (y * y - (x * x * x + a * x + b)) % q != 0:
            raise ValueError(f"point {i} is not on the curve")
    if cfg.curve.cofactor > 1 and points:
        n = len(points)
        x_u16, y_u16 = pad_points_words(points, cfg, pad_size(n))
        mask = subgroup_mask_device(x_u16, y_u16, cfg, device).cpu().numpy()
        bad = np.flatnonzero(~mask[:n])
        if bad.size:
            raise ValueError(
                f"point {int(bad[0])} is outside the prime-order subgroup "
                f"(cofactor {cfg.curve.cofactor})"
            )


def subgroup_mask_device(x_u16, y_u16, cfg: MsmConfig, device="cuda") -> torch.Tensor:
    """Per-point membership of the order-r subgroup, [r]P == O, for u16
    coordinate words [N, W] (numpy or tensors, held in int16): the points
    converted to Montgomery form (kernel 2) and one ladder
    (``CurveCtx.scalar_mul_static`` with the unreduced r: a ladder mod r
    would make [r]P the identity for every point) over the whole batch on
    ``device``, ``SUBGROUP_ROWS`` points a pass. Returns bool [N] on
    ``device``.

    The identity is (0 : Y : 0) with Y != 0. The complete formulas are
    complete only on a group without points of order 2; BLS12-377's has
    them (its cofactor is even), and there an addition P + Q with P - Q of
    order 2 gives (0 : 0 : 0), which every later step keeps. A ladder over
    a point of the subgroup (odd order r) never meets such a pair, so the
    point passes exactly when [r]P is a true identity; a point that meets
    one (e.g. (2, 3), of order 6, or (-1, 0), of order 2) ends at
    (0 : 0 : 0) and fails, as it must. The JAX package's mask tests Z alone
    and passes such points."""
    from msm_tpu_torch.ops.cuda_convert import unpack_coords

    ec = get_curve_ctx(dataclasses.replace(cfg, glv=False))  # the [N, 2D] table
    D = coord_words(ec.cfg)
    x_u16, y_u16 = (torch.as_tensor(a).to(device) for a in (x_u16, y_u16))
    masks = []
    for lo in range(0, x_u16.shape[0], SUBGROUP_ROWS):
        packed = convert_pack(ec.cfg, x_u16[lo : lo + SUBGROUP_ROWS], y_u16[lo : lo + SUBGROUP_ROWS])
        pts = ec.from_affine_mont(unpack_coords(packed[:, :D], ec.cfg), unpack_coords(packed[:, D:], ec.cfg))
        rp = ec.scalar_mul_static(pts, cfg.curve.order)
        masks.append(ec.is_identity(rp) & ~ec.f.is_zero(rp.y))
    return torch.cat(masks)


def pad_points_words(
    points: list[tuple[int, int]], cfg: MsmConfig, N: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad to N with the generator and serialize to u16-word arrays held in
    int16 (the same bits: torch has int16 tensors, not uint16 ones)."""
    n = len(points)
    gx, gy = cfg.curve.gx % cfg.curve.modulus, cfg.curve.gy % cfg.curve.modulus
    px = [p[0] for p in points] + [gx] * (N - n)
    py = [p[1] for p in points] + [gy] * (N - n)
    cb = max((cfg.curve.modulus_bits + 7) // 8, 2)
    return ints_to_u16_array(px, cb).view(np.int16), ints_to_u16_array(py, cb).view(np.int16)


def pad_scalars_words(scalars: list[int], cfg: MsmConfig, N: int) -> np.ndarray:
    """Pad to N with zero scalars (bucket 0, multiplier 0: inert) and
    serialize to u16 words held in int32. Scalars outside [0, order) are
    reduced mod order first: the signed-window bound on the top digit holds
    only for k < order."""
    order = cfg.curve.order
    ks = list(scalars)
    if any(k < 0 or k >= order for k in ks):
        ks = [k % order for k in ks]
    ks = ks + [0] * (N - len(ks))
    return ints_to_u16_array(ks, (cfg.scalar_bits + 7) // 8).astype(np.int32)


def pad_inputs(
    points: list[tuple[int, int]],
    scalars: list[int],
    cfg: MsmConfig,
    multiple: int = 1,
    validate: bool = False,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad to a power of two, at least ``multiple``, with generator points
    and zero scalars; serialize to u16-word arrays (x, y in int16, scalars
    in int32). ``multiple`` gives instances of different sizes one padded
    size (the batched model). ``validate`` checks the points first
    (``validate_inputs``, its subgroup ladder on ``device``)."""
    n = len(points)
    if n != len(scalars):
        raise ValueError(f"{n} points but {len(scalars)} scalars")
    if validate:
        validate_inputs(points, cfg, device)
    N = pad_size(max(n, multiple))
    x_u16, y_u16 = pad_points_words(points, cfg, N)
    return x_u16, y_u16, pad_scalars_words(scalars, cfg, N)


def pack_scalar_words(words: np.ndarray) -> np.ndarray:
    """Scalar words [..., W] (any integer dtype, little-endian u16 values) ->
    the wire's int32 pairs [..., W/2], lo | hi << 16. A C-contiguous 16-bit
    array is viewed, not copied; any other is first cast to ``<u2``."""
    w = np.asarray(words)
    if w.shape[-1] % 2:
        raise ValueError(f"an even number of words per scalar expected, got {w.shape}")
    if w.dtype not in (np.dtype("<u2"), np.dtype("<i2")) or not w.flags.c_contiguous:
        w = np.ascontiguousarray(w.astype("<u2"))
    return w.view(np.int32)


def unpack_scalar_words(pairs: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_scalar_words`` on any device: int32 pairs [..., W/2]
    -> the int32 words [..., W] that ``ops/decompose`` reads. The int16 view
    sign-extends words >= 0x8000 on widening; the mask clears that."""
    return pairs.view(torch.int16).to(torch.int32) & 0xFFFF


def staging_buffer(shape: tuple[int, ...], device) -> torch.Tensor:
    """A zeroed int32 host buffer for uploads to ``device``: pinned when the
    device is CUDA (so a non-blocking copy from it is asynchronous; the
    allocation raises where that cannot be had), pageable otherwise."""
    return torch.zeros(shape, dtype=torch.int32, pin_memory=torch.device(device).type == "cuda")


def prepare_points(
    cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor
) -> torch.Tensor:
    """Stage 1, once per MSM: the packed point table [n, 2D] (canonical
    Montgomery affine coordinates, dense radix-2^32) by the convert kernel;
    under GLV the triple table [n, 3D] of rows x, beta x, y."""
    return convert_pack(cfg, x_u16, y_u16)


def export_points_std(ec: CurveCtx, pts: PointBatch) -> torch.Tensor:
    """Montgomery projective batch -> standard-form canonical limbs
    [..., 3, L]."""
    f = ec.f
    return torch.stack(
        [f.canonical(f.from_mont(pts.x)), f.canonical(f.from_mont(pts.y)),
         f.canonical(f.from_mont(pts.z))],
        dim=-2,
    )


def mont_rows_to_ints(rows: np.ndarray, cfg: MsmConfig) -> tuple[int, ...]:
    """Montgomery limb rows [k, L] (canonical or balanced) -> their
    standard-form values in [0, p) as python ints: each row folded to an
    int, times R^-1 mod p."""
    p = cfg.curve.modulus
    rinv = pow(cfg.r, -1, p)
    return tuple(L.limbs_to_int(row, cfg.word_size) * rinv % p for row in np.asarray(rows))


def std_ints_to_jpoint(x: int, y: int, z: int, cfg: MsmConfig) -> JPoint:
    """Standard-form homogeneous (X : Y : Z) ints -> oracle JPoint (one
    modular inversion)."""
    p = cfg.curve.modulus
    if z % p == 0:
        return IDENTITY
    zi = pow(z, -1, p)
    return Curve(cfg.curve).from_affine(x * zi % p, y * zi % p)


def std_point_to_jpoint(pt_std: np.ndarray, cfg: MsmConfig) -> JPoint:
    """[3, L] standard-form homogeneous limbs -> oracle JPoint."""
    arr = np.asarray(pt_std)
    return std_ints_to_jpoint(*(L.limbs_to_int(arr[i], cfg.word_size) for i in range(3)), cfg)


def window_sums_to_jpoints(window_sums_std: np.ndarray, cfg: MsmConfig) -> list[JPoint]:
    """[S, 3, L] standard-form homogeneous limbs -> oracle JPoints."""
    arr = np.asarray(window_sums_std)
    return [std_point_to_jpoint(arr[t], cfg) for t in range(arr.shape[0])]


def window_sums_to_result(window_sums_std: np.ndarray, cfg: MsmConfig) -> JPoint:
    """Host Horner over per-subtask window sums [S, 3, L], exact ints."""
    cv = Curve(cfg.curve)
    ws = window_sums_to_jpoints(window_sums_std, cfg)
    acc = ws[-1]
    for wpt in reversed(ws[:-1]):
        for _ in range(cfg.chunk_size):
            acc = cv.double(acc)
        acc = cv.add(acc, wpt)
    return acc


def result_to_affine(res: JPoint, cfg: MsmConfig):
    """JPoint -> affine (x, y) ints, or None for the identity."""
    if res.is_identity():
        return None
    return Curve(cfg.curve).to_affine(res)
