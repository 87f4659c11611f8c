"""Kernel 2: point conversion into the packed point table, its plain twin,
and the dense coordinate wire format.

CUDA source: ``msm_tpu_torch/csrc/convert.cu`` on the word core (per-point
body ``csrc/convert32.cuh``); it reads the u16 words as int16, 4 D bytes
per coordinate (BN254: 32), the bits the host serialized. Every mode runs
every curve of ``params.CURVES`` (the GLV mode's beta R^2 compiled in per
field, ``csrc/fields.cuh``; the scaled mode's constants given at run time
in the curve's D words). Replaces the Pallas kernel
``msm_tpu/ops/pallas_convert.py::make_convert_pack`` (``pallas_call`` at
:187) in all its modes: ``convert_pack`` the plain one, ``convert_pack_glv``
the GLV one (``dual_x_scale_int`` = beta R^2, ``triple=True``), both with
their constants compiled in, and ``convert_pack_scaled`` every mode with
its x constants given at run time (``x_scale_int``, ``dual_x_scale_int``,
``triple``: one [n, 2D] table, two, or one [n, 3D]); each with its own C
entry and launch counter. ``coord_words``/``pack_coords``/
``unpack_coords`` port ``msm_tpu/ops/pallas_scan.py:54-199``.

Wire format: a canonical coordinate bit-packed at radix 2^32 into
D = ceil(modulus_bits / 32) int32 words (BN254: 8, BLS12: 12); a table row is x's D
words then y's, or under GLV x's, beta x's (the x of phi(P) = (beta x, y))
and y's. Packing works in int64 and reinterprets the low 32 bits as int32,
so words >= 2^31 survive.
"""

from __future__ import annotations

import ctypes

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.decompose import extract_windows
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.params import MsmConfig, coord_words


def table_coords(cfg: MsmConfig) -> int:
    """Coordinates per point-table row: 2 (x, y), 3 under GLV (x, beta x, y)."""
    return 3 if cfg.glv else 2


def _pack_plan(w: int, L: int, D: int) -> list[list[tuple[int, int]]]:
    """plan[k] lists (limb j, shift) whose ``limb_j << shift`` (``>> -shift``
    when negative) lands in dense word k (reference pallas_scan._pack_plan)."""
    plan: list[list[tuple[int, int]]] = [[] for _ in range(D)]
    for j in range(L):
        lo, hi = w * j, w * j + w
        for k in range(lo // 32, min((hi + 31) // 32, D)):
            plan[k].append((j, lo - 32 * k))
    return plan


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern in [0, 2^32) -> int32 with those bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def pack_canonical(c: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """[..., L] CANONICAL limbs -> [..., D] dense int32 words."""
    w, L, D = cfg.word_size, cfg.num_words, coord_words(cfg)
    c = c.to(torch.int64)
    words = []
    for contrib in _pack_plan(w, L, D):
        v = torch.zeros_like(c[..., 0])
        for j, s in contrib:
            v = v | (c[..., j] << s if s >= 0 else c[..., j] >> (-s))
        words.append(_to_int32_bits(v))
    return torch.stack(words, dim=-1)


def pack_coords(x: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """[..., L] balanced limbs -> [..., D] dense words of the canonical value."""
    assert x.shape[-1] == cfg.num_words, (x.shape, cfg.num_words)
    return pack_canonical(get_field_ctx(cfg).canonical(x), cfg)


def unpack_coords(p: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """[..., D] dense words -> [..., L] standard w-bit limbs (int32)."""
    w, L, D = cfg.word_size, cfg.num_words, coord_words(cfg)
    mask = (1 << w) - 1
    u = p.to(torch.int64) & 0xFFFFFFFF  # unsigned view: logical shifts
    cols = []
    for j in range(L):
        k, s = divmod(w * j, 32)
        if k >= D:
            cols.append(torch.zeros_like(u[..., 0]))
            continue
        v = u[..., k] >> s
        if s + w > 32 and k + 1 < D:
            v = v | (u[..., k + 1] << (32 - s))
        cols.append(v & mask)
    return torch.stack(cols, dim=-1).to(torch.int32)


def convert_pack_scaled_plain(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor,
                               x_scale: int | None = None, dual_x_scale: int | None = None,
                               triple: bool = False):
    """Plain twin of the convert kernel in every mode: u16 words [n, W]
    (held in int16 or int32) -> limbs -> Montgomery products -> canonical
    -> packed rows. x is multiplied by x_scale mod p (default R^2: x R),
    y by R^2. Returns one [n, 2D] table; with dual_x_scale two [n, 2D]
    tables, the second's x scaled by dual_x_scale, sharing y; with
    dual_x_scale and triple one [n, 3D] table x, x', y."""
    if triple and dual_x_scale is None:
        raise ValueError("triple mode needs dual_x_scale")
    f = get_field_ctx(cfg)
    w, L = cfg.word_size, cfg.num_words
    xs, ys = (extract_windows(a.to(torch.int32) & 0xFFFF, w, L).T for a in (x_u16, y_u16))
    y = pack_coords(f.to_mont(ys), cfg)

    def scaled(c):
        return pack_coords(f.mont_mul(xs, f.const(f._limbs(c % cfg.curve.modulus), xs.device)), cfg)

    x = scaled(cfg.r2 if x_scale is None else x_scale)
    if dual_x_scale is None:
        return torch.cat([x, y], dim=-1)
    x2 = scaled(dual_x_scale)
    if triple:
        return torch.cat([x, x2, y], dim=-1)
    return torch.cat([x, y], dim=-1), torch.cat([x2, y], dim=-1)


def convert_pack_plain(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor):
    """Plain twin of the convert kernel's plain and GLV modes: the packed
    table [n, 2D] (x R, y R); under GLV [n, 3D], with beta x R (x times
    beta R^2) between x and y."""
    if not cfg.glv:
        return convert_pack_scaled_plain(cfg, x_u16, y_u16)
    beta_r2 = glv_params(cfg.curve).beta * cfg.r2
    return convert_pack_scaled_plain(cfg, x_u16, y_u16, dual_x_scale=beta_r2, triple=True)


def coord_u16(cfg: MsmConfig) -> int:
    """u16 words per serialized coordinate: ceil(modulus_bits / 16), the JAX
    package's rule (BN254: 16; BLS12: 24)."""
    return (cfg.curve.modulus_bits + 15) // 16


def _words_in(cfg: MsmConfig, x_u16, y_u16):
    """Checks before a convert launch: [n, Wu] int16 words on CUDA (Wu =
    ``coord_u16``), 16-byte aligned (copied where they are not)."""
    x_u16, y_u16 = _build.aligned(x_u16, y_u16)
    _build.require_cuda(cfg, x_u16, y_u16, dtype=torch.int16)
    n, wu = x_u16.shape[0], coord_u16(cfg)
    if x_u16.shape != (n, wu) or y_u16.shape != (n, wu):
        raise ValueError(f"expected [n, {wu}] u16 words, got {tuple(x_u16.shape)}")
    return x_u16, y_u16


def _convert(cfg: MsmConfig, x_u16, y_u16, entry: str, counter):
    x_u16, y_u16 = _words_in(cfg, x_u16, y_u16)
    n = x_u16.shape[0]
    out = torch.empty((n, table_coords(cfg) * coord_words(cfg)), dtype=torch.int32,
                      device=x_u16.device)
    _build.launch(entry, x_u16, y_u16, out, n, _build.curve_id(cfg), width=cfg.word_size)
    counter.launches += 1
    return out


def convert_pack(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor):
    """Point table from u16 coordinate words: [n, Wu] x2 -> [n, 2D] int32,
    under GLV [n, 3D] (``convert_pack_glv``). On CUDA the words must be
    int16 (the u16 bits, as ``models.common.pad_points_words`` gives them)."""
    if cfg.glv:
        return convert_pack_glv(cfg, x_u16, y_u16)
    if x_u16.device.type == "cpu":
        return convert_pack_plain(cfg, x_u16, y_u16)
    return _convert(cfg, x_u16, y_u16, "msm_convert", convert_pack)


def convert_pack_glv(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor):
    """The GLV point table [n, 3D] int32: rows x R, beta x R, y R."""
    if not cfg.glv:
        raise ValueError("convert_pack_glv needs a GLV config")
    if x_u16.device.type == "cpu":
        return convert_pack_plain(cfg, x_u16, y_u16)
    return _convert(cfg, x_u16, y_u16, "msm_convert_glv", convert_pack_glv)


convert_pack.launches = 0
convert_pack_glv.launches = 0


#: csrc/convert32.cuh's output layouts
CONVERT_ONE, CONVERT_DUAL, CONVERT_TRIPLE = 0, 1, 2


def convert_pack_scaled(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor,
                        x_scale: int | None = None, dual_x_scale: int | None = None,
                        triple: bool = False):
    """The convert kernel with its x constants given at run time, as
    ``make_convert_pack(cfg, x_scale_int=x_scale, dual_x_scale_int=
    dual_x_scale, triple=triple)`` builds it: x R^-1 x_scale (default R^2,
    so x R), y R. Returns one [n, 2D] table; with ``dual_x_scale`` two
    [n, 2D] tables (x scaled by each constant, y shared), or with
    ``triple`` as well one [n, 3D] table. The layout depends on these
    arguments only, not on ``cfg.glv``. On CUDA the words must be int16."""
    if triple and dual_x_scale is None:
        raise ValueError("triple mode needs dual_x_scale")
    if x_u16.device.type == "cpu":
        return convert_pack_scaled_plain(cfg, x_u16, y_u16, x_scale, dual_x_scale, triple)
    x_u16, y_u16 = _words_in(cfg, x_u16, y_u16)
    n, D, q = x_u16.shape[0], coord_words(cfg), cfg.curve.modulus

    def words(c):  # the canonical constant's D words, least significant first
        c %= q
        return (ctypes.c_uint32 * D)(*((c >> (32 * k)) & 0xFFFFFFFF for k in range(D)))

    xs = words(cfg.r2 if x_scale is None else x_scale)
    xs2 = None if dual_x_scale is None else words(dual_x_scale)
    layout = CONVERT_ONE if xs2 is None else CONVERT_TRIPLE if triple else CONVERT_DUAL
    width = (3 if layout == CONVERT_TRIPLE else 2) * D
    outs = [torch.empty((n, width), dtype=torch.int32, device=x_u16.device)
            for _ in range(2 if layout == CONVERT_DUAL else 1)]
    _build.launch("msm_convert_scaled", x_u16, y_u16, ctypes.addressof(xs),
                  ctypes.addressof(xs2) if xs2 is not None else None, outs[0],
                  outs[-1] if layout == CONVERT_DUAL else None, n, layout, _build.curve_id(cfg), width=cfg.word_size)
    convert_pack_scaled.launches += 1
    return tuple(outs) if layout == CONVERT_DUAL else outs[0]


convert_pack_scaled.launches = 0
