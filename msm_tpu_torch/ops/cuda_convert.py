"""Kernel 2: point conversion into the packed point table, its plain twin,
and the dense coordinate wire format.

CUDA source: ``msm_tpu_torch/csrc/convert.cu`` on the word core (per-point
body ``csrc/convert32.cuh``); it reads the u16 words as int16, 32 B per
coordinate, the bits the host serialized. Replaces the Pallas kernel
``msm_tpu/ops/pallas_convert.py::make_convert_pack`` (``pallas_call`` at
:187, non-GLV mode); ``coord_words``/``pack_coords``/``unpack_coords`` port
``msm_tpu/ops/pallas_scan.py:54-199``.

Wire format: a canonical coordinate bit-packed at radix 2^32 into
D = ceil(modulus_bits / 32) int32 words (BN254: 8); a table row is x's D
words then y's. Packing works in int64 and reinterprets the low 32 bits as
int32, so words >= 2^31 survive.
"""

from __future__ import annotations

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.decompose import extract_windows
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import MsmConfig


def coord_words(cfg: MsmConfig) -> int:
    """int32 words per dense-packed canonical coordinate."""
    return (cfg.curve.modulus_bits + 31) // 32


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


def convert_pack_plain(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor):
    """Plain twin of the convert kernel: u16 words [n, W] (held in int16 or
    int32) -> limbs -> Montgomery (x R^2 product) -> canonical -> packed
    table [n, 2D]."""
    f = get_field_ctx(cfg)
    w, L = cfg.word_size, cfg.num_words
    xs, ys = (extract_windows(a.to(torch.int32) & 0xFFFF, w, L).T for a in (x_u16, y_u16))
    return torch.cat(
        [pack_coords(f.to_mont(xs), cfg), pack_coords(f.to_mont(ys), cfg)], dim=-1
    )


def convert_pack(cfg: MsmConfig, x_u16: torch.Tensor, y_u16: torch.Tensor):
    """Point table from u16 coordinate words: [n, 16] x2 -> [n, 2D] int32.
    On CUDA the words must be int16 (the u16 bits, as
    ``models.common.pad_points_words`` gives them)."""
    if x_u16.device.type == "cpu":
        return convert_pack_plain(cfg, x_u16, y_u16)
    x_u16, y_u16 = _build.aligned(x_u16, y_u16)
    _build.require_cuda(cfg, x_u16, y_u16, dtype=torch.int16)
    n = x_u16.shape[0]
    if x_u16.shape != (n, 16) or y_u16.shape != (n, 16):
        raise ValueError(f"expected [n, 16] u16 words, got {tuple(x_u16.shape)}")
    out = torch.empty((n, 2 * coord_words(cfg)), dtype=torch.int32, device=x_u16.device)
    _build.launch("msm_convert", x_u16, y_u16, out, n)
    convert_pack.launches += 1
    return out


convert_pack.launches = 0
