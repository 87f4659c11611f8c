"""Kernel 9: batched Montgomery exponentiation (the Fermat inversion of the
pair-compression chains), and its plain twin.

CUDA source: ``msm_tpu_torch/csrc/inv.cu`` on the word core (a fixed
4-bit window, ``csrc/pow32.cuh``; the kernel generic over the field in
``csrc/pairs.cuh``, every curve of ``params.CURVES``). Replaces the Pallas kernel
``msm_tpu/ops/pallas_inv.py::make_mont_pow`` (``pallas_call`` at :92).

``mont_pow(cfg, a, e)`` takes a Montgomery-form batch ``a [G, L, R]``
(limbs-first, one value per lane; balanced limbs are fine) and a static
exponent e >= 0, and returns a^e in Montgomery form: pow(aR, e) = a^e R.
With e = p - 2 that is the inverse, pow(aR, p - 2) = a^-1 R.
"""

from __future__ import annotations

import ctypes

import torch

from msm_tpu_torch.ops import _build
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.params import MsmConfig

EXP_BITS_MAX = 1024  # csrc/inv.cu EXP_WORDS * 32


def mont_pow_plain(cfg: MsmConfig, a: torch.Tensor, e: int) -> torch.Tensor:
    """Plain twin: ``FieldCtx.mont_pow`` over every lane."""
    f = get_field_ctx(cfg)
    return f.mont_pow(a.transpose(-1, -2), e).transpose(-1, -2).contiguous()


def mont_pow(cfg: MsmConfig, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e per lane: [G, L, R] -> [G, L, R] (Montgomery form)."""
    if a.device.type == "cpu":
        return mont_pow_plain(cfg, a, e)
    a = a.contiguous()
    _build.require_cuda(cfg, a)
    if a.dim() != 3 or a.shape[1] != cfg.num_words:
        raise ValueError(f"expected [G, {cfg.num_words}, R], got {tuple(a.shape)}")
    nbits = e.bit_length()
    if e < 0 or nbits > EXP_BITS_MAX:
        raise ValueError(f"exponent must be in [0, 2^{EXP_BITS_MAX}), got {e}")
    nw = max(1, (nbits + 31) // 32)
    words = (ctypes.c_uint32 * nw)(*((e >> (32 * i)) & 0xFFFFFFFF for i in range(nw)))
    out = torch.empty_like(a)
    G, _, R = a.shape
    _build.launch("msm_mont_pow", a, out, ctypes.addressof(words), nbits, G, R, _build.curve_id(cfg),
                  width=cfg.word_size)
    mont_pow.launches += 1
    return out


mont_pow.launches = 0
