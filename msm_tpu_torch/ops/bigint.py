"""Batched big-integer limb helpers on int32 tensors — the part of
``msm_tpu/ops/bigint.py`` the field layer needs.

Convention as in the reference: limbs on the last axis (``[..., L]``),
little-endian, ``word_size``-bit radix, int32. ``>>`` on an int32 tensor is
an arithmetic shift and ``&`` acts on the two's complement, so a sweep is
exact for signed (balanced) limbs too.
"""

from __future__ import annotations

import torch


def sweep(x: torch.Tensor, word_size: int) -> torch.Tensor:
    """One parallel carry step: move each limb's overflow one limb up; the
    top limb keeps its own overflow, so the value is unchanged."""
    mask = (1 << word_size) - 1
    carry = x >> word_size
    out = x & mask
    out[..., 1:] += carry[..., :-1]
    out[..., -1] += carry[..., -1] << word_size
    return out


def carry_propagate(
    x: torch.Tensor, word_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative raw columns -> (limbs all < 2^w, carry out), by a serial
    carry chain over the limb axis."""
    mask = (1 << word_size) - 1
    limbs = torch.empty_like(x)
    carry = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        v = x[..., j] + carry
        limbs[..., j] = v & mask
        carry = v >> word_size
    return limbs, carry


def sub(
    a: torch.Tensor, b: torch.Tensor, word_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """a - b with a borrow chain: (difference limbs, borrow out in {0, 1}).
    The difference is exact when a >= b (borrow 0)."""
    a, b = torch.broadcast_tensors(a, b)
    base = 1 << word_size
    limbs = torch.empty_like(a)
    borrow = torch.zeros_like(a[..., 0])
    for j in range(a.shape[-1]):
        d = a[..., j] - b[..., j] - borrow
        borrow = (d < 0).to(a.dtype)
        limbs[..., j] = d + borrow * base
    return limbs, borrow
