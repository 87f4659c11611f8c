"""Batched big-integer limb arithmetic on int32 tensors — the port of
``msm_tpu/ops/bigint.py``, with its names and semantics.

Convention as in the reference: limbs on the last axis (``[..., L]``),
little-endian, ``word_size``-bit radix, int32. ``>>`` on an int32 tensor is
an arithmetic shift and ``&`` acts on the two's complement, so a sweep is
exact for signed (balanced) limbs too. int32 sums wrap as the reference's
do, so the results are its bits whatever the order of the additions.

Overflow budget (w = word_size, L = num_words, int32 lanes): a schoolbook
column holds up to L limb products, L * (2^w - 1)^2, plus an incoming
carry; ``check_overflow_budget`` refuses the geometries where that reaches
2^31 (BN254 at 14 bits and wider: no 14- to 16-bit ``FieldCtx``).
"""

from __future__ import annotations

import torch


def check_overflow_budget(word_size: int, num_words: int) -> None:
    """Raise ``ValueError`` for a limb geometry whose product columns could
    overflow int32 lanes (the reference's rule and message): at w = 14,
    L = 19 a column reaches 19 (2^14 - 1)^2 > 2^32. The wide-word
    multipliers (``field.mont_mul_eager``, ``mont_mul_nsafe``) serve 13 to
    16 bits instead."""
    col_max = num_words * ((1 << word_size) - 1) ** 2 + (1 << 19)
    if col_max >= 1 << 31:
        raise ValueError(
            f"word_size={word_size}, num_words={num_words} overflows int32 "
            f"column accumulation; use word_size <= 13"
        )


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


def add(a: torch.Tensor, b: torch.Tensor, word_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """a + b normalized: (sum limbs, carry out)."""
    return carry_propagate(a + b, word_size)


def gte(a: torch.Tensor, b: torch.Tensor, word_size: int) -> torch.Tensor:
    """a >= b over the batch (bool ``[...]``), from the borrow of a - b."""
    return sub(a, b, word_size)[1] == 0


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def mul_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns with no carry pass, int32 ``[..., 2L-1]``:
    c_k = sum over i + j = k of a_i b_j (each below L 2^(2w) within the
    overflow budget)."""
    a, b = torch.broadcast_tensors(a, b)
    L = a.shape[-1]
    c = torch.zeros(a.shape[:-1] + (2 * L - 1,), dtype=a.dtype, device=a.device)
    for i in range(L):
        c[..., i : i + L] += a[..., i : i + 1] * b
    return c


def mul(a: torch.Tensor, b: torch.Tensor, word_size: int) -> torch.Tensor:
    """The full product as canonical limbs ``[..., 2L]`` (a, b canonical:
    the product is below 2^(2wL), so no carry leaves the top limb)."""
    c = mul_raw(a, b)
    c = torch.cat([c, torch.zeros_like(c[..., :1])], dim=-1)
    return carry_propagate(c, word_size)[0]


def shr_bits(x: torch.Tensor, nbits: int, word_size: int, out_words: int) -> torch.Tensor:
    """Logical right shift of canonical limbs by a static bit count, as
    ``out_words`` limbs (Barrett's high-bit extraction)."""
    limb_sh, bit_sh = divmod(nbits, word_size)
    mask = (1 << word_size) - 1
    pad = torch.zeros(x.shape[:-1] + (out_words + 1,), dtype=x.dtype, device=x.device)
    shifted = torch.cat([x[..., limb_sh:], pad], dim=-1)[..., : out_words + 1]
    if bit_sh == 0:
        return shifted[..., :out_words].clone()
    lo = shifted[..., :out_words] >> bit_sh
    hi = (shifted[..., 1 : out_words + 1] << (word_size - bit_sh)) & mask
    return lo | hi
