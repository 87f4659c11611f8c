"""Scalar decomposition into signed windows — the PyTorch port of
``msm_tpu/ops/decompose.py``.

Scalars arrive as sixteen 16-bit words each (int32 ``[n, 16]``, LE). The
window count S comes from ``MsmConfig.num_subtasks``: ceil((order_bits + 1)
/ c), the +1 bit being the signed-recode headroom that keeps the top digit
<= 2^(c-1) (``msm_tpu/params.py:270-287``).
"""

from __future__ import annotations

import torch


def extract_windows(
    scalars_u16: torch.Tensor, chunk_size: int, num_subtasks: int
) -> torch.Tensor:
    """[n, W] u16 words -> int32 [S, n]: window j = bits [c*j, c*j + c)."""
    c = chunk_size
    mask = (1 << c) - 1
    nwords = scalars_u16.shape[-1]
    outs = []
    for j in range(num_subtasks):
        a, off = divmod(c * j, 16)
        if a >= nwords:
            outs.append(torch.zeros_like(scalars_u16[:, 0]))
            continue
        w = scalars_u16[:, a] >> off
        if off + c > 16 and a + 1 < nwords:
            w = w | (scalars_u16[:, a + 1] << (16 - off))
        outs.append(w & mask)
    return torch.stack(outs).to(torch.int32)


def signed_recode(windows: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Unsigned windows [S, n] -> signed digits in [-2^(c-1), 2^(c-1)),
    carry-propagated LSB first; the top window absorbs the last carry."""
    half = 1 << (chunk_size - 1)
    full = 1 << chunk_size
    digits = torch.empty_like(windows)
    carry = torch.zeros_like(windows[0])
    for j in range(windows.shape[0] - 1):
        v = windows[j] + carry
        hi = v >= half
        digits[j] = torch.where(hi, v - full, v)
        carry = hi.to(windows.dtype)
    digits[-1] = windows[-1] + carry
    return digits


def decompose_signed(
    scalars_u16: torch.Tensor, chunk_size: int, num_subtasks: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys [S, n] = |digit| in [0, 2^(c-1)], signs [S, n] bool = digit < 0)."""
    d = signed_recode(
        extract_windows(scalars_u16, chunk_size, num_subtasks), chunk_size
    )
    return d.abs(), d < 0
