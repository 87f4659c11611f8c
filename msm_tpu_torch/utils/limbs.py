"""Limb serialization between python ints and numpy arrays — the port's own
copy of the functions of ``msm_tpu/utils/limbs.py`` that it uses.

Convention: limb axis last, little-endian (limb 0 least significant),
``word_size`` bits per limb, one limb per 32-bit lane.
"""

from __future__ import annotations

import numpy as np


def int_to_limbs(x: int, word_size: int, num_words: int) -> np.ndarray:
    """Little-endian fixed-width limb decomposition of a non-negative int."""
    if x < 0:
        raise ValueError("negative")
    mask = (1 << word_size) - 1
    out = np.empty(num_words, dtype=np.uint32)
    for i in range(num_words):
        out[i] = x & mask
        x >>= word_size
    if x:
        raise ValueError("value does not fit in num_words limbs")
    return out


def limbs_to_int(limbs: np.ndarray, word_size: int) -> int:
    """Inverse of int_to_limbs; exact for signed (balanced) limbs too:
    value = sum limb_i * 2^(w*i)."""
    arr = np.asarray(limbs)
    if arr.dtype == np.uint32 or arr.dtype == np.uint64:
        vals = arr.astype(np.uint64).tolist()
    else:
        vals = arr.astype(np.int64).tolist()
    x = 0
    for i, limb in enumerate(vals):
        x += int(limb) << (i * word_size)
    return x


def ints_to_limbs(xs: list[int], word_size: int, num_words: int) -> np.ndarray:
    """[n] python ints -> uint32 [n, num_words]."""
    out = np.empty((len(xs), num_words), dtype=np.uint32)
    for i, x in enumerate(xs):
        out[i] = int_to_limbs(x, word_size, num_words)
    return out


def limbs_to_ints(arr: np.ndarray, word_size: int) -> list[int]:
    """[..., num_words] limbs -> the flat list of their ints."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    return [limbs_to_int(row, word_size) for row in flat]
