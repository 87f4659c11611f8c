"""Limb serialization between python ints and numpy arrays, and the byte
and 16-bit-word wire formats — the port's own copy of the functions of
``msm_tpu/utils/limbs.py``, with the same names, signatures and dtypes.

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


# ---------------------------------------------------------------------------
# Wire formats
# ---------------------------------------------------------------------------


def int_to_u16_words(x: int, num_u16: int = 16) -> np.ndarray:
    """A non-negative int below 2^(16 num_u16) -> its 16-bit words,
    little-endian, one per uint32 lane."""
    out = np.empty(num_u16, dtype=np.uint32)
    for i in range(num_u16):
        out[i] = (x >> (16 * i)) & 0xFFFF
    return out


def ints_to_u16_words(xs: list[int], num_u16: int = 16) -> np.ndarray:
    """[n] python ints -> uint32 [n, num_u16] 16-bit words."""
    out = np.empty((len(xs), num_u16), dtype=np.uint32)
    for i, x in enumerate(xs):
        out[i] = int_to_u16_words(x, num_u16)
    return out


def u16_words_to_int(words: np.ndarray) -> int:
    """Inverse of int_to_u16_words."""
    x = 0
    for i, w in enumerate(np.asarray(words, dtype=np.uint64).tolist()):
        x |= int(w) << (16 * i)
    return x


def scalars_to_bytes(scalars: list[int], nbytes: int = 32) -> bytes:
    """Scalars as little-endian bytes, nbytes each."""
    return b"".join(s.to_bytes(nbytes, "little") for s in scalars)


def bytes_to_scalars(data: bytes, nbytes: int = 32) -> list[int]:
    """Inverse of scalars_to_bytes."""
    return [int.from_bytes(data[i : i + nbytes], "little") for i in range(0, len(data), nbytes)]


def points_to_bytes(points_affine: list[tuple[int, int]], nbytes: int = 32) -> bytes:
    """Affine (x, y) pairs as little-endian bytes: x then y, nbytes each."""
    return b"".join(x.to_bytes(nbytes, "little") + y.to_bytes(nbytes, "little") for x, y in points_affine)


def bytes_to_points(data: bytes, nbytes: int = 32) -> list[tuple[int, int]]:
    """Inverse of points_to_bytes."""
    stride = 2 * nbytes
    return [
        (int.from_bytes(data[i : i + nbytes], "little"), int.from_bytes(data[i + nbytes : i + stride], "little"))
        for i in range(0, len(data), stride)
    ]
