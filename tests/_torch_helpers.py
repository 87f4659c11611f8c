"""Shared helpers for the tests that hold msm_tpu_torch against msm_tpu.

Importing this module pins PyTorch to one thread: the suite runs several
test processes side by side, and PyTorch's default of one thread per core
in every process would oversubscribe the machine. Inputs are made with
numpy from a seed and handed to both packages.
"""

import numpy as np
import torch

from msm_tpu.utils import limbs as L
from msm_tpu_torch.oracle.pyecc import Curve

torch.set_num_threads(1)


def port_cfg(jax_cfg):
    """The port's MsmConfig for a JAX package MsmConfig: the same curve (by
    name), word_size, chunk_size, compress, glv and karatsuba. Each package
    is handed only its own config."""
    from msm_tpu_torch.params import CURVES, MsmConfig

    return MsmConfig(
        curve=CURVES[jax_cfg.curve.name], word_size=jax_cfg.word_size,
        chunk_size=jax_cfg.chunk_size, compress=jax_cfg.compress, glv=jax_cfg.glv,
        karatsuba=jax_cfg.karatsuba,
    )


def rand_balanced(rng, shape, cfg, spread: int = 300) -> np.ndarray:
    """Balanced limbs as the lazy field layer produces them: limbs a little
    outside [0, 2^w) (negative included), small signed top limb."""
    w, nw = cfg.word_size, cfg.num_words
    a = rng.integers(-spread, (1 << w) + spread, size=tuple(shape) + (nw,))
    a[..., -1] = rng.integers(-20, 20, size=shape)
    return a.astype(np.int32)


def rand_canonical(rng, shape, cfg) -> np.ndarray:
    """Canonical field elements (every value < p) as int32 limbs."""
    w, nw = cfg.word_size, cfg.num_words
    a = rng.integers(0, 1 << w, size=tuple(shape) + (nw,))
    a[..., -1] = rng.integers(0, cfg.curve.modulus >> (w * (nw - 1)), size=shape)
    return a.astype(np.int32)


def affine_points(cfg, n: int, seed: int) -> list[tuple[int, int]]:
    """n random affine points of the port config's curve (the port's
    sampler, which draws the same points as the JAX package's)."""
    cv = Curve(cfg.curve)
    return [cv.to_affine(p) for p in cv.sample_points(n, seed=seed)]


def tiled_msm_inputs(cfg, n: int, seed: int, nbase: int = 32):
    """An MSM's inputs: n points tiled from nbase random ones, and uniform
    scalars below the order."""
    base = affine_points(cfg, nbase, seed=seed)
    pts = [base[i % nbase] for i in range(n)]
    rng = np.random.default_rng(seed + 1)
    ks = [int.from_bytes(rng.bytes(32), "little") % cfg.curve.order for _ in range(n)]
    return pts, ks


def pair_stream(cfg, G: int, C: int, R: int, nbase: int, seed: int):
    """Inputs of the pair kernels: a packed table of ``nbase`` real points
    and a step-major stream perm, flags [G, C, R] over it, with doubling
    pairs (same row, same sign) and infinity pairs (same row, opposite
    sign) planted at pair positions (2j, 2j+1). Returns (base affine
    points, packed [nbase, 2D], perm, flags) as numpy."""
    from msm_tpu_torch.models.common import pad_points_words
    from msm_tpu_torch.ops.cuda_convert import convert_pack_plain

    base = affine_points(cfg, nbase, seed)
    x_u16, y_u16 = pad_points_words(base, cfg, nbase)
    packed = convert_pack_plain(cfg, torch.from_numpy(x_u16), torch.from_numpy(y_u16)).numpy()
    rng = np.random.default_rng(seed)
    perm = rng.integers(0, nbase, size=(G, C, R)).astype(np.int32)
    flags = rng.integers(0, 2, size=(G, C, R)).astype(np.int32)
    kind = rng.random((G, C // 2, R))
    for planted, flip in ((kind < 0.2, 0), (kind > 0.85, 1)):  # doubling, infinity
        g, j, r = np.nonzero(planted)
        perm[g, 2 * j + 1, r] = perm[g, 2 * j, r]
        flags[g, 2 * j + 1, r] = flags[g, 2 * j, r] ^ flip
    return base, packed, perm, flags


def glv_pair_stream(cfg, G: int, C: int, R: int, nbase: int, seed: int):
    """pair_stream over a GLV table (cfg.glv: rows x, beta x, y): the first
    nbase/2 rows are random points P_i, the rest their images phi(P_i) =
    (beta x_i, y_i), and flags carry bit 1 (take beta x) as well as the
    sign. Planted at pair positions (2j, 2j+1): doublings and infinity
    pairs of one row and one phi bit, and pairs of P_i's phi copy with the
    row phi(P_i) (x_j = beta x_i: equal x across halves), of equal or
    opposite sign. Returns (the table's affine points, packed [nbase, 3D],
    perm, flags) as numpy."""
    from msm_tpu_torch.models.common import pad_points_words
    from msm_tpu_torch.ops.cuda_convert import convert_pack_plain
    from msm_tpu_torch.ops.glv import glv_params

    half = nbase // 2
    q, beta = cfg.curve.modulus, glv_params(cfg.curve).beta
    base = affine_points(cfg, half, seed)
    base = base + [(x * beta % q, y) for x, y in base]
    x_u16, y_u16 = pad_points_words(base, cfg, nbase)
    packed = convert_pack_plain(cfg, torch.from_numpy(x_u16), torch.from_numpy(y_u16)).numpy()
    rng = np.random.default_rng(seed)
    perm = rng.integers(0, nbase, size=(G, C, R)).astype(np.int32)
    flags = rng.integers(0, 4, size=(G, C, R)).astype(np.int32)
    kind = rng.random((G, C // 2, R))
    for planted, flip in ((kind < 0.15, 0), (kind > 0.85, 1)):  # doubling, infinity
        g, j, r = np.nonzero(planted)
        perm[g, 2 * j + 1, r] = perm[g, 2 * j, r]
        flags[g, 2 * j + 1, r] = flags[g, 2 * j, r] ^ flip
    g, j, r = np.nonzero((kind >= 0.15) & (kind < 0.45))  # phi(P_i) twice
    i = rng.integers(0, half, size=g.shape)
    sign = rng.integers(0, 2, size=(2,) + g.shape)
    perm[g, 2 * j, r], flags[g, 2 * j, r] = i, 2 | sign[0]
    perm[g, 2 * j + 1, r] = half + i
    flags[g, 2 * j + 1, r] = sign[0] ^ (sign[1] & (kind[g, j, r] < 0.3))
    return base, packed, perm, flags


def u16_words_int32(*words: np.ndarray) -> list[np.ndarray]:
    """The port's coordinate words (u16 bits held in int16) as the JAX
    package takes them: each u16 value held in int32."""
    return [w.view(np.uint16).astype(np.int32) for w in words]


def mont_limbs(vals, cfg) -> np.ndarray:
    """python ints -> Montgomery-form canonical limbs [n, L] int32."""
    p, r = cfg.curve.modulus, cfg.r
    return L.ints_to_limbs(
        [v * r % p for v in vals], cfg.word_size, cfg.num_words
    ).astype(np.int32)


def canon(x, cfg) -> np.ndarray:
    """Exact residues of limb arrays (any representation) as python ints
    mod p, elementwise over the batch — for comparing the two packages."""
    arr = np.asarray(x).astype(np.int64)
    flat = arr.reshape(-1, arr.shape[-1])
    p = cfg.curve.modulus
    out = np.array([L.limbs_to_int(r, cfg.word_size) % p for r in flat], dtype=object)
    return out.reshape(arr.shape[:-1])


def same_points(a, b, cfg) -> bool:
    """Projective point batches (x, y, z limb arrays) equal as points:
    X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1 over exact residues."""
    p = cfg.curve.modulus
    x1, y1, z1 = (canon(t, cfg) for t in a)
    x2, y2, z2 = (canon(t, cfg) for t in b)
    return bool(
        np.all((x1 * z2 - x2 * z1) % p == 0) and np.all((y1 * z2 - y2 * z1) % p == 0)
        and np.all((z1 == 0) == (z2 == 0))
    )
