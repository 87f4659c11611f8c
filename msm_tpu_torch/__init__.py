"""msm_tpu_torch — the cuZK multi-scalar multiplication of ``msm_tpu`` in
PyTorch, with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

- ``msm_tpu_torch.ops``     field/curve layers, the sort/scan machinery,
                            and one module per kernel (``cuda_*``: the
                            wrapper, its launch counter and its plain twin)
- ``msm_tpu_torch.csrc``    the CUDA sources, built at first use
- ``msm_tpu_torch.models``  geometry, host plumbing, the cuZK pipeline
                            (``cuzk``) and the naive Pippenger (``naive``)
- ``msm_tpu_torch.params``  curves and ``MsmConfig`` (a copy of the JAX
                            package's, with the same names)
- ``msm_tpu_torch.oracle``  the CPU oracles (pure Python, and C++ built at
                            first use)
- ``msm_tpu_torch.utils``   limb serialization

The package imports nothing of ``msm_tpu``. Every public entry takes an
explicit ``device``: CUDA tensors run the kernels, CPU tensors run the
plain twins for any curve. On CUDA the kernels cover BN254 with 13-bit limbs,
plain (``MsmConfig(curve=BN254)``, ``pick_config(n)``) or pair-compressed
(``compress=True``, as ``msm_tpu msm --compress`` runs it), each with or
without the GLV split (``glv=True``, ``msm_tpu msm --glv``). Karatsuba,
other curves and other limb widths raise ``NotImplementedError`` on CUDA,
as does the naive model under GLV (on every device).
"""

from __future__ import annotations

import numpy as np

from msm_tpu_torch.params import BN254, MsmConfig

__all__ = [
    "cpu_msm",
    "load_point_table",
    "run_gpu_msm",
    "sample_points",
    "sample_scalars",
]


def run_gpu_msm(points, scalars, config=None, validate=False, device="cuda"):
    """End-to-end MSM (counterpart of ``msm_tpu.run_tpu_msm``).

    ``points``: affine (x, y) int pairs; ``scalars``: ints. Returns the
    affine (x, y) result, or None for the identity. ``validate=True`` checks
    that every point lies on the curve first."""
    from msm_tpu_torch.models.cuzk import compute_msm

    return compute_msm(points, scalars, config=config, validate=validate, device=device)


def load_point_table(packed: np.ndarray, cfg: MsmConfig, device="cuda"):
    """The JAX package's prepared point table (``make_convert_pack`` output,
    int32 [n, 2D] as numpy; under a GLV config its triple table [n, 3D]) as
    this package's table on ``device``, ready for
    ``models.cuzk.window_sums_from_table``."""
    import torch

    from msm_tpu_torch.ops.cuda_convert import coord_words, table_coords

    width = table_coords(cfg) * coord_words(cfg)
    arr = np.array(packed, dtype=np.int32, order="C")  # a writable copy
    if arr.ndim != 2 or arr.shape[1] != width:
        raise ValueError(f"expected [n, {width}] table, got {arr.shape}")
    return torch.from_numpy(arr).to(device)


def cpu_msm(points, scalars, curve=BN254):
    """CPU oracle MSM (C++ when built, else pure python); an oracle JPoint."""
    from msm_tpu_torch.oracle import best_msm

    return best_msm(points, scalars, curve=curve)


def sample_points(n: int, curve=BN254, seed: int = 0):
    """Random affine points: random multiples of the generator."""
    from msm_tpu_torch.oracle.pyecc import Curve

    cv = Curve(curve)
    return [cv.to_affine(p) for p in cv.sample_points(n, seed=seed)]


def sample_scalars(n: int, curve=BN254, seed: int = 1):
    """Random scalars in [0, order)."""
    from msm_tpu_torch.oracle.pyecc import Curve

    return Curve(curve).sample_scalars(n, seed=seed)
