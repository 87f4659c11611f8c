"""msm_tpu_torch — the cuZK multi-scalar multiplication of ``msm_tpu`` in
PyTorch, with hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

- ``msm_tpu_torch.ops``     field/curve layers, the sort/scan machinery,
                            and one module per kernel (``cuda_*``: the
                            wrapper, its launch counter and its plain twin)
- ``msm_tpu_torch.csrc``    the CUDA sources, built at first use
- ``msm_tpu_torch.models``  geometry, host plumbing, the cuZK pipeline
                            (``cuzk``), the serving plan (``plan``), the
                            batched MSM (``batched``) and the naive
                            Pippenger (``naive``)
- ``msm_tpu_torch.parallel`` the sharded MSM over a list of devices, its
                            serving plan, and several processes on
                            torch.distributed (``multihost``)
- ``msm_tpu_torch.params``  curves and ``MsmConfig`` (a copy of the JAX
                            package's, with the same names)
- ``msm_tpu_torch.oracle``  the CPU oracles (pure Python, and C++ built at
                            first use)
- ``msm_tpu_torch.utils``   limb serialization, the byte and u16-word wire
                            formats, the debug log and the stage timings
- ``msm_tpu_torch.cli``     ``python -m msm_tpu_torch {msm,cpu,verify,bench,
                            profile}``
- ``msm_tpu_torch.bench``   ``python -m msm_tpu_torch.bench``: one JSON line

Entry points, as ``msm_tpu`` names them: ``run_gpu_msm`` (``run_tpu_msm``),
``plan`` (a point table converted once, then many scalar sets, as ints or
as u16 words [n, 16]; ``MsmPlan.run_batch`` for several at once),
``run_gpu_msm_batched`` (``run_tpu_msm_batched``), ``run_gpu_msm_sharded``
(``run_tpu_msm_sharded``: D shards, one a device, merged by a point-add
tree), ``plan_sharded`` (``msm_tpu.plan_sharded``: a plan whose table is
cut into those shards), ``cpu_msm``, the samplers and the byte helpers.

The package imports nothing of ``msm_tpu``. Every public entry takes an
explicit ``device``: CUDA tensors run the kernels, CPU tensors run the
plain twins for any curve. On CUDA the kernels cover the seven curves of
``CURVES`` with 13-bit limbs and with 12-bit limbs (``MsmConfig(...,
word_size=12)``: the same kernels in a library of their own, built at its
first use) on the plain path (``MsmConfig(curve=...)``, ``pick_config(n,
curve)``) and pair-compressed (``compress=True``, as ``msm_tpu msm
--compress`` runs it), each with or without the GLV split (``glv=True``,
``msm_tpu msm --glv``). ``karatsuba=True`` runs where the JAX package
builds it. Other limb widths raise ``NotImplementedError`` on CUDA before
any launch, as does the naive model under GLV (on every device).
"""

from __future__ import annotations

import numpy as np

from msm_tpu_torch.params import BLS12_377, BN254, CURVES, DEFAULT_CONFIG, PALLAS, CurveSpec, MsmConfig
from msm_tpu_torch.utils.limbs import bytes_to_points, bytes_to_scalars, points_to_bytes, scalars_to_bytes

__all__ = [
    "BN254",
    "BLS12_377",
    "PALLAS",
    "CURVES",
    "DEFAULT_CONFIG",
    "CurveSpec",
    "MsmConfig",
    "bytes_to_points",
    "bytes_to_scalars",
    "cpu_msm",
    "load_point_table",
    "plan",
    "plan_sharded",
    "points_to_bytes",
    "run_gpu_msm",
    "run_gpu_msm_batched",
    "run_gpu_msm_sharded",
    "sample_32_bit_scalars",
    "sample_points",
    "sample_scalars",
    "scalars_to_bytes",
]


def run_gpu_msm(points, scalars, config=None, validate=False, device="cuda"):
    """End-to-end MSM (counterpart of ``msm_tpu.run_tpu_msm``).

    ``points``: affine (x, y) int pairs; ``scalars``: ints. Returns the
    affine (x, y) result, or None for the identity. ``validate=True`` checks
    first that every point lies on the curve and, on BLS12-381 and
    BLS12-377 (cofactor > 1), in the order-r subgroup: [r]P == O by one
    ladder over all points on ``device`` (``ValueError`` at the first bad
    point's index)."""
    from msm_tpu_torch.models.cuzk import compute_msm

    return compute_msm(points, scalars, config=config, validate=validate, device=device)


def plan(points, config=None, validate=False, device="cuda"):
    """Prepare an MSM plan over a fixed point set (counterpart of
    ``msm_tpu.plan``): the points are serialized, uploaded and converted
    once; each ``plan(scalars)`` runs only the scalar side, with scalars as
    ints or as u16 words [n, 16] (k < order), and ``plan.run_batch([ks,
    ...])`` runs several scalar sets on the one table. ``validate`` as
    ``run_gpu_msm``'s."""
    from msm_tpu_torch.models.plan import MsmPlan

    return MsmPlan(points, config=config, validate=validate, device=device)


def run_gpu_msm_batched(instances, config=DEFAULT_CONFIG, device="cuda"):
    """Many independent MSMs with one upload and one copy back (counterpart
    of ``msm_tpu.run_tpu_msm_batched``). ``instances``: (points, scalars)
    pairs; returns oracle JPoints."""
    from msm_tpu_torch.models.batched import compute_msm_batched

    return compute_msm_batched(instances, config, device=device)


def run_gpu_msm_sharded(points, scalars, config=None, devices=None):
    """The MSM cut into D equal shards, one on each of ``devices`` (a power
    of two of them; one may repeat; default: every visible CUDA device),
    merged by a point-add tree (counterpart of
    ``msm_tpu.run_tpu_msm_sharded``). Returns the oracle JPoint."""
    from msm_tpu_torch.parallel import compute_msm_sharded

    return compute_msm_sharded(points, scalars, config, devices=devices)


def plan_sharded(points, devices=None, config=None, validate=False):
    """A plan (``plan``) whose point table is cut into the shards of
    ``run_gpu_msm_sharded``: each device converts and keeps its shard; a
    call uploads each shard's scalar rows to its device and merges the
    window sums by the tree (counterpart of ``msm_tpu.plan_sharded``)."""
    from msm_tpu_torch.parallel import ShardedMsmPlan

    return ShardedMsmPlan(points, devices=devices, config=config, validate=validate)


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


def sample_32_bit_scalars(n: int, seed: int = 1):
    """Random scalars below 2^32 (every high window lands in bucket 0)."""
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, 1 << 32, size=n, dtype=np.uint64)]
