"""The port's plain path on the CPU for the BLS12 curves (30 limbs, 12
words an element): ``run_gpu_msm(device="cpu")`` and a plan's words call,
at chunk 8 over 50 points, held bit for bit against the JAX package's
``compute_msm`` (its Pallas kernels as its own tests run them on the CPU)
and the oracle. The same test for the other curves is in
``test_torch_msm_curves_pasta.py`` and ``test_torch_msm_curves_256.py``.
Also the compressed geometry's batch rule at 30 limbs."""

import numpy as np
import pytest

import msm_tpu_torch
from _torch_helpers import affine_points
from msm_tpu.models.cuzk import compute_msm as j_compute_msm
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.models import common, geometry
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BLS12_381, BN254, CURVES, MsmConfig


def check_curve_msm(name: str, n: int = 50, seed: int = 70) -> None:
    """The plain path of one curve on the CPU: run_gpu_msm and a plan's
    words call against compute_msm and the oracle, affine and exact."""
    cfg = MsmConfig(curve=CURVES[name], chunk_size=8)
    pts = affine_points(cfg, n, seed=seed)
    raw = np.random.default_rng(seed + 1).bytes(32 * n)
    ks = [int.from_bytes(raw[i:i + 32], "little") % cfg.curve.order for i in range(0, 32 * n, 32)]
    cv = Curve(cfg.curve)
    want = cv.to_affine(cv.msm([cv.from_affine(*p) for p in pts], ks))
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device="cpu")
    plan = msm_tpu_torch.plan(pts, config=cfg, device="cpu")
    words = common.ints_to_u16_array(ks)
    assert words.shape == (n, 16)
    jax = j_compute_msm(pts, ks, J_MsmConfig(curve=J_CURVES[name], chunk_size=8))
    assert got == want
    assert plan(words) == want
    assert tuple(jax) == want


@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_plain_path_matches_jax_and_oracle(name):
    check_curve_msm(name)


def test_compressed_batch_rule_takes_the_config_limbs():
    """The pe3 row is 3 L int32 limbs of the config: at 2^22 points a
    30-limb config's 360-byte rows halve the compressed launch's subtasks
    where BN254's 240-byte rows keep 16, and every batch stays within the
    cap."""
    cfg = MsmConfig(curve=BLS12_381, compress=True)
    bn254 = MsmConfig(curve=BN254, compress=True)
    assert geometry.pe3_row_bytes(cfg) == 360 and geometry.pe3_row_bytes(bn254) == 240
    n = 1 << 22
    bls = geometry.pick_geometry(n, cfg)
    bn = geometry.pick_geometry(n, bn254)
    assert (bn.subtask_batch, bls.subtask_batch) == (16, 8)
    for logn in range(4, 25):
        g = geometry.pick_geometry(1 << logn, cfg)
        assert g.subtask_batch * (1 << logn) // 2 * 360 <= geometry.PE3_BYTES_MAX
        assert g.subtask_batch == geometry.compressed_batch(1 << logn, cfg)


def test_naive_model_refuses_other_curves_on_cuda():
    """The naive model takes every curve on the card as on the CPU (the JAX
    package's refuses only GLV): on another curve it gets past the config
    checks to the convert kernel's launch, which stops at the check for
    CUDA tensors on meta tensors (they stand for the card's here), and the
    CPU twins give the oracle's result."""
    from msm_tpu_torch.models.naive import compute_msm_naive

    cfg = MsmConfig(curve=BLS12_381, chunk_size=8)
    pts = affine_points(cfg, 4, seed=3)
    with pytest.raises(ValueError, match="expected tensors on one CUDA device, got meta"):
        compute_msm_naive(pts, [1, 2, 3, 4], config=cfg, device="meta")
    cv = Curve(cfg.curve)
    want = cv.to_affine(cv.msm([cv.from_affine(*p) for p in pts], [1, 2, 3, 4]))
    assert cv.to_affine(compute_msm_naive(pts, [1, 2, 3, 4], config=cfg, device="cpu")) == want


@pytest.mark.parametrize("name", ["bls12_381", "secp256k1"])
def test_bn254_only_kernels_refuse_other_curves(name):
    """require_cuda, which every wrapper calls before a launch, takes every
    curve's plain config since no kernel runs BN254 alone: it has no curve
    refusal left (no bn254_only) and asks only for CUDA tensors."""
    import inspect

    import torch

    from msm_tpu_torch.ops._build import require_cuda

    assert "bn254_only" not in inspect.signature(require_cuda).parameters
    cfg = MsmConfig(curve=CURVES[name])
    t = torch.zeros((4, cfg.num_words), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        require_cuda(cfg, t)
