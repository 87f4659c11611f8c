"""The naive Pippenger model on BLS12-381, BLS12-377 and Grumpkin (Pallas,
Vesta and secp256k1: test_torch_naive_curves_pasta.py), on the CPU
(compute_msm_naive with device="cpu": every kernel replaced by its plain
twin), against the JAX package's compute_msm_naive and the oracle: 17
points (padded to 32) with a duplicate, the scalars 0, 1 and r - 1 among
random ones, at 4-bit unsigned windows (the running-sum reduction's 2 (B -
1) serial point adds stay few on the CPU; the card runs the model's 8-bit
windows in chip_smoke.py). The port's CUDA path takes these curves too: a
GLV config is the only one it refuses, as the JAX package's model
asserts."""

import dataclasses

import pytest

from _torch_helpers import affine_points, port_cfg
from msm_tpu.models.naive import compute_msm_naive as j_compute_msm_naive
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.models.naive import compute_msm_naive
from msm_tpu_torch.oracle.pyecc import Curve

OTHER_CURVES = ["bls12_381", "bls12_377", "grumpkin", "pallas", "vesta", "secp256k1"]


def check_naive_msm(name: str) -> None:
    jcfg = J_MsmConfig(curve=J_CURVES[name], chunk_size=4)
    cfg = port_cfg(jcfg)
    cv, r = Curve(cfg.curve), cfg.curve.order
    pts = affine_points(cfg, 16, seed=190 + OTHER_CURVES.index(name))
    pts.append(pts[3])
    ks = [0, 1, r - 1] + [cv.sample_scalars(14, seed=191)[i] % r for i in range(14)]
    got = compute_msm_naive(pts, ks, config=cfg, device="cpu")
    want = cv.msm([cv.from_affine(*p) for p in pts], ks)
    assert cv.eq(got, want) and not want.is_identity()
    assert cv.eq(j_compute_msm_naive(pts, ks, config=jcfg), want)


def test_naive_model_refuses_glv_on_every_device():
    cfg = dataclasses.replace(port_cfg(J_MsmConfig(curve=J_CURVES["bls12_381"])), glv=True)
    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="GLV"):
            compute_msm_naive(affine_points(cfg, 2, seed=3), [1, 2], config=cfg, device=device)


@pytest.mark.parametrize("name", OTHER_CURVES[:3])
def test_naive_msm_matches_jax_and_oracle(name):
    check_naive_msm(name)
