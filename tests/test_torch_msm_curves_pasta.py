"""The port's plain path on the CPU for Pallas and Vesta (21 limbs, 8 words
an element, a 17-bit last REDC step): ``run_gpu_msm(device="cpu")`` and a
plan's words call against the JAX package's ``compute_msm`` and the
oracle, bit for bit (test_torch_msm_curves.check_curve_msm)."""

import pytest

from test_torch_msm_curves import check_curve_msm


@pytest.mark.parametrize("name", ["pallas", "vesta"])
def test_plain_path_matches_jax_and_oracle(name):
    check_curve_msm(name)
