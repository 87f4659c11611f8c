"""The port's plain path on the CPU for secp256k1 (a 256-bit field with no
slack: 17 windows at chunk 16, the word core's carry word) and Grumpkin
(BN254's partner, 3b = -51): ``run_gpu_msm(device="cpu")`` and a plan's
words call against the JAX package's ``compute_msm`` and the oracle, bit
for bit (test_torch_msm_curves.check_curve_msm)."""

import pytest

from test_torch_msm_curves import check_curve_msm


@pytest.mark.parametrize("name", ["secp256k1", "grumpkin"])
def test_plain_path_matches_jax_and_oracle(name):
    check_curve_msm(name)
