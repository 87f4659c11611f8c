"""The naive Pippenger model on Pallas, Vesta and secp256k1, on the CPU,
against the JAX package's compute_msm_naive and the oracle
(test_torch_naive_curves.check_naive_msm)."""

import pytest

from test_torch_naive_curves import OTHER_CURVES, check_naive_msm


@pytest.mark.parametrize("name", OTHER_CURVES[3:])
def test_naive_msm_matches_jax_and_oracle(name):
    check_naive_msm(name)
