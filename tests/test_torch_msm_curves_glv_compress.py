"""The GLV compressed configuration of the six curves besides BN254 on the
CPU: ``run_gpu_msm(device="cpu")`` and a plan's words call at chunk 8 over
40 points (P beside phi(P): equal x across the GLV table's halves in the
pair stream; lambda, r - lambda, 0, 1, r - 1 among the scalars), held bit
for bit against the JAX package's ``compute_msm_jpoint`` and the oracle
(test_torch_msm_curves_compress.check_curve_config)."""

import pytest

from test_torch_msm_curves_compress import OTHER_CURVES, check_curve_config


@pytest.mark.parametrize("name", OTHER_CURVES)
def test_glv_compressed_path_matches_jax_and_oracle(name):
    check_curve_config(name, compress=True, glv=True)
