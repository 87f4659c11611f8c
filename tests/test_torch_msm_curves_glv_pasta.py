"""The GLV configuration of Pallas and Vesta on the CPU:
``run_gpu_msm(device="cpu")`` and a plan's words call at chunk 8 over 40
points (P beside phi(P); lambda, r - lambda, 0, 1, r - 1 among the
scalars), held bit for bit against the JAX package's
``compute_msm_jpoint`` and the oracle
(test_torch_msm_curves_compress.check_curve_config). The other curves:
test_torch_msm_curves_glv.py and test_torch_msm_curves_glv_256.py."""

import pytest

from test_torch_msm_curves_compress import check_curve_config

CURVES = ["pallas", "vesta"]


@pytest.mark.parametrize("name", CURVES)
def test_glv_path_matches_jax_and_oracle(name):
    check_curve_config(name, compress=False, glv=True)
