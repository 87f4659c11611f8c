"""The GLV compressed configuration of Grumpkin and secp256k1 on the CPU:
``run_gpu_msm(device="cpu")`` and a plan's words call at chunk 8 over 40
points (P beside phi(P): equal x across the GLV table's halves in the pair
stream; lambda, r - lambda, 0, 1, r - 1 among the scalars), held bit for
bit against the JAX package's ``compute_msm_jpoint`` and the oracle
(test_torch_msm_curves_compress.check_curve_config). The other curves:
test_torch_msm_curves_glv_compress.py and
test_torch_msm_curves_glv_compress_pasta.py."""

import pytest

from test_torch_msm_curves_compress import check_curve_config

CURVES = ["grumpkin", "secp256k1"]


@pytest.mark.parametrize("name", CURVES)
def test_glv_compressed_path_matches_jax_and_oracle(name):
    check_curve_config(name, compress=True, glv=True)
