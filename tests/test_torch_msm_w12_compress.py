"""BN254 pair-compressed at 12-bit limbs on the CPU
(``MsmConfig(word_size=12)``): ``run_gpu_msm(device="cpu")`` and a plan's
words call at chunk 8 over 40 points (P beside phi(P); lambda, r - lambda,
0, 1, r - 1 among the scalars), held bit for bit against the JAX package's
``compute_msm_jpoint`` at word_size 12 and the oracle
(test_torch_msm_curves_compress.check_curve_config). One config a file: the
others are in the other ``test_torch_msm_w12*.py`` files."""

from test_torch_msm_curves_compress import check_curve_config


def test_bn254_compressed_width12_matches_jax_and_oracle():
    check_curve_config("bn254", compress=True, glv=False, word_size=12)
