"""BN254 plain at 8-bit limbs on the CPU (``MsmConfig(word_size=8)``: L =
33, R = 2^264, the narrow library's widest BN254 row): ``run_gpu_msm(device
="cpu")`` and a plan's words call at chunk 8 over 40 points (P beside
phi(P); lambda, r - lambda, 0, 1, r - 1 among the scalars), held bit for
bit against the JAX package's ``compute_msm_jpoint`` at word_size 8 and the
oracle (test_torch_msm_curves_compress.check_curve_config). One config a
file: the 11-bit one is in ``test_torch_msm_w11_381.py``, and
``test_torch_msm_narrow_oracle.py`` holds widths 8 to 11 against the oracle
alone."""

from test_torch_msm_curves_compress import check_curve_config


def test_bn254_plain_width8_matches_jax_and_oracle():
    check_curve_config("bn254", compress=False, glv=False, word_size=8)
