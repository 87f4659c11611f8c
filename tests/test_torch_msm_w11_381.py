"""BLS12-381 pair-compressed at 11-bit limbs on the CPU
(``MsmConfig(word_size=11)``: L = 36, R = 2^396, TAIL 12):
``run_gpu_msm(device="cpu")`` and a plan's words call at chunk 8 over 40
points (P beside phi(P); lambda, r - lambda, 0, 1, r - 1 among the
scalars), held bit for bit against the JAX package's
``compute_msm_jpoint`` at word_size 11 and the oracle
(test_torch_msm_curves_compress.check_curve_config). One config a file: the
8-bit one is in ``test_torch_msm_w8.py``."""

from test_torch_msm_curves_compress import check_curve_config


def test_bls12_381_compressed_width11_matches_jax_and_oracle():
    check_curve_config("bls12_381", compress=True, glv=False, word_size=11)
