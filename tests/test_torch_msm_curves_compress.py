"""The compressed configuration of the six curves besides BN254 on the CPU:
``run_gpu_msm(device="cpu")`` and a plan's words call at chunk 8 over 40
points, held bit for bit against the JAX package's ``compute_msm_jpoint``
(its Pallas kernels as its own tests run them on the CPU) and the oracle.
The points hold P beside phi(P) = (beta x, y), the scalars lambda,
r - lambda, 0, 1 and r - 1 besides uniform ones. The GLV and GLV compressed
configurations are in ``test_torch_msm_curves_glv.py`` and
``test_torch_msm_curves_glv_compress.py``."""

import numpy as np
import pytest

import msm_tpu_torch
from _torch_helpers import affine_points
from msm_tpu.models.cuzk import compute_msm_jpoint as j_compute_msm_jpoint
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.models import common
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import CURVES, MsmConfig

#: the six curves besides BN254
OTHER_CURVES = ["bls12_381", "bls12_377", "grumpkin", "pallas", "vesta", "secp256k1"]


def config_inputs(name: str, n: int, seed: int):
    """(points, scalars) of one curve: 12 random points each beside its
    phi image (equal x across a GLV table's halves: doubling and infinity
    pairs in the compressed stream), the rest random; lambda, r - lambda,
    0, 1, r - 1, then uniform scalars below r."""
    spec = CURVES[name]
    g, q, r = glv_params(spec), spec.modulus, spec.order
    base = affine_points(MsmConfig(curve=spec), n - 12, seed=seed)
    pts = [p for x, y in base[:12] for p in ((x, y), (x * g.beta % q, y))] + base[12:]
    raw = np.random.default_rng(seed + 1).bytes(32 * n)
    ks = [g.lam, r - g.lam, 0, 1, r - 1]
    ks += [int.from_bytes(raw[i:i + 32], "little") % r for i in range(0, 32 * (n - len(ks)), 32)]
    return pts[:n], ks


def check_curve_config(name: str, compress: bool, glv: bool, n: int = 40, seed: int = 90,
                       word_size: int = 13) -> None:
    """One curve on a config at chunk 8 and ``word_size``-bit limbs:
    run_gpu_msm and a plan's words call against compute_msm_jpoint and the
    oracle, exact."""
    cfg = MsmConfig(curve=CURVES[name], chunk_size=8, compress=compress, glv=glv, word_size=word_size)
    pts, ks = config_inputs(name, n, seed)
    cv = Curve(cfg.curve)
    want = cv.msm([cv.from_affine(*p) for p in pts], ks)
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device="cpu")
    plan = msm_tpu_torch.plan(pts, config=cfg, device="cpu")
    words = common.ints_to_u16_array(ks)
    jax = j_compute_msm_jpoint(pts, ks, J_MsmConfig(curve=J_CURVES[name], chunk_size=8, compress=compress,
                                                    glv=glv, word_size=word_size))
    assert got == cv.to_affine(want)
    assert plan(words) == cv.to_affine(want)
    assert cv.eq(jax, want)


@pytest.mark.parametrize("name", OTHER_CURVES)
def test_compressed_path_matches_jax_and_oracle(name):
    check_curve_config(name, compress=True, glv=False)
