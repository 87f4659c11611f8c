"""The narrow limb widths 8 to 11 on the CPU against the oracle alone (no
JAX compile): ``run_gpu_msm(device="cpu")`` and a plan's words call at
chunk 8 over 16 points, bit for bit, on BN254 plain and on BLS12-377 under
GLV, pair-compressed (TAIL 0 at width 8: R = 2^(32 NW); L = 48 at 8, 35
at 11). The points hold P beside phi(P) = (beta x, y), the scalars
lambda, r - lambda, 0, 1 and r - 1 besides uniform ones. The JAX package
holds BN254 plain at 8 (``test_torch_msm_w8.py``) and BLS12-381
compressed at 11 (``test_torch_msm_w11_381.py``)."""

import numpy as np
import pytest

import msm_tpu_torch
from _torch_helpers import affine_points
from msm_tpu_torch.models import common
from msm_tpu_torch.ops.glv import glv_params
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import CURVES, MsmConfig

#: (curve, compress, glv) of each config
CONFIGS = {"bn254_plain": ("bn254", False, False), "bls12_377_glv_compressed": ("bls12_377", True, True)}


def _inputs(name: str, n: int, seed: int):
    """(points, scalars): 6 random points each beside its phi image, the
    rest random; lambda, r - lambda, 0, 1, r - 1, then uniform scalars."""
    spec = CURVES[name]
    g, q, r = glv_params(spec), spec.modulus, spec.order
    base = affine_points(MsmConfig(curve=spec), n - 6, seed=seed)
    pts = [p for x, y in base[:6] for p in ((x, y), (x * g.beta % q, y))] + base[6:]
    raw = np.random.default_rng(seed + 1).bytes(32 * n)
    ks = [g.lam, r - g.lam, 0, 1, r - 1]
    ks += [int.from_bytes(raw[i:i + 32], "little") % r for i in range(0, 32 * (n - len(ks)), 32)]
    return pts[:n], ks


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("width", [8, 9, 10, 11])
def test_narrow_width_matches_oracle(width, config):
    name, compress, glv = CONFIGS[config]
    cfg = MsmConfig(curve=CURVES[name], chunk_size=8, compress=compress, glv=glv, word_size=width)
    pts, ks = _inputs(name, 16, 95 + width)
    cv = Curve(cfg.curve)
    want = cv.to_affine(cv.msm([cv.from_affine(*p) for p in pts], ks))
    assert msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device="cpu") == want
    plan = msm_tpu_torch.plan(pts, config=cfg, device="cpu")
    assert plan(common.ints_to_u16_array(ks)) == want
