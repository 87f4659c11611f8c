"""The subgroup check of the curves of cofactor > 1 (BLS12-381, BLS12-377)
on the CPU, against the JAX package and the oracle:

- the mask (models.common.subgroup_mask_device: [r]P == O by
  CurveCtx.scalar_mul_static with the unreduced r) against the JAX
  subgroup_mask_device and the oracle's Curve.in_subgroup, on 7 (BLS12-377:
  10) points padded to 16 with the generator: points of the subgroup, the
  curve's smallest-x point outside it (on BLS12-381 the needle
  tests/test_msm_e2e.py finds) and two more outside it;
- on BLS12-377, whose cofactor is even, also its points of small order:
  (2, 3) of order 6, (0, 1) of order 3 and (-1, 0) of order 2. The
  complete formulas give (0 : 0 : 0) where P - Q has order 2, and the
  port's mask takes that for no identity, so it rejects all three, as the
  oracle does; the JAX mask tests Z alone and passes (2, 3) and (-1, 0),
  a fault of the reference that the port does not copy (the test pins it
  so that a change on either side shows); BLS12-377's batch runs as two
  passes of the ladder (SUBGROUP_ROWS set to 8).

The ladders' own checks (scalar_mul_static, double_and_add,
to_affine_mont) are in test_torch_subgroup_ladders.py.

check_validate (the entry points' validate=True) runs in
test_torch_subgroup_plan.py, _377.py and _377_plan.py, and BLS12-381's
run_gpu_msm in test_torch_msm_edges.py: each ladder costs ~20 s on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msm_tpu_torch
from _torch_helpers import affine_points, port_cfg
from msm_tpu.models.common import subgroup_mask_device as j_subgroup_mask
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.models import common
from msm_tpu_torch.ops.cuda_convert import convert_pack_plain, unpack_coords
from msm_tpu_torch.ops.curve import get_curve_ctx
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import CURVES, MsmConfig, coord_words

SMALL_ORDER_377 = [(2, 3), (0, 1), (-1, 0)]  # orders 6, 3, 2 (y^2 = x^3 + 1)


def _inputs(name: str):
    """(port config, JAX config, affine points, u16 words [16, W] x2)."""
    jcfg = J_MsmConfig(curve=J_CURVES[name], chunk_size=8)
    cfg = port_cfg(jcfg)
    cv, q = Curve(cfg.curve), cfg.curve.modulus
    pts = affine_points(cfg, 4, seed=200)
    # BLS12-377's smallest-x point outside is (2, 3), of order 6: in SMALL_ORDER_377
    needle = cv.first_point_outside_subgroup(3 if name == "bls12_377" else 2)
    pts += [needle, cv.first_point_outside_subgroup(needle[0] + 1), cv.first_point_outside_subgroup(100)]
    if name == "bls12_377":
        pts += [(x % q, y) for x, y in SMALL_ORDER_377]
    x_u16, y_u16 = common.pad_points_words(pts, cfg, 16)
    return cfg, jcfg, pts, x_u16, y_u16


def _port_points(cfg, x_u16, y_u16):
    packed = convert_pack_plain(cfg, *map(torch.from_numpy, (x_u16, y_u16)))
    D = coord_words(cfg)
    return get_curve_ctx(cfg).from_affine_mont(unpack_coords(packed[:, :D], cfg), unpack_coords(packed[:, D:], cfg))


@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_subgroup_ladder_and_mask_match_jax_and_oracle(name, monkeypatch):
    if name == "bls12_377":
        monkeypatch.setattr(common, "SUBGROUP_ROWS", 8)
    cfg, jcfg, pts, x_u16, y_u16 = _inputs(name)
    cv, n = Curve(cfg.curve), len(pts)
    want = np.array([cv.in_subgroup(cv.from_affine(*p)) for p in pts] + [True] * (16 - n))
    assert want[:4].all() and not want[4:n].any()
    mask = common.subgroup_mask_device(x_u16, y_u16, cfg, device="cpu")
    assert mask.dtype == torch.bool and np.array_equal(mask.numpy(), want)

    j_mask = np.asarray(j_subgroup_mask(jnp.asarray(x_u16.astype(np.int32) & 0xFFFF),
                                        jnp.asarray(y_u16.astype(np.int32) & 0xFFFF), jcfg))
    faulty = np.zeros(16, bool)
    if name == "bls12_377":  # (2, 3) and (-1, 0): the reference's Z-only identity test
        faulty[[7, 9]] = True
    assert np.array_equal(j_mask[~faulty], want[~faulty]) and j_mask[faulty].all()


def check_validate(name: str, entry: str) -> None:
    """``entry`` (run_gpu_msm or plan) with validate=True on 6 points of a
    curve of cofactor > 1 (chunk 8): the result (the plan's ints call)
    equals the oracle's; with the curve's smallest-x point outside the
    subgroup at index 3 (on BLS12-377 (2, 3), of order 6) it raises
    ValueError naming index 3 and the cofactor."""
    cfg = MsmConfig(curve=CURVES[name], chunk_size=8)
    cv = Curve(cfg.curve)
    pts = affine_points(cfg, 6, seed=202)
    ks = cv.sample_scalars(6, seed=203)

    def run(points):
        if entry == "plan":
            return msm_tpu_torch.plan(points, config=cfg, validate=True, device="cpu").jpoint(ks)
        return cv.from_affine(*msm_tpu_torch.run_gpu_msm(points, ks, config=cfg, validate=True, device="cpu"))

    assert cv.eq(run(pts), cv.msm([cv.from_affine(*p) for p in pts], ks))
    pts[3] = cv.first_point_outside_subgroup()
    with pytest.raises(ValueError, match=rf"^point 3 is outside the prime-order subgroup \(cofactor {cfg.curve.cofactor}\)$"):
        run(pts)
