"""msm_tpu_torch's serving plan on the CPU against the port's own
per-call pipeline (compute_msm_jpoint, at n = 33: the padding) and the
oracle on the compressed, GLV and GLV compressed configs, each with int
and u16-word scalar sets in one run_batch (chunk 8, n = 40 padded to 64).
The JAX package's GLV plan runs only in its slow tier, so the GLV plans
are held against the oracle and the port's compute_msm."""

import numpy as np
import pytest

from _torch_helpers import affine_points
import msm_tpu_torch
from msm_tpu_torch.models import common
from msm_tpu_torch.models.cuzk import compute_msm, compute_msm_jpoint
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254, MsmConfig

CFG = MsmConfig(curve=BN254, chunk_size=8)
CV = Curve(BN254)
R = BN254.order


def _scalars(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(count)]


def test_plan_matches_per_call_pipeline():
    pts, ks = affine_points(CFG, 33, seed=7), _scalars(33, 57)
    got = msm_tpu_torch.plan(pts, config=CFG, device="cpu").jpoint(ks)
    want = compute_msm_jpoint(pts, ks, config=CFG, device="cpu")
    assert CV.eq(got, want) and CV.eq(got, best_msm(pts, ks))


@pytest.mark.parametrize("compress,glv", [(True, False), (False, True), (True, True)],
                         ids=["compressed", "glv", "glv_compressed"])
def test_plan_config_matches_oracle(compress, glv):
    cfg = MsmConfig(curve=BN254, chunk_size=8, compress=compress, glv=glv)
    pts, ks1, ks2 = affine_points(cfg, 40, seed=13), _scalars(40, 60), _scalars(40, 61)
    plan = msm_tpu_torch.plan(pts, config=cfg, device="cpu")
    got = plan.run_batch([ks1, common.ints_to_u16_array(ks2)])
    assert CV.eq(got[0], best_msm(pts, ks1)) and CV.eq(got[1], best_msm(pts, ks2))
    if glv and not compress:
        assert CV.to_affine(got[0]) == compute_msm(pts, ks1, config=cfg, device="cpu")
