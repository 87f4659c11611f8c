"""msm_tpu_torch's batched MSM (models/batched.py, run_gpu_msm_batched) on
the CPU against the JAX package's compute_msm_batched and the oracle: three
instances of 40, 48 and 56 points at chunk 8 (padded to one size), the
empty batch, and instances of other sizes (one empty) under the GLV
compressed config; pad_inputs' multiple= floor against the JAX package's."""

import numpy as np
import pytest

from _torch_helpers import affine_points, port_cfg
import msm_tpu_torch
from msm_tpu.models import common as jcommon
from msm_tpu.models.batched import compute_msm_batched as j_compute_msm_batched
from msm_tpu.oracle.pyecc import Curve as JCurve
from msm_tpu.params import BN254 as JBN254
from msm_tpu.params import MsmConfig as JMsmConfig
from msm_tpu_torch.models import common
from msm_tpu_torch.models.batched import compute_msm_batched
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254, MsmConfig

JCFG = JMsmConfig(curve=JBN254, chunk_size=8)
CFG = port_cfg(JCFG)
CV = Curve(BN254)


def _instance(n, seed):
    rng = np.random.default_rng(seed)
    return affine_points(CFG, n, seed=seed), [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]


def test_batched_msm_matches_jax_and_oracle():
    instances = [_instance(40 + 8 * i, seed=10 + i) for i in range(3)]
    got = compute_msm_batched(instances, CFG, device="cpu")
    want = j_compute_msm_batched(instances, JCFG)
    jcv = JCurve(JBN254)
    for (pts, ks), g, w in zip(instances, got, want):
        assert CV.eq(g, best_msm(pts, ks))
        assert CV.to_affine(g) == jcv.to_affine(w)


def test_batched_empty():
    assert msm_tpu_torch.run_gpu_msm_batched([], CFG, device="cpu") == []


def test_batched_glv_compressed_mixed_sizes():
    cfg = MsmConfig(curve=BN254, chunk_size=8, compress=True, glv=True)
    instances = [_instance(20, seed=20), ([], []), _instance(33, seed=21)]
    got = msm_tpu_torch.run_gpu_msm_batched(instances, cfg, device="cpu")
    assert len(got) == 3 and got[1].is_identity()
    for (pts, ks), g in zip(instances, got):
        assert CV.eq(g, best_msm(pts, ks))


@pytest.mark.parametrize("n,multiple", [(20, 1), (20, 56), (40, 17), (0, 0)])
def test_pad_inputs_multiple_matches_jax(n, multiple):
    pts, ks = _instance(n, seed=30)
    x, y, s = common.pad_inputs(pts, ks, CFG, multiple=multiple)
    jx, jy, js = jcommon.pad_inputs(pts, ks, JCFG, multiple=multiple)
    assert x.shape[0] == jx.shape[0] == common.pad_size(max(n, multiple))
    assert np.array_equal(x.view(np.uint16), jx) and np.array_equal(y.view(np.uint16), jy)
    assert np.array_equal(s, js)
