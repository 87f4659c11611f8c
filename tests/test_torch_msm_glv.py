"""The GLV slice on the CPU, plain (run_gpu_msm with device="cpu" and a GLV
config: every kernel replaced by its plain twin, the GLV modes included)
against the JAX package's compute_msm_jpoint (its XLA pipeline on the CPU)
and the oracle, at n = 2^12, chunk 8, R = 256 lanes; and a GLV MSM on
another a = 0 curve (Pallas) against the oracle. The pair-compressed GLV
slice is in test_torch_msm_glv_compress.py."""

from _torch_helpers import port_cfg, tiled_msm_inputs
import msm_tpu_torch
from msm_tpu.models.cuzk import compute_msm_jpoint as j_compute_msm_jpoint
from msm_tpu.models.geometry import MsmGeometry as JGeometry
from msm_tpu.oracle.pyecc import Curve as JCurve
from msm_tpu.params import BN254, PALLAS, MsmConfig
from msm_tpu_torch.models.cuzk import compute_msm_jpoint
from msm_tpu_torch.models.geometry import MsmGeometry
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve


def test_glv_slice_matches_jax_and_oracle():
    jcfg = MsmConfig(curve=BN254, chunk_size=8, glv=True)
    cfg = port_cfg(jcfg)
    pts, ks = tiled_msm_inputs(cfg, 1 << 12, seed=22)
    got = compute_msm_jpoint(pts, ks, config=cfg, geometry=MsmGeometry(256, 64, 4), device="cpu")
    cv = Curve(cfg.curve)
    assert cv.eq(got, best_msm(pts, ks))
    want = j_compute_msm_jpoint(pts, ks, config=jcfg, geometry=JGeometry(256, 64, 4))
    assert cv.to_affine(got) == JCurve(jcfg.curve).to_affine(want)


def test_glv_msm_on_pallas_matches_oracle():
    cfg = port_cfg(MsmConfig(curve=PALLAS, chunk_size=8, glv=True))
    pts, ks = tiled_msm_inputs(cfg, 64, seed=14, nbase=29)
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=cfg, device="cpu")
    assert got == Curve(cfg.curve).to_affine(best_msm(pts, ks, curve=cfg.curve))
