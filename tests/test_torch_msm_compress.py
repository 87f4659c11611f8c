"""The pair-compressed slice on the CPU (run_gpu_msm with device="cpu" and
``compress=True``: every kernel replaced by its plain twin) against the JAX
package and the oracle: at n = 256 (chunk 8) against ``msm_tpu.run_tpu_msm``
and the oracle, and at n = 2^12 against the oracle. The machinery around
the compressed scan is tested in ``test_torch_compress_prefix.py``."""

import numpy as np

from _torch_helpers import affine_points, port_cfg
import msm_tpu
import msm_tpu_torch
from msm_tpu.oracle import best_msm
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models.geometry import pick_geometry

JCFG = MsmConfig(curve=BN254, chunk_size=8, compress=True)
CFG = port_cfg(JCFG)
CV = Curve(BN254)


def _inputs(n, seed, nbase=64):
    base = affine_points(CFG, nbase, seed=seed)
    pts = [base[i % nbase] for i in range(n)]
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(n)]
    return pts, ks


def test_compressed_slice_matches_jax_and_oracle():
    n = 256
    pts, ks = _inputs(n, seed=91)
    want = CV.to_affine(best_msm(pts, ks))
    assert msm_tpu_torch.run_gpu_msm(pts, ks, config=CFG, device="cpu") == want
    assert msm_tpu.run_tpu_msm(pts, ks, config=JCFG) == want


def test_compressed_slice_matches_oracle_4096():
    n = 1 << 12
    pts, ks = _inputs(n, seed=92, nbase=256)
    geo = pick_geometry(n, CFG)
    assert (geo.num_rows, geo.subtask_batch) == (512, 16)  # C = 8 steps, 16 subtasks a launch
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=CFG, device="cpu")
    assert got == CV.to_affine(best_msm(pts, ks))
