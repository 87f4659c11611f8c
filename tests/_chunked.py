"""Shared inputs of the chunked-MSM tests: 100 random points and scalars
(padded to 128 rows, two chunks of CHUNK_MAX = 64), their oracle MSM, and
the JAX package's compute_msm_jpoint on them with its CHUNK_MAX and SLICE
shrunk the same way (two host chunks of two device slices)."""

import numpy as np
import pytest

from _torch_helpers import affine_points
import msm_tpu.models.cuzk as jcuzk
from msm_tpu.params import BN254 as J_BN254
from msm_tpu.params import MsmConfig as JMsmConfig
from msm_tpu_torch.models import cuzk
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254, MsmConfig

N_POINTS, CAP = 100, 64
CFG = MsmConfig(curve=BN254, chunk_size=8)
CV = Curve(BN254)


def inputs(seed: int):
    """(points, scalars, oracle JPoint, the JAX package's chunked JPoint)."""
    pts = affine_points(CFG, N_POINTS, seed=seed)
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254.order for _ in range(N_POINTS)]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jcuzk, "CHUNK_MAX", CAP)
        m.setattr(jcuzk, "SLICE", CAP // 2)
        jax_res = jcuzk.compute_msm_jpoint(pts, ks, JMsmConfig(curve=J_BN254, chunk_size=8))
    return pts, ks, best_msm(pts, ks), jax_res


@pytest.fixture
def small_cap(monkeypatch):
    """The port's one-pass cap shrunk to CAP points."""
    monkeypatch.setattr(cuzk, "CHUNK_MAX", CAP)
