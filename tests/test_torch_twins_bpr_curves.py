"""The blocked bucket reduction (kernel 8's twin, then the blocked tail's
point adds, point totals and Horner fold) on the six curves besides BN254,
on the CPU, against the JAX package's bucket_reduce_blocked: two subtasks
of 1 + T Bl = 33 buckets (T = 8 lanes of Bl = 4) of real points of the
curve in random projective form, an identity bucket planted in each. The
two packages sum in other orders, and the complete formulas are a group
law only on the curve, so the window sums compare as points, by
cross-multiplication; each also against the oracle's sum of b S_b."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, mont_limbs, port_cfg, same_points
from msm_tpu.ops import scan as jscan
from msm_tpu.ops.curve import PointBatch as JPB
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.models.common import mont_rows_to_ints
from msm_tpu_torch.ops import scan
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx
from msm_tpu_torch.oracle.pyecc import IDENTITY, Curve

OTHER_CURVES = ["bls12_381", "bls12_377", "grumpkin", "pallas", "vesta", "secp256k1"]
T, Bl = 8, 4


def _buckets(cfg, nb: int, seed: int, identity_at: int):
    """nb buckets of real points (x z : y z : z), the identity at
    ``identity_at``: (port limbs [nb, L] x3, the oracle's sum of b S_b)."""
    cv, p = Curve(cfg.curve), cfg.curve.modulus
    aff = affine_points(cfg, nb, seed)
    zs = [int(v) for v in np.random.default_rng(seed).integers(1, 2**62, size=nb)]
    xs = [x * z % p for (x, _), z in zip(aff, zs)]
    ys = [y * z % p for (_, y), z in zip(aff, zs)]
    xs[identity_at], ys[identity_at], zs[identity_at] = 0, 1, 0
    want = IDENTITY
    for b, pt in enumerate(aff):
        if b != identity_at:
            want = cv.add(want, cv.scalar_mul(cv.from_affine(*pt), b))
    return [mont_limbs(v, cfg) for v in (xs, ys, zs)], want


@pytest.mark.parametrize("name", OTHER_CURVES)
def test_blocked_reduce_matches_jax_and_oracle(name):
    jcfg = J_MsmConfig(curve=J_CURVES[name])
    cfg = port_cfg(jcfg)
    cv, p = Curve(cfg.curve), cfg.curve.modulus
    subtasks = [_buckets(cfg, 1 + T * Bl, seed=170 + 2 * OTHER_CURVES.index(name) + s, identity_at=s + 2)
                for s in range(2)]
    port = PointBatch(*(torch.from_numpy(np.stack([b[0][i] for b in subtasks])) for i in range(3)))
    got = scan.bucket_reduce_blocked(get_curve_ctx(cfg), port, T)
    assert got.x.shape == (2, cfg.num_words)
    jec = j_curve_ctx(jcfg)
    j_reduce = jax.jit(lambda x, y, z: jscan.bucket_reduce_blocked(jec, JPB(x, y, z), T))
    for s, (limbs, want) in enumerate(subtasks):
        j_got = j_reduce(*map(jnp.asarray, limbs))
        assert same_points([np.asarray(a) for a in j_got], [a[s].numpy() for a in got], cfg)
        x, y, z = mont_rows_to_ints(np.stack([a[s].numpy() for a in got]), cfg)
        assert z != 0 and (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p) == cv.to_affine(want)
