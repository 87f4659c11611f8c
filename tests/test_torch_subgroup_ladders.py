"""The curve ladders of ops/curve.py on the CPU against the JAX package
and the oracle, on BLS12-381's points of test_torch_subgroup._inputs (4
of the subgroup, 3 outside it, the generator padding): scalar_mul_static
by a 41-bit scalar (the subgroup check runs it with the unreduced r),
double_and_add over per-point 16-bit scalars and to_affine_mont."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import canon, same_points
from msm_tpu.models.common import u16_to_mont_points as j_u16_to_mont_points
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx
from msm_tpu_torch.oracle.pyecc import Curve
from test_torch_subgroup import _inputs, _port_points


def test_ladders_and_to_affine_match_jax():
    """scalar_mul_static by k = 2^40 + 0x1234567 and double_and_add over
    per-point 16-bit scalars (0, 1 and 2^16 - 1 among them) on BLS12-381's
    points of _inputs, as points against the JAX package's, then the affine
    form by Fermat inversion against the JAX package's and the oracle's."""
    cfg, jcfg, pts, x_u16, y_u16 = _inputs("bls12_381")
    ec, jec = get_curve_ctx(cfg), j_curve_ctx(jcfg)
    cv, q = Curve(cfg.curve), cfg.curve.modulus
    port_pts = _port_points(cfg, x_u16, y_u16)
    j_pts = j_u16_to_mont_points(jec, jnp.asarray(x_u16.astype(np.int32) & 0xFFFF),
                                 jnp.asarray(y_u16.astype(np.int32) & 0xFFFF))
    k_static = (1 << 40) + 0x1234567
    got = ec.scalar_mul_static(port_pts, k_static)
    assert same_points([np.asarray(a) for a in jec.scalar_mul_static(j_pts, k_static)], [a.numpy() for a in got], cfg)
    rinv = pow(cfg.r, -1, q)
    x, y = ec.to_affine_mont(PointBatch(*(a[4:5] for a in got)))  # the needle, outside the subgroup
    want = cv.to_affine(cv.scalar_mul(cv.from_affine(*pts[4]), k_static))
    assert (int(canon(x.numpy(), cfg)[0]) * rinv % q, int(canon(y.numpy(), cfg)[0]) * rinv % q) == want

    k = np.array([0, 1, 0xFFFF] + list(np.random.default_rng(201).integers(0, 1 << 16, size=13)), np.int32)
    got = ec.double_and_add(port_pts, torch.from_numpy(k), 16)
    j_got = jec.double_and_add(j_pts, jnp.asarray(k), 16)
    assert same_points([np.asarray(a) for a in j_got], [a.numpy() for a in got], cfg)
    for i in (1, 2, 5):
        want = cv.to_affine(cv.scalar_mul(cv.from_affine(*pts[i % len(pts)]), int(k[i])))
        x, y = ec.to_affine_mont(PointBatch(*(a[i:i + 1] for a in got)))
        jx, jy = jec.to_affine_mont(type(j_got)(*(a[i:i + 1] for a in j_got)))
        assert (int(canon(x.numpy(), cfg)[0]) * rinv % q, int(canon(y.numpy(), cfg)[0]) * rinv % q) == want
        assert canon(x.numpy(), cfg)[0] == canon(np.asarray(jx), cfg)[0]
        assert canon(y.numpy(), cfg)[0] == canon(np.asarray(jy), cfg)[0]
    assert got.z.shape == (16, cfg.num_words)
    assert ec.is_identity(got)[0] and not ec.is_identity(got)[1:].any()
