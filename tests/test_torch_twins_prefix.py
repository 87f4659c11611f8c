"""Plain twins of the point-total and Horner kernels against the JAX
package's Pallas kernels in interpret mode (N = 512 points, 256 lanes;
S = 16 windows of 16 bits), on the same inputs. Both sum in another order
than the Pallas kernels, so results compare as points."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, mont_limbs, port_cfg, same_points
from msm_tpu.ops.pallas_prefix import make_horner_ladder, make_point_total
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.ops.cuda_prefix import horner, point_total

JCFG = MsmConfig(curve=BN254)
CFG = port_cfg(JCFG)


def _mont_points(n, seed, identity_at=()):
    aff = affine_points(CFG, min(n, 64), seed=seed)
    pts = [aff[i % len(aff)] for i in range(n)]
    xs = mont_limbs([x for x, _ in pts], CFG)
    ys = mont_limbs([y for _, y in pts], CFG)
    zs = mont_limbs([1] * n, CFG)
    for i in identity_at:
        xs[i], ys[i], zs[i] = 0, mont_limbs([1], CFG)[0], 0
    return xs, ys, zs


def test_point_total_twin_matches_pallas():
    N = 512
    pts = _mont_points(N, seed=13, identity_at=(5,))
    tx, ty, tz = make_point_total(JCFG, N, lanes=256, interpret=True)(*map(jnp.asarray, pts))
    want = [np.asarray(t)[:, 0] for t in (tx, ty, tz)]
    got = point_total(CFG, *(torch.from_numpy(a)[None] for a in pts))
    assert same_points(want, [g[0].numpy() for g in got], CFG)


def test_horner_twin_matches_pallas():
    S, chunk = 16, 16
    ws = _mont_points(S, seed=9, identity_at=(3,))  # an empty window
    want = make_horner_ladder(JCFG, S, chunk, interpret=True)(
        *(jnp.asarray(a.T) for a in ws)
    )
    got = horner(CFG, *map(torch.from_numpy, ws), chunk)
    assert same_points([np.asarray(w) for w in want], [g.numpy() for g in got], CFG)
