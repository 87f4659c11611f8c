"""Kernel 8's plain twin and the blocked bucket reduction on the CPU against
the JAX package and the exact-integer oracle (msm_tpu.oracle.stages):

- bpr_phase1_plain against make_bpr_phase1 (Pallas, interpret mode) at
  Bl = 4 steps, T = 8 lanes on random field triples: both add in the same
  order and the complete addition is a polynomial map on values mod p, so
  m and g compare exactly after canonical();
- the per-lane block sums m_t and sums of running sums g_t against the
  oracle's parallel_bucket_reduction_1, on buckets of real points;
- bucket_reduce_blocked (device="cpu") against the JAX
  bucket_reduce_blocked and the oracle's parallel_bucket_reduction: they
  sum in other orders, so results compare as points;
- the blocked tail's suffix ladder against the JAX hillis_steele_prefix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, canon, mont_limbs, port_cfg, rand_canonical, same_points
from msm_tpu.ops import scan as jscan
from msm_tpu.ops.curve import PointBatch as JPB
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.pallas_bpr import make_bpr_phase1
from msm_tpu.oracle.pyecc import IDENTITY, Curve
from msm_tpu.oracle.stages import parallel_bucket_reduction, parallel_bucket_reduction_1
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.ops import scan
from msm_tpu_torch.ops.cuda_bpr import bpr_phase1
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx

JCFG = MsmConfig(curve=BN254)
CFG = port_cfg(JCFG)
CV = Curve(BN254)
P = BN254.modulus


def test_bpr_phase1_twin_matches_pallas():
    Bl, T = 4, 8
    rng = np.random.default_rng(101)
    b = [rand_canonical(rng, (Bl, T), CFG) for _ in range(3)]
    mc, gc = make_bpr_phase1(JCFG, Bl, T, interpret=True)(*map(jnp.asarray, b))
    got = bpr_phase1(CFG, *(torch.from_numpy(a)[None] for a in b))
    for w, g in zip((*mc, *gc), got):
        assert np.array_equal(canon(np.asarray(w), CFG), canon(g[0].numpy(), CFG))


def _buckets(nb, seed, identity_at=(3,)):
    """nb buckets of real points in random projective form (x z : y z : z),
    the identity at ``identity_at``: (port limbs [nb, L] x3, oracle JPoints)."""
    aff = affine_points(CFG, nb, seed)
    rng = np.random.default_rng(seed)
    zs = [int(v) for v in rng.integers(1, 2**62, size=nb)]
    jp = [CV.from_affine(x, y) for x, y in aff]
    xs = [x * z % P for (x, _), z in zip(aff, zs)]
    ys = [y * z % P for (_, y), z in zip(aff, zs)]
    for i in identity_at:
        xs[i], ys[i], zs[i] = 0, 1, 0
        jp[i] = IDENTITY
    return [mont_limbs(v, CFG) for v in (xs, ys, zs)], jp


def _affine(pts):
    """Port point limbs (x, y, z) [..., L] -> affine ints (None: identity)."""
    X, Y, Z = (canon(np.asarray(a), CFG).reshape(-1) for a in pts)
    return [None if z == 0 else (x * pow(int(z), -1, P) % P, y * pow(int(z), -1, P) % P)
            for x, y, z in zip(X, Y, Z)]


def _oracle_affine(jpoints):
    return [None if q.is_identity() else CV.to_affine(q) for q in jpoints]


def test_phase1_lanes_match_oracle():
    T, Bl = 4, 4
    limbs, jp = _buckets(1 + T * Bl, seed=102, identity_at=(0, 3, 9))
    body = [torch.from_numpy(a[1:].reshape(T, Bl, -1).transpose(1, 0, 2).copy())[None] for a in limbs]
    out = bpr_phase1(CFG, *body)
    gs, ms = parallel_bucket_reduction_1(jp, CV, num_threads=T)
    assert _affine([o[0] for o in out[:3]]) == _oracle_affine(ms)
    assert _affine([o[0] for o in out[3:]]) == _oracle_affine(gs)


@pytest.mark.parametrize("T, Bl", [(8, 4), (1, 8), (16, 1)])
def test_blocked_reduce_matches_jax_and_oracle(T, Bl):
    """Two subtasks of 1 + T * Bl buckets: one lane, one bucket per lane,
    and the general case."""
    nb = 1 + T * Bl
    subtasks = [_buckets(nb, seed=103 + s, identity_at=(0, s + 2)) for s in range(2)]
    port = PointBatch(*(torch.from_numpy(np.stack([b[0][i] for b in subtasks])) for i in range(3)))
    got = scan.bucket_reduce_blocked(get_curve_ctx(CFG), port, T)
    assert got.x.shape == (2, CFG.num_words)
    jec = j_curve_ctx(JCFG)
    j_reduce = jax.jit(lambda x, y, z: jscan.bucket_reduce_blocked(jec, JPB(x, y, z), T))
    for s, (limbs, jp) in enumerate(subtasks):
        want = parallel_bucket_reduction(jp, CV, num_threads=T)
        assert _affine([a[s] for a in got]) == _oracle_affine([want])
        j_got = j_reduce(*map(jnp.asarray, limbs))
        assert same_points([np.asarray(a) for a in j_got], [a[s].numpy() for a in got], CFG)


def test_reverse_ladder_matches_jax():
    """The blocked tail's suffix sums along the point axis (on the curve
    context's adder, the point-add kernel's wrapper) against the JAX
    hillis_steele_prefix(reverse=True)."""
    limbs, _ = _buckets(8, seed=104)
    want = jscan.hillis_steele_prefix(j_curve_ctx(JCFG), JPB(*map(jnp.asarray, limbs)), reverse=True)
    got = scan._suffix_sums(get_curve_ctx(CFG), PointBatch(*map(torch.from_numpy, limbs)))
    assert same_points([np.asarray(a) for a in want], [a.numpy() for a in got], CFG)
