"""The window sums' fold on the Horner kernel against the JAX package: the
batched Horner twin ([G, S, L] -> [G, L]) ladder by ladder against
make_horner_ladder in interpret mode at S = 2 (W = lo + 2^chunk hi, as
window_sum_from_pe and the blocked tail run it), and the port's
window_sum_from_pe (point total, then one Horner launch over the windows'
two-point ladders) against msm_tpu.ops.scan.window_sum_from_pe (tree
reduction and doublings, XLA) on the same real points. Both sum in other
orders, so results compare as points."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, mont_limbs, port_cfg, same_points
from msm_tpu.ops import scan as jscan
from msm_tpu.ops.curve import PointBatch as JPointBatch
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.pallas_prefix import make_horner_ladder
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.ops import scan
from msm_tpu_torch.ops.cuda_prefix import horner
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx

JCFG = MsmConfig(curve=BN254, chunk_size=6)
CFG = port_cfg(JCFG)
P = BN254.modulus


def _points(shape, seed, identity_every=5):
    """Real points in random projective form (x z : y z : z), Montgomery
    limbs [*shape, L] x3, every identity_every-th the identity (0 : z : 0)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    base = affine_points(CFG, 16, seed=seed)
    idx = rng.integers(0, len(base), size=n)
    zs = [int(v) for v in rng.integers(1, 1 << 62, size=n)]
    xs = [base[i][0] * z % P for i, z in zip(idx, zs)]
    ys = [base[i][1] * z % P for i, z in zip(idx, zs)]
    for k in range(0, n, identity_every):
        xs[k], zs[k] = 0, 0
    return [mont_limbs(v, CFG).reshape(*shape, -1) for v in (xs, ys, zs)]


def test_batched_horner_twin_matches_pallas_per_ladder():
    G, S, chunk = 2, 2, 4
    ws = _points((G, S), seed=21, identity_every=3)
    ws[1][1, 0] = -ws[1][1, 0]  # a negated (balanced) row
    got = horner(CFG, *map(torch.from_numpy, ws), chunk)
    assert all(g.shape == (G, CFG.num_words) for g in got)
    ladder = jax.jit(make_horner_ladder(JCFG, S, chunk, interpret=True))  # one trace for the G ladders
    for i in range(G):
        want = ladder(*(jnp.asarray(np.ascontiguousarray(a[i].T)) for a in ws))
        assert same_points([np.asarray(w) for w in want], [g[i].numpy() for g in got], CFG)


def test_window_sum_from_pe_matches_jax():
    """S = 3 windows of B = 2^(c-1) + 1 = 33 boundary prefixes (real
    points; the JAX side runs its XLA route, one window at a time under
    vmap, as its cuzk model does)."""
    S, B = 3, (1 << (CFG.chunk_size - 1)) + 1
    pe = _points((S, B), seed=23)
    got = scan.window_sum_from_pe(get_curve_ctx(CFG), PointBatch(*map(torch.from_numpy, pe)))
    jec = j_curve_ctx(JCFG)
    want = jax.jit(jax.vmap(lambda x, y, z: tuple(jscan.window_sum_from_pe(jec, JPointBatch(x, y, z)))))(
        *map(jnp.asarray, pe))
    assert same_points([np.asarray(w) for w in want], [g.numpy() for g in got], CFG)
