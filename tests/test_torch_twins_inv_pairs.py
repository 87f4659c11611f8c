"""Plain twins of the Fermat-inversion kernel and the pair-value kernels
(forward products, backward emission) against the JAX package's Pallas
kernels in interpret mode, and the compress_pairs twin against the oracle
pair by pair.

- mont_pow at R = 128 lanes, 1 and p - 1 included, exponent p - 2;
- pair forward / backward at C = 8 steps, R = 256 lanes (tile 256) on the
  same gathered rows, with planted doubling and infinity pairs; the chain
  values handed from one kernel to the next go to both sides canonical;
- compress_pairs (forward, mont_pow, backward) against the oracle's sum of
  every pair, on BN254 and on Pallas (21 limbs: the odd-limb geometry; the
  oracle only, no JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import canon, mont_limbs, pair_stream, port_cfg
from msm_tpu.ops.pallas_compress import make_pair_backward, make_pair_forward
from msm_tpu.ops.pallas_inv import make_mont_pow
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254, PALLAS, MsmConfig
from msm_tpu_torch.ops.cuda_compress import compress_pairs, pair_backward, pair_forward
from msm_tpu_torch.ops.cuda_inv import mont_pow
from msm_tpu_torch.ops.field import get_field_ctx

JCFG = MsmConfig(curve=BN254, compress=True)
CFG = port_cfg(JCFG)
L = CFG.num_words
P = BN254.modulus


def _limbs_last(a):
    return np.asarray(a).swapaxes(-1, -2)


def _canonical_limbs_first(cfg, a):
    f = get_field_ctx(cfg)
    return f.canonical(a.transpose(-1, -2)).transpose(-1, -2).contiguous()


def test_mont_pow_twin_matches_pallas():
    R = 128
    rng = np.random.default_rng(81)
    vals = [int(v) for v in rng.integers(2, 2**62, size=R)]
    vals[0], vals[1] = 1, P - 1
    a = mont_limbs(vals, CFG).T.copy()  # [L, R] Montgomery, limbs-first
    e = P - 2
    got = mont_pow(CFG, torch.from_numpy(a)[None], e)[0]
    want = make_mont_pow(JCFG, R, e, interpret=True)(jnp.asarray(a))
    gc = canon(_limbs_last(got), CFG)
    assert np.array_equal(gc, canon(_limbs_last(want), CFG))
    # Montgomery-domain inverse: pow(aR, p - 2) = a^-1 R
    assert all(gc[i] == pow(v, -1, P) * CFG.r % P for i, v in enumerate(vals))
    assert (canon(_limbs_last(mont_pow(CFG, torch.from_numpy(a)[None], 0)[0]), CFG) == CFG.r % P).all()


def test_pair_forward_backward_twins_match_pallas():
    C, R = 8, 256
    Cp = C // 2
    _, packed, perm, flags = pair_stream(CFG, 1, C, R, nbase=8, seed=82)
    port_in = [torch.from_numpy(a) for a in (packed, perm, flags)]
    gxy = jnp.asarray(packed[perm[0]]).swapaxes(1, 2)
    sg = jnp.asarray(flags[0]).reshape(C, 1, R)

    m = pair_forward(CFG, *port_in)
    want_m = make_pair_forward(JCFG, Cp, R, tile=256, interpret=True)(gxy, sg)
    assert np.array_equal(canon(_limbs_last(m[0]), CFG), canon(_limbs_last(want_m), CFG))

    m = _canonical_limbs_first(CFG, m)
    minv = _canonical_limbs_first(CFG, mont_pow(CFG, m[:, -1], P - 2))
    cx, cy, inf = pair_backward(CFG, *port_in, m, minv)
    wx, wy, winf = make_pair_backward(JCFG, Cp, R, tile=256, interpret=True)(
        gxy, sg, jnp.asarray(m[0].numpy()), jnp.asarray(minv[0].numpy()))
    assert np.array_equal(inf[0].numpy(), np.asarray(winf)[:, 0])
    assert inf.any() and not inf.all()
    for g, w in ((cx, wx), (cy, wy)):
        assert np.array_equal(canon(_limbs_last(g[0]), CFG), canon(_limbs_last(w), CFG))


@pytest.mark.parametrize("curve", [BN254, PALLAS], ids=["bn254", "pallas"])
def test_compress_pairs_twin_matches_oracle(curve):
    """Every pair sum (generic, doubling, P + (-P)) against the oracle;
    infinity pairs flagged, never valued."""
    cfg = port_cfg(MsmConfig(curve=curve, compress=True))
    cv = Curve(curve)
    p = curve.modulus
    G, C, R = 2, 8, 32
    base, packed, perm, flags = pair_stream(cfg, G, C, R, nbase=6, seed=83)
    cx, cy, inf = compress_pairs(cfg, *(torch.from_numpy(a) for a in (packed, perm, flags)))
    xs, ys = (canon(_limbs_last(c), cfg) for c in (cx, cy))  # [G, Cp, R] residues
    rinv = pow(cfg.r, -1, p)
    jp = [cv.from_affine(*b) for b in base]
    n_inf = n_dbl = 0
    for g in range(G):
        for j in range(C // 2):
            for r in range(R):
                e1, e2 = (jp[perm[g, c, r]] for c in (2 * j, 2 * j + 1))
                e1, e2 = (cv.neg(e) if flags[g, c, r] else e for e, c in ((e1, 2 * j), (e2, 2 * j + 1)))
                s = cv.add(e1, e2)
                if s.z % p == 0:
                    assert inf[g, j, r] == 1
                    n_inf += 1
                    continue
                assert inf[g, j, r] == 0
                n_dbl += perm[g, 2 * j, r] == perm[g, 2 * j + 1, r]
                assert (xs[g, j, r] * rinv % p, ys[g, j, r] * rinv % p) == cv.to_affine(s)
    assert n_inf > 0 and n_dbl > 0
