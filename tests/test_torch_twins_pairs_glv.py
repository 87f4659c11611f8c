"""The GLV modes of the pair-value kernels (forward products, backward
emission) and the convert kernel's run-time-constant modes, held against
the JAX package:

- pair_forward and pair_backward under MsmConfig(BN254, glv=True) against
  make_pair_forward and make_pair_backward in interpret mode (Cp = 8 pairs,
  R = 256 lanes, tile 256) on a GLV table of points and their phi images
  with planted doubling, infinity and equal-x-across-halves pairs; the
  chain values handed from one kernel to the next go to both sides
  canonical;
- compress_pairs under GLV against the oracle: every pair sum of points,
  their phi images and their negations, and every infinity flag;
- convert_pack_scaled against make_convert_pack(..., interpret=True) in
  five modes: an x_scale_int override, the two-table dual mode, the triple
  table with an override, the plain default (also equal to convert_pack)
  and the triple table with the GLV constants (also equal to
  convert_pack_glv); triple without a second constant raises in both
  packages.
Outputs compare exactly after canonical()."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import canon, glv_pair_stream, port_cfg, u16_words_int32
from msm_tpu.ops.glv import glv_params as j_glv_params
from msm_tpu.ops.pallas_compress import make_pair_backward, make_pair_forward
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops.cuda_compress import compress_pairs, pair_backward, pair_forward
from msm_tpu_torch.ops.cuda_convert import convert_pack, convert_pack_glv, convert_pack_scaled
from msm_tpu_torch.ops.cuda_inv import mont_pow
from msm_tpu_torch.ops.field import get_field_ctx
from msm_tpu_torch.oracle.pyecc import Curve

JCFG = MsmConfig(curve=BN254, compress=True, glv=True)
CFG = port_cfg(JCFG)
L = CFG.num_words
P = BN254.modulus


def _limbs_last(a):
    return np.asarray(a).swapaxes(-1, -2)


def _canonical_limbs_first(a):
    f = get_field_ctx(CFG)
    return f.canonical(a.transpose(-1, -2)).transpose(-1, -2).contiguous()


def test_pair_forward_backward_glv_twins_match_pallas():
    Cp, R = 8, 256
    _, packed, perm, flags = glv_pair_stream(CFG, 1, 2 * Cp, R, nbase=16, seed=91)
    port_in = [torch.from_numpy(a) for a in (packed, perm, flags)]
    gxy = jnp.asarray(packed[perm[0]]).swapaxes(1, 2)  # [C, 3D, R]
    sg = jnp.asarray(flags[0]).reshape(2 * Cp, 1, R)

    m = pair_forward(CFG, *port_in)
    want_m = make_pair_forward(JCFG, Cp, R, tile=256, interpret=True)(gxy, sg)
    assert np.array_equal(canon(_limbs_last(m[0]), CFG), canon(_limbs_last(want_m), CFG))

    m = _canonical_limbs_first(m)
    minv = _canonical_limbs_first(mont_pow(CFG, m[:, -1], P - 2))
    cx, cy, inf = pair_backward(CFG, *port_in, m, minv)
    wx, wy, winf = make_pair_backward(JCFG, Cp, R, tile=256, interpret=True)(
        gxy, sg, jnp.asarray(m[0].numpy()), jnp.asarray(minv[0].numpy()))
    assert np.array_equal(inf[0].numpy(), np.asarray(winf)[:, 0])
    assert inf.any() and not inf.all()
    for g, w in ((cx, wx), (cy, wy)):
        assert np.array_equal(canon(_limbs_last(g[0]), CFG), canon(_limbs_last(w), CFG))


def test_compress_pairs_glv_matches_oracle():
    """Every pair sum (generic, doubling, P + (-P), and pairs of P_i's phi
    copy with the row phi(P_i): equal x across the halves) against the
    oracle; infinity pairs flagged, never valued."""
    cv = Curve(CFG.curve)
    beta = j_glv_params(JCFG.curve).beta
    G, C, R = 2, 8, 32
    base, packed, perm, flags = glv_pair_stream(CFG, G, C, R, nbase=8, seed=92)
    cx, cy, inf = compress_pairs(CFG, *(torch.from_numpy(a) for a in (packed, perm, flags)))
    xs, ys = (canon(_limbs_last(c), CFG) for c in (cx, cy))  # [G, Cp, R] residues
    rinv = pow(CFG.r, -1, P)

    def element(g, c, r):
        x, y = base[perm[g, c, r]]
        pt = cv.from_affine(x * beta % P if flags[g, c, r] & 2 else x, y)
        return cv.neg(pt) if flags[g, c, r] & 1 else pt

    n_inf = n_dbl = n_phi = 0
    for g in range(G):
        for j in range(C // 2):
            for r in range(R):
                s = cv.add(element(g, 2 * j, r), element(g, 2 * j + 1, r))
                if s.z % P == 0:
                    assert inf[g, j, r] == 1
                    n_inf += 1
                    continue
                assert inf[g, j, r] == 0
                same = perm[g, 2 * j, r] == perm[g, 2 * j + 1, r]
                n_dbl += bool(same and flags[g, 2 * j, r] == flags[g, 2 * j + 1, r])
                n_phi += bool(perm[g, 2 * j + 1, r] == perm[g, 2 * j, r] + 4 and flags[g, 2 * j, r] & 2)
                assert (xs[g, j, r] * rinv % P, ys[g, j, r] * rinv % P) == cv.to_affine(s)
    assert n_inf > 0 and n_dbl > 0 and n_phi > 0


def _edge_words(n: int):
    """u16 words of n - 6 random points and six edge coordinate pairs,
    values >= p included."""
    from _torch_helpers import affine_points

    aff = affine_points(CFG, n - 6, seed=93)
    aff += [(0, 2), (1, 1), (P - 1, 5), (P, P + 1), (2 * P - 1, 4 * P), ((1 << 256) - 1, 3)]
    return pad_points_words(aff, CFG, n)


BETA_R2 = j_glv_params(JCFG.curve).beta * JCFG.r2 % P
OVERRIDE = 0x1234_5678_9ABC_DEF0 * JCFG.r2 + P  # reduced mod p by both


@pytest.mark.parametrize("x_scale, dual, triple", [
    (OVERRIDE, None, False), (None, BETA_R2, False), (OVERRIDE, BETA_R2, True), (None, None, False),
    (None, BETA_R2, True)], ids=["override", "dual", "triple_override", "default", "triple"])
def test_convert_pack_scaled_matches_pallas(x_scale, dual, triple):
    n = 256
    x_u16, y_u16 = _edge_words(n)
    got = convert_pack_scaled(CFG, *map(torch.from_numpy, (x_u16, y_u16)), x_scale, dual, triple)
    want = make_convert_pack(JCFG, tile=128, interpret=True, x_scale_int=x_scale,
                             dual_x_scale_int=dual, triple=triple)(
        *map(jnp.asarray, u16_words_int32(x_u16, y_u16)))
    got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
    assert len(got) == len(want) == (2 if dual is not None and not triple else 1)
    for g, w in zip(got, want):
        assert g.shape == (n, (3 if triple else 2) * 8)
        assert np.array_equal(g.numpy(), np.asarray(w))
    if x_scale is None and dual is None:  # the plain table
        plain = convert_pack(port_cfg(MsmConfig(curve=BN254)), *map(torch.from_numpy, (x_u16, y_u16)))
        assert np.array_equal(got[0].numpy(), plain.numpy())
    if x_scale is None and triple:  # the GLV table
        glv = convert_pack_glv(port_cfg(MsmConfig(curve=BN254, glv=True)), *map(torch.from_numpy, (x_u16, y_u16)))
        assert np.array_equal(got[0].numpy(), glv.numpy())


def test_convert_pack_scaled_triple_needs_dual():
    x_u16, y_u16 = _edge_words(16)
    with pytest.raises(ValueError, match="triple"):
        convert_pack_scaled(CFG, *map(torch.from_numpy, (x_u16, y_u16)), None, None, True)
    with pytest.raises(AssertionError, match="triple"):
        make_convert_pack(JCFG, tile=16, interpret=True, triple=True)
