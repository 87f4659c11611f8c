"""Plain twins of the compressed-scan kernels (pair suffix, fused pair
emission + scan) against the JAX package's Pallas kernels in interpret mode
(Cp = 4 pairs, R = 256 lanes, tile 256), on the same gathered rows: a table
of real points with planted doubling and infinity pairs.

Both kernels walk the same chains in the same order, so their outputs
compare coordinate by coordinate after canonical(). The chain inputs that
one kernel hands the next (s, t0) are given to both sides in canonical
form."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import canon, pair_stream, port_cfg
from msm_tpu.ops.pallas_compress import make_emit_scan, make_pair_suffix
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.ops.cuda_compress import emit_scan, pair_suffix
from msm_tpu_torch.ops.cuda_inv import mont_pow
from msm_tpu_torch.ops.field import get_field_ctx

JCFG = MsmConfig(curve=BN254, compress=True)
CFG = port_cfg(JCFG)
L = CFG.num_words
Cp, R = 4, 256


def _inputs():
    _, packed, perm, flags = pair_stream(CFG, 1, 2 * Cp, R, nbase=8, seed=71)
    gxy = jnp.asarray(packed[perm[0]]).swapaxes(1, 2)  # [C, 2D, R]
    sg = jnp.asarray(flags[0]).reshape(2 * Cp, 1, R)
    return (torch.from_numpy(packed), torch.from_numpy(perm), torch.from_numpy(flags)), (gxy, sg)


def _limbs_last(a):
    return np.asarray(a).swapaxes(-1, -2)


def test_pair_suffix_twin_matches_pallas():
    port_in, (gxy, sg) = _inputs()
    got = pair_suffix(CFG, *port_in)[0]  # [Cp, L, R]
    want = make_pair_suffix(JCFG, Cp, R, tile=256, interpret=True)(gxy, sg)
    assert np.array_equal(canon(_limbs_last(got), CFG), canon(_limbs_last(want), CFG))


def test_emit_scan_twin_matches_pallas():
    port_in, (gxy, sg) = _inputs()
    f = get_field_ctx(CFG)
    s = pair_suffix(CFG, *port_in)
    s = f.canonical(s.transpose(-1, -2)).transpose(-1, -2).contiguous()
    t0 = mont_pow(CFG, s[:, 0], BN254.modulus - 2)
    t0 = f.canonical(t0.transpose(-1, -2)).transpose(-1, -2).contiguous()
    # the chain really inverts: t0 * s_0 == one
    one = f.mont_mul(t0.transpose(-1, -2), s[:, 0].transpose(-1, -2))
    assert (canon(one, CFG) == CFG.r % BN254.modulus).all()

    pe3, *tots = emit_scan(CFG, *port_in, s, t0)
    want = make_emit_scan(JCFG, Cp, R, tile=256, interpret=True)(
        gxy, sg, jnp.asarray(s[0].numpy()), jnp.asarray(t0[0].numpy()))
    for i, w in enumerate(want):  # [Cp, L, R] per coordinate
        w = _limbs_last(w)
        assert np.array_equal(canon(pe3[0, ..., i * L:(i + 1) * L].numpy(), CFG), canon(w, CFG))
        # the lane totals are the last prefix
        assert np.array_equal(canon(_limbs_last(tots[i][0]), CFG), canon(w[-1], CFG))
