"""Plain twins of the GLV modes of kernels 2, 4, 12 and 13 against the JAX
package's Pallas kernels in interpret mode, on the same inputs: the convert
kernel's triple table (rows x R, beta x R, y R) word for word; the scan
over gathered triple rows with random sign and phi flags (C = 4 steps,
R = 512 lanes, tile 256); the pair suffix products and the fused pair
emission + scan over a triple table of points and their phi images, with
planted doubling and infinity pairs and pairs of equal x across the two
halves (Cp = 4 pairs, R = 256 lanes). Outputs compare after canonical()."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, canon, glv_pair_stream, port_cfg, u16_words_int32
from msm_tpu.ops.glv import glv_params as j_glv_params
from msm_tpu.ops.pallas_compress import make_emit_scan, make_pair_suffix
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.ops.pallas_scan import make_scan_rows
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models.common import pad_points_words
from msm_tpu_torch.ops.cuda_compress import emit_scan, pair_suffix
from msm_tpu_torch.ops.cuda_convert import convert_pack, convert_pack_glv
from msm_tpu_torch.ops.cuda_inv import mont_pow
from msm_tpu_torch.ops.cuda_scan import scan_rows
from msm_tpu_torch.ops.field import get_field_ctx

JCFG = MsmConfig(curve=BN254, glv=True)
CFG = port_cfg(JCFG)
L = CFG.num_words


def _limbs_last(a):
    return np.asarray(a).swapaxes(-1, -2)


def test_convert_triple_table_matches_pallas():
    """Coordinates below p and unvalidated ones in [p, 2^256)."""
    n = 256
    aff = affine_points(CFG, n - 6, seed=81)
    q = BN254.modulus
    aff += [(0, 2), (1, 1), (q - 1, 5), (q, q + 1), (2 * q - 1, 4 * q), ((1 << 256) - 1, 3)]
    x_u16, y_u16 = pad_points_words(aff, CFG, n)
    got = convert_pack_glv(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16)).numpy()
    beta_r2 = j_glv_params(JCFG.curve).beta * JCFG.r2 % q
    want = make_convert_pack(JCFG, tile=128, interpret=True, dual_x_scale_int=beta_r2, triple=True)(
        *map(jnp.asarray, u16_words_int32(x_u16, y_u16)))
    assert got.shape == (n, 3 * 8)
    assert np.array_equal(got, np.asarray(want))
    # convert_pack under a GLV config is the GLV mode; the plain mode's
    # table is the first and last third
    plain = convert_pack(dataclasses.replace(CFG, glv=False), *map(torch.from_numpy, (x_u16, y_u16)))
    assert np.array_equal(np.concatenate([got[:, :8], got[:, 16:]], axis=1), plain.numpy())
    assert np.array_equal(convert_pack(CFG, *map(torch.from_numpy, (x_u16, y_u16))).numpy(), got)


def test_scan_glv_twin_matches_pallas():
    C, R = 4, 512
    _, packed, perm, flags = glv_pair_stream(CFG, 1, C, R, nbase=64, seed=82)
    g = packed[perm[0]]  # [C, R, 3D]
    pe_j, *tot_j = make_scan_rows(JCFG, C, R, tile=256, interpret=True)(
        jnp.asarray(g).swapaxes(1, 2), jnp.asarray(flags[0]).reshape(C, 1, R))
    pe_t, *tot_t = scan_rows(CFG, *map(torch.from_numpy, (packed, perm, flags)))
    pe_j, pe_t = np.asarray(pe_j), pe_t[0].numpy()
    for i in range(3):
        sl = slice(i * L, (i + 1) * L)
        assert np.array_equal(canon(pe_j[..., sl], CFG), canon(pe_t[..., sl], CFG))
    for a, b in zip(tot_j, tot_t):
        assert np.array_equal(canon(np.asarray(a).T, CFG), canon(b[0].numpy().T, CFG))


def test_pair_suffix_and_emit_scan_glv_twins_match_pallas():
    Cp, R = 4, 256
    f = get_field_ctx(CFG)
    _, packed, perm, flags = glv_pair_stream(CFG, 1, 2 * Cp, R, nbase=16, seed=83)
    port_in = tuple(map(torch.from_numpy, (packed, perm, flags)))
    gxy = jnp.asarray(packed[perm[0]]).swapaxes(1, 2)  # [C, 3D, R]
    sg = jnp.asarray(flags[0]).reshape(2 * Cp, 1, R)

    s = pair_suffix(CFG, *port_in)
    want_s = make_pair_suffix(JCFG, Cp, R, tile=256, interpret=True)(gxy, sg)
    assert np.array_equal(canon(_limbs_last(s[0]), CFG), canon(_limbs_last(want_s), CFG))

    s = f.canonical(s.transpose(-1, -2)).transpose(-1, -2).contiguous()
    t0 = mont_pow(CFG, s[:, 0], BN254.modulus - 2)
    t0 = f.canonical(t0.transpose(-1, -2)).transpose(-1, -2).contiguous()
    pe3, *tots = emit_scan(CFG, *port_in, s, t0)
    want = make_emit_scan(JCFG, Cp, R, tile=256, interpret=True)(
        gxy, sg, jnp.asarray(s[0].numpy()), jnp.asarray(t0[0].numpy()))
    for i, w in enumerate(want):  # [Cp, L, R] per coordinate
        w = _limbs_last(w)
        assert np.array_equal(canon(pe3[0, ..., i * L:(i + 1) * L].numpy(), CFG), canon(w, CFG))
        assert np.array_equal(canon(_limbs_last(tots[i][0]), CFG), canon(w[-1], CFG))
