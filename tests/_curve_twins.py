"""Checks that hold kernels of the six curves besides BN254 against the JAX
package, one curve and mode a call; the test files
test_torch_twins_{pairs,convert}_{bls12,pasta,256}.py split the cases
between them (the JAX kernels run in interpret mode, ~5-20 s a call).

- check_compress_pairs: compress_pairs (kernels 10, 9 and 11: the forward
  products, the Fermat inversion of the last, the backward emission) in
  either row layout against the JAX package's compress_pairs on the same
  stream: one subtask of Cp = 4 pairs over R = 128 lanes of a table of 16
  real points (under GLV 8 points and their phi images), with doubling and
  infinity pairs planted (under GLV also pairs of equal x across the
  table's halves). The infinity flags compare exactly, the pair sums after
  canonical() wherever the pair is not at infinity (an infinity pair's
  coordinates mean nothing in either package); the run must hold infinity
  pairs and finite ones.
- check_convert_scaled: the convert kernel's run-time-constant modes
  (convert_pack_scaled; on CPU tensors convert_pack_scaled_plain) against
  make_convert_pack(..., interpret=True) with the same x_scale_int,
  dual_x_scale_int and triple: an override of the x constant, two tables
  sharing y (x R and beta x R), the triple table with an override, the
  plain default (also equal to convert_pack) and the triple table with the
  GLV constants (also equal to convert_pack_glv), on 58 real points of the
  curve and six edge words (0, 1, p - 1, p, 2p - 1 or the largest the
  curve's words hold, which may be >= p). The tables compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import affine_points, canon, glv_pair_stream, pair_stream, port_cfg, u16_words_int32
from msm_tpu.ops.glv import glv_params as j_glv_params
from msm_tpu.ops.pallas_compress import compress_pairs as j_compress_pairs
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.params import CURVES as J_CURVES
from msm_tpu.params import MsmConfig as J_MsmConfig
from msm_tpu_torch.models.common import ints_to_u16_array
from msm_tpu_torch.ops.cuda_compress import compress_pairs
from msm_tpu_torch.ops.cuda_convert import convert_pack, convert_pack_glv, convert_pack_scaled, coord_u16
from msm_tpu_torch.params import coord_words

#: the curve groups of the test files
GROUPS = {"bls12": ["bls12_381", "bls12_377"], "pasta": ["pallas", "vesta"], "256": ["grumpkin", "secp256k1"]}
OTHER_CURVES = [c for group in GROUPS.values() for c in group]
MODES = ["override", "dual", "triple_override", "default", "triple"]
Cp, R = 4, 128


def check_compress_pairs(name: str, glv: bool) -> None:
    jcfg = J_MsmConfig(curve=J_CURVES[name], compress=True, glv=glv)
    cfg = port_cfg(jcfg)
    stream = glv_pair_stream if glv else pair_stream
    _, packed, perm, flags = stream(cfg, 1, 2 * Cp, R, nbase=16, seed=160 + 2 * OTHER_CURVES.index(name) + glv)
    cx, cy, inf = compress_pairs(cfg, *(torch.from_numpy(a) for a in (packed, perm, flags)))
    gxy = jnp.asarray(packed[perm[0]]).swapaxes(1, 2)  # [C, coords D, R]
    sg = jnp.asarray(flags[0]).reshape(2 * Cp, 1, R)
    wx, wy, winf = j_compress_pairs(jcfg, gxy, sg, interpret=True)
    assert np.array_equal(inf[0].numpy(), np.asarray(winf)[:, 0])
    finite = inf[0].numpy() == 0
    assert finite.any() and not finite.all()
    for got, want in ((cx[0], wx), (cy[0], wy)):
        g, w = (canon(np.asarray(a).swapaxes(-1, -2), cfg) for a in (got, want))  # [Cp, R]
        assert np.array_equal(g[finite], w[finite])


def _words(cfg, n: int):
    """u16 words [n, Wu] (int16) of n - 6 random points and six edge pairs."""
    p, wu = cfg.curve.modulus, coord_u16(cfg)
    aff = affine_points(cfg, n - 6, seed=180)
    top = (1 << (16 * wu)) - 1
    aff += [(0, 2), (1, 1), (p - 1, 5), (p, p + 1), (min(2 * p - 1, top), top), (top, 3)]
    return [ints_to_u16_array([c[i] for c in aff], 2 * wu).view(np.int16) for i in range(2)]


def check_convert_scaled(name: str, mode: str) -> None:
    jcfg = J_MsmConfig(curve=J_CURVES[name])
    cfg = port_cfg(jcfg)
    p = cfg.curve.modulus
    beta_r2 = j_glv_params(jcfg.curve).beta * jcfg.r2 % p
    override = 0x1234_5678_9ABC_DEF0 * jcfg.r2 + p  # reduced mod p by both
    x_scale = override if mode in ("override", "triple_override") else None
    dual = beta_r2 if mode in ("dual", "triple_override", "triple") else None
    triple = mode.startswith("triple")
    n = 64
    x_u16, y_u16 = _words(cfg, n)
    got = convert_pack_scaled(cfg, *map(torch.from_numpy, (x_u16, y_u16)), x_scale, dual, triple)
    want = make_convert_pack(jcfg, tile=64, interpret=True, x_scale_int=x_scale, dual_x_scale_int=dual,
                             triple=triple)(*map(jnp.asarray, u16_words_int32(x_u16, y_u16)))
    got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
    assert len(got) == len(want) == (2 if mode == "dual" else 1)
    for g, w in zip(got, want):
        assert g.shape == (n, (3 if triple else 2) * coord_words(cfg))
        assert np.array_equal(g.numpy(), np.asarray(w))
    words = [torch.from_numpy(a) for a in (x_u16, y_u16)]
    if mode == "default":
        assert torch.equal(got[0], convert_pack(cfg, *words))
    if mode == "triple":
        assert torch.equal(got[0], convert_pack_glv(port_cfg(J_MsmConfig(curve=J_CURVES[name], glv=True)), *words))
