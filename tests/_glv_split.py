"""Shared by tests/test_torch_glv*.py: the scalars of the GLV tests, and
the tensor-split and decomposition checks against the JAX package. One
input set serves both checks on a curve (the split's edge, knife-edge and
random scalars, then the decomposition's 0, 1, r - 1, lambda, r - lambda,
2, r - 2 and random ones), and the JAX package's split and decomposition
of it come from one jitted program: the decomposition runs the split
first, so a cold run compiles the split once a curve, not twice."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import port_cfg
from msm_tpu import params as jparams
from msm_tpu.models.common import ints_to_u16_array
from msm_tpu.ops import glv as jglv
from msm_tpu.ops.glv import decompose_signed_glv as j_decompose_signed_glv
from msm_tpu_torch.models.common import pad_scalars_words
from msm_tpu_torch.ops import glv


def scalars(g, r, extra, seed):
    """0, 1, r - 1, lambda, r - lambda; scalars whose k b_j / r lies next to
    a half-integer (the remainder's extremes); random ones."""
    ks = [0, 1, r - 1, g.lam, r - g.lam]
    for b in (g.v2[1], -g.v1[1]):
        for m in (0, 1, 2, 5, 11):
            k = ((2 * m + 1) * r) // (2 * b)
            ks += [(k + d) % r for d in (-1, 0, 1)]
    rng = np.random.default_rng(seed)
    return ks + [int.from_bytes(rng.bytes(32), "little") % r for _ in range(extra)]


def signed(a, neg):
    """|k| words [n, W] and signs [n] -> python ints."""
    a, neg = np.asarray(a), np.asarray(neg)
    vals = [sum(int(a[i, j]) << (16 * j) for j in range(a.shape[1])) for i in range(a.shape[0])]
    return [-v if s else v for v, s in zip(vals, neg)]


def words(ks):
    return ints_to_u16_array([k % (1 << 256) for k in ks]).astype(np.int32)


def _jcfg(name):
    return jparams.MsmConfig(curve=jparams.CURVES[name], glv=True)


def glv_inputs(name) -> np.ndarray:
    """A curve's scalar words for the split and the decomposition: the
    split's 135 scalars (``scalars(extra=100, seed=4)``), then 64 with a
    negative half among them (0, 1, r - 1, lambda, r - lambda, 2, r - 2,
    57 random ones from seed 6), int32 [199, 16]."""
    cfg = port_cfg(_jcfg(name))
    g, r = glv.glv_params(cfg.curve), cfg.curve.order
    rng = np.random.default_rng(6)
    dec = [0, 1, r - 1, g.lam, r - g.lam, 2, r - 2] + [int.from_bytes(rng.bytes(32), "little") % r
                                                       for _ in range(57)]
    return np.concatenate([words(scalars(g, r, extra=100, seed=4)), pad_scalars_words(dec, cfg, len(dec))])


@functools.cache
def jax_split_and_decomposition(name):
    """(inputs, the JAX device split's four arrays, its keys and signs at
    c = 16) on ``glv_inputs(name)``, by one jitted program."""
    jcfg = _jcfg(name)
    s = glv_inputs(name)
    split, (keys, signs) = jax.jit(lambda x: (jglv.split_scalars_device(x, jcfg), j_decompose_signed_glv(
        x, 16, jcfg.num_subtasks, jcfg)))(jnp.asarray(s))
    return s, [np.asarray(a) for a in split], np.asarray(keys), np.asarray(signs)


def check_tensor_split(name) -> None:
    """The tensor split word for word and sign for sign against the JAX
    device split (Pallas' basis signs, BLS12-381's dense order)."""
    s, want, _, _ = jax_split_and_decomposition(name)
    got = glv.split_scalars_device(torch.from_numpy(s), port_cfg(_jcfg(name)))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


def check_decomposition(name) -> None:
    """Keys and signs [S, 2n] at c = 16 (S = 8; secp256k1 9) against the
    JAX package's; every key within the bucket range."""
    s, _, jkeys, jsigns = jax_split_and_decomposition(name)
    cfg = port_cfg(_jcfg(name))
    keys, signs = glv.decompose_signed_glv(torch.from_numpy(s), 16, cfg.num_subtasks, cfg)
    assert keys.shape == (cfg.num_subtasks, 2 * len(s)) and cfg.num_subtasks in (8, 9)
    assert np.array_equal(keys.numpy(), jkeys)
    assert np.array_equal(signs.numpy(), jsigns)
    assert int(keys.max()) <= 1 << 15
