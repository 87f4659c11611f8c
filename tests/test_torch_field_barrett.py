"""FieldCtx's Barrett product, reduce, mont_sqr and Fermat inversion in
msm_tpu_torch against msm_tpu's on the same numpy inputs, bit for bit: on
BN254, BLS12-377 and BLS12-381 at 13 bits and BN254 at 12 (where the
reference's Barrett is exact), with the adversarial maxima of the
reference's field tests. barrett_mul, reduce and inv_standard have a
canonical contract, so their limbs are compared as they are, and with the
integers they stand for; mont_sqr's balanced limbs are compared as they
are too (the port's product is the reference's step for step). Each JAX
result is computed once per module."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import port_cfg, rand_balanced
from msm_tpu.ops.field import FieldCtx as JField
from msm_tpu.params import BLS12_377, BLS12_381, BN254, MsmConfig
from msm_tpu.utils import limbs as L
from msm_tpu_torch.ops.field import FieldCtx

CONFIGS = {
    "bn254": MsmConfig(curve=BN254),
    "bls12_377": MsmConfig(curve=BLS12_377),
    "bls12_381": MsmConfig(curve=BLS12_381),
    "bn254_w12": MsmConfig(curve=BN254, word_size=12),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(config, the JAX context, the port's, operands a, b as ints and as
    canonical limbs): edge values, the adversarial maxima and random
    elements."""
    jcfg = CONFIGS[name]
    p, w, nw = jcfg.curve.modulus, jcfg.word_size, jcfg.num_words
    rng = random.Random(list(CONFIGS).index(name))
    edge = [0, 1, 2, p - 1, p - 2, jcfg.r % p, jcfg.r2, (1 << (jcfg.curve.modulus_bits - 1)) % p, jcfg.mask]
    va = edge + [p - 1, p - 1, 1, 0] + [rng.randrange(p) for _ in range(16)]
    vb = list(reversed(edge)) + [p - 1, 0, p - 1, 1] + [rng.randrange(p) for _ in range(16)]
    a, b = (L.ints_to_limbs(v, w, nw).astype(np.int32) for v in (va, vb))
    return jcfg, JField(jcfg), FieldCtx(port_cfg(jcfg)), va, vb, a, b


@functools.lru_cache(maxsize=None)
def _jax(name, op):
    jcfg, jf, _, va, vb, a, b = _case(name)
    if op == "barrett_mul":
        return np.asarray(jf.barrett_mul(jnp.asarray(a), jnp.asarray(b)))
    if op == "inv_standard":
        return np.asarray(jf.inv_standard(jnp.asarray(a[: len(a) // 2])))
    if op == "reduce":
        return np.asarray(jf.reduce(jnp.asarray(_reduce_input(name))))
    if op == "mont_sqr":
        return np.asarray(jf.mont_sqr(jnp.asarray(_balanced(name))))
    raise KeyError(op)


def _reduce_input(name):
    """Values in [0, 2p) that fit L limbs: a + b and a, as canonical limbs."""
    jcfg, _, _, va, vb, _, _ = _case(name)
    vals = [(x + y) % (2 * jcfg.curve.modulus) for x, y in zip(va, vb)] + va
    return L.ints_to_limbs(vals, jcfg.word_size, jcfg.num_words).astype(np.int32)


def _balanced(name):
    return rand_balanced(np.random.default_rng(5), (24,), CONFIGS[name])


@pytest.mark.parametrize("name", CONFIGS)
def test_barrett_mul_matches_reference(name):
    jcfg, _, tf, va, vb, a, b = _case(name)
    got = tf.barrett_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, _jax(name, "barrett_mul"))
    p = jcfg.curve.modulus
    assert L.limbs_to_ints(got, jcfg.word_size) == [x * y % p for x, y in zip(va, vb)]
    assert (got >= 0).all() and (got <= jcfg.mask).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_reduce_matches_reference(name):
    jcfg, _, tf, *_ = _case(name)
    x = _reduce_input(name)
    got = tf.reduce(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, _jax(name, "reduce"))
    p = jcfg.curve.modulus
    assert L.limbs_to_ints(got, jcfg.word_size) == [v % p for v in L.limbs_to_ints(x, jcfg.word_size)]


@pytest.mark.parametrize("name", CONFIGS)
def test_mont_sqr_matches_reference(name):
    jcfg, _, tf, *_ = _case(name)
    x = _balanced(name)
    got = tf.mont_sqr(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, _jax(name, "mont_sqr"))
    p = jcfg.curve.modulus
    want = [v * v * jcfg.rinv % p for v in L.limbs_to_ints(x, jcfg.word_size)]
    assert [v % p for v in L.limbs_to_ints(got, jcfg.word_size)] == want


@pytest.mark.parametrize("name", CONFIGS)
def test_inv_standard_matches_reference(name):
    jcfg, _, tf, va, _, a, _ = _case(name)
    half = len(a) // 2
    got = tf.inv_standard(torch.from_numpy(a[:half])).numpy()
    assert np.array_equal(got, _jax(name, "inv_standard"))
    p = jcfg.curve.modulus
    assert L.limbs_to_ints(got, jcfg.word_size) == [pow(v, -1, p) if v % p else 0 for v in va[:half]]


@pytest.mark.parametrize("name", CONFIGS)
def test_barrett_constants_match_reference(name):
    _, jf, tf, *_ = _case(name)
    assert tf.k == jf.k
    for attr in ("mu_limbs", "rinv_limbs", "p_limbs"):
        assert np.array_equal(getattr(tf, attr), getattr(jf, attr)), attr
