"""The wide-word multipliers of msm_tpu_torch.ops.field (int64 lanes that
hold uint32 values) against msm_tpu.ops.field's uint32 ones on the same
numpy inputs, bit for bit, at word sizes 13 to 16: mont_mul_eager,
mul_wide_nsafe, mont_reduce_wide and mont_mul_nsafe on the reference
tests' extremes (0, 1, p - 1, R mod p; T up to p R - 1) and on random
elements, each also against the integers; on random limbs below 2^w whose
values exceed p (the inputs mont_variant_bench times), which only the
same wrap-around of every uint32 step reproduces; and nsafe_for. Each JAX
result is computed once per module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import port_cfg
from msm_tpu.ops import field as jfield
from msm_tpu.params import BN254, MsmConfig
from msm_tpu.utils.limbs import int_to_limbs, limbs_to_int
from msm_tpu_torch.ops import field

WIDTHS = [13, 14, 15, 16]
P = BN254.modulus


def _cfg(w):
    return MsmConfig(curve=BN254, word_size=w)


@functools.lru_cache(maxsize=None)
def _operands(w, kind):
    """(a, b) int32 limbs [n, L]: 'field' the extremes and random elements
    below p, 'limbs' random limbs below 2^w - 1 (values up to R)."""
    cfg = _cfg(w)
    L = cfg.num_words
    rng = np.random.default_rng(1000 + w)
    if kind == "limbs":
        return tuple(rng.integers(0, (1 << w) - 1, size=(24, L)).astype(np.int32) for _ in range(2))
    R = 1 << (w * L)
    rand = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(24)]
    va = [0, 1, P - 1, R % P, P - 1, 1] + rand
    vb = [P - 1, 0, P - 1, R % P, P - 2, 1] + rand[::-1]
    return tuple(np.stack([int_to_limbs(v, w, L) for v in vs]).astype(np.int32) for vs in (va, vb))


@functools.lru_cache(maxsize=None)
def _jax(w, name, kind):
    a, b = _operands(w, kind)
    fn = jax.jit(getattr(jfield, name), static_argnums=0)  # one compile, not an op a dispatch
    return np.asarray(fn(_cfg(w), jnp.asarray(a), jnp.asarray(b))).astype(np.int64)


def _port(w, name, kind):
    a, b = _operands(w, kind)
    return getattr(field, name)(port_cfg(_cfg(w)), torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _ints(arr, w):
    return [limbs_to_int(row, w) for row in arr.astype(np.int64)]


@pytest.mark.parametrize("kind", ["field", "limbs"])
@pytest.mark.parametrize("name", ["mont_mul_eager", "mont_mul_nsafe"])
@pytest.mark.parametrize("w", WIDTHS)
def test_montgomery_products_match_reference(w, name, kind):
    got = _port(w, name, kind)
    assert got.dtype == np.int32
    assert np.array_equal(got.astype(np.int64), _jax(w, name, kind))
    if kind == "field":
        cfg = _cfg(w)
        a, b = (_ints(x, w) for x in _operands(w, kind))
        assert _ints(got, w) == [x * y * cfg.rinv % P for x, y in zip(a, b)]
        assert (got >= 0).all() and (got < (1 << w)).all()


@pytest.mark.parametrize("kind", ["field", "limbs"])
@pytest.mark.parametrize("w", WIDTHS)
def test_mul_wide_nsafe_matches_reference(w, kind):
    got = _port(w, "mul_wide_nsafe", kind)
    assert got.dtype == np.int64 and np.array_equal(got, _jax(w, "mul_wide_nsafe", kind))
    a, b = (_ints(x, w) for x in _operands(w, kind))
    assert _ints(got, w) == [x * y for x, y in zip(a, b)]


@pytest.mark.parametrize("w", WIDTHS)
def test_mont_reduce_wide_extremes_match_reference(w):
    """T just under p R (the reduce's bound), p R - p, (p - 1)^2, R and
    tiny T, as int32 limbs [n, 2L]."""
    cfg = _cfg(w)
    L = cfg.num_words
    R = 1 << (w * L)
    vals = [0, 1, P - 1, P * R - 1, (P - 1) * (P - 1), R, P * R - P]
    t = np.stack([int_to_limbs(v, w, 2 * L) for v in vals]).astype(np.int32)
    want = np.asarray(jfield.mont_reduce_wide(cfg, jnp.asarray(t)))
    got = field.mont_reduce_wide(port_cfg(cfg), torch.from_numpy(t)).numpy()
    assert np.array_equal(got, want)
    assert _ints(got, w) == [v * cfg.rinv % P for v in vals]


def test_nsafe_values_match_reference():
    assert [field.nsafe_for(w) for w in range(8, 17)] == [jfield.nsafe_for(w) for w in range(8, 17)]
    assert [field.nsafe_for(w) for w in WIDTHS] == [64, 16, 4, 1]
