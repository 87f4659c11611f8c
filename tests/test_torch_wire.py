"""The port's wire formats (msm_tpu_torch.utils.limbs: the u16-word and
byte helpers) and sample_32_bit_scalars against the JAX package's on the
same inputs, with round trips."""

import numpy as np
import pytest

import msm_tpu
import msm_tpu_torch
from msm_tpu.utils import limbs as jlimbs
from msm_tpu_torch.utils import limbs
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254


def _ints(seed, count=24, bits=256):
    rng = np.random.default_rng(seed)
    edge = [0, 1, (1 << bits) - 1, 1 << (bits - 1), 0x8000, 0xFFFF]
    return edge + [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(count - len(edge))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_u16_words_match_jax(seed):
    xs = _ints(seed)
    got = limbs.ints_to_u16_words(xs)
    want = jlimbs.ints_to_u16_words(xs)
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)
    for x, row in zip(xs, got):
        assert np.array_equal(limbs.int_to_u16_words(x), jlimbs.int_to_u16_words(x))
        assert limbs.u16_words_to_int(row) == jlimbs.u16_words_to_int(row) == x


def test_u16_words_narrow():
    xs = _ints(3, bits=64)
    assert np.array_equal(limbs.ints_to_u16_words(xs, 4), jlimbs.ints_to_u16_words(xs, 4))
    assert limbs.ints_to_u16_words([], 4).shape == (0, 4)


@pytest.mark.parametrize("nbytes", [32, 48])
def test_scalar_bytes_match_jax(nbytes):
    xs = _ints(4, bits=8 * nbytes)
    data = limbs.scalars_to_bytes(xs, nbytes)
    assert data == jlimbs.scalars_to_bytes(xs, nbytes) and len(data) == nbytes * len(xs)
    assert limbs.bytes_to_scalars(data, nbytes) == jlimbs.bytes_to_scalars(data, nbytes) == xs


@pytest.mark.parametrize("nbytes", [32, 48])
def test_point_bytes_match_jax(nbytes):
    if nbytes == 32:
        cv = Curve(BN254)
        pts = [cv.to_affine(p) for p in cv.sample_points(12, seed=5)]
    else:
        xs = _ints(5, bits=8 * nbytes)
        pts = list(zip(xs[::2], xs[1::2]))
    data = limbs.points_to_bytes(pts, nbytes)
    assert data == jlimbs.points_to_bytes(pts, nbytes) and len(data) == 2 * nbytes * len(pts)
    assert limbs.bytes_to_points(data, nbytes) == jlimbs.bytes_to_points(data, nbytes) == pts


def test_package_byte_helpers_are_the_wire_formats():
    xs = _ints(6)
    assert msm_tpu_torch.scalars_to_bytes(xs) == msm_tpu.scalars_to_bytes(xs)
    assert msm_tpu_torch.bytes_to_scalars(msm_tpu.scalars_to_bytes(xs)) == xs
    pts = list(zip(xs[::2], xs[1::2]))
    assert msm_tpu_torch.points_to_bytes(pts) == msm_tpu.points_to_bytes(pts)
    assert msm_tpu_torch.bytes_to_points(msm_tpu.points_to_bytes(pts)) == pts
    assert msm_tpu_torch.scalars_to_bytes([]) == b"" and msm_tpu_torch.bytes_to_points(b"") == []


@pytest.mark.parametrize("n,seed", [(0, 1), (100, 1), (1000, 7)])
def test_sample_32_bit_scalars_match_jax(n, seed):
    got = msm_tpu_torch.sample_32_bit_scalars(n, seed=seed)
    assert got == msm_tpu.sample_32_bit_scalars(n, seed=seed)
    assert all(0 <= k < 1 << 32 for k in got)
