"""Plain twins of the point-add, convert and histogram kernels against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs,
at the shapes tests/test_pallas_curve.py and test_pallas_scan.py use."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import affine_points, canon, mont_limbs, port_cfg, rand_canonical, u16_words_int32
from msm_tpu.models import common as jcommon
from msm_tpu.ops.pallas_convert import make_convert_pack
from msm_tpu.ops.pallas_curve import make_point_add
from msm_tpu.ops.pallas_hist import CHUNK, make_bucket_hist
from msm_tpu.params import BN254, MsmConfig
from msm_tpu_torch.models import common
from msm_tpu_torch.ops import scan as tscan
from msm_tpu_torch.ops.cuda_convert import convert_pack, pack_coords, unpack_coords
from msm_tpu_torch.ops.cuda_curve import point_add
from msm_tpu_torch.ops.cuda_hist import bucket_hist

JCFG = MsmConfig(curve=BN254)
CFG = port_cfg(JCFG)


@pytest.mark.parametrize("signed", [False, True])
def test_point_add_twin_matches_pallas(signed):
    rng = np.random.default_rng(31 if signed else 32)
    B = 256
    coords = [rand_canonical(rng, (B,), CFG) for _ in range(6)]
    coords[0][:8] = 0  # a few identities (0 : R : 0) on the left
    coords[1][:8] = mont_limbs([1], CFG)[0]
    coords[2][:8] = 0
    if signed:  # balanced inputs: negated y values
        coords[1][::3] *= -1
        coords[4][1::3] *= -1
    want = make_point_add(JCFG, tile=128, interpret=True)(*map(jnp.asarray, coords))
    got = point_add(CFG, *map(torch.from_numpy, coords))
    for w, g in zip(want, got):
        assert np.array_equal(canon(w, CFG), canon(g.numpy(), CFG))


def test_convert_twin_matches_pallas_bit_for_bit():
    n = 256
    aff = affine_points(CFG, 32, seed=7)
    pts = [aff[i % 32] for i in range(n - 3)] + [(0, 0), (1, 2), (BN254.modulus - 1, 0)]
    x_u16, y_u16 = jcommon.pad_points_words(pts, JCFG, n)
    want = np.asarray(make_convert_pack(JCFG, tile=128, interpret=True)(
        jnp.asarray(x_u16), jnp.asarray(y_u16)))
    got = convert_pack(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the wire format round-trips: unpack(pack(x)) is canonical x
    D = got.shape[1] // 2
    limbs = unpack_coords(torch.from_numpy(got[:, :D]), CFG)
    assert np.array_equal(pack_coords(limbs, CFG).numpy(), got[:, :D])


def test_convert_twin_on_int16_words_matches_pallas():
    """The port's coordinate words (u16 bits held in int16, as
    common.pad_points_words serializes them) through convert_pack_plain
    equal make_convert_pack's table from the same words held in int32,
    coordinates in [p, 2^256) (unvalidated input) and 0 included."""
    n, q = 256, BN254.modulus
    aff = affine_points(CFG, 32, seed=8)
    rng = np.random.default_rng(8)
    big = [int(v) for v in rng.integers(0, 1 << 62, size=8)]
    pts = [aff[i % 32] for i in range(n - 12)] + [(0, 0), (q, q + 1), (2 * q - 1, 4 * q),
                                                   ((1 << 256) - 1, 5 * q)]
    pts += [(q + (b << 190), (1 << 256) - 1 - b) for b in big]
    x16, y16 = common.pad_points_words(pts, CFG, n)
    assert x16.dtype == np.int16 and (x16 < 0).any()
    got = convert_pack(CFG, torch.from_numpy(x16), torch.from_numpy(y16)).numpy()
    want = np.asarray(make_convert_pack(JCFG, tile=128, interpret=True)(
        *map(jnp.asarray, u16_words_int32(x16, y16))))
    assert np.array_equal(got, want)
    D = got.shape[1] // 2
    xs = [int.from_bytes(r.astype("<u4").tobytes(), "little") for r in got[:, :D]]
    assert xs == [x * CFG.r % q for x, _ in pts]


def test_hist_twin_matches_pallas():
    n, nb = 2 * CHUNK, 1 << 8
    rng = np.random.default_rng(17)
    keys = rng.integers(0, nb, size=n).astype(np.int32)
    keys[: n // 4] = 3  # skew, and some empty buckets
    keys[n // 4 : n // 3] = nb - 1
    want = np.asarray(make_bucket_hist(n, nb, interpret=True)(jnp.asarray(keys))[:nb])
    got = bucket_hist(CFG, torch.from_numpy(keys)[None], nb)[0].numpy()
    assert np.array_equal(got, want)
    ends = tscan._counts_leq(CFG, torch.from_numpy(np.stack([keys, keys[::-1]])), nb)
    assert np.array_equal(ends.numpy(), np.stack([np.cumsum(want)] * 2))


def test_hist_twin_matches_pallas_on_skewed_keys():
    """Half of the keys 0, as zero-padded scalars give, and the rest in the
    narrow range of a top window (keys < 49 of 256 buckets)."""
    n, nb = 2 * CHUNK, 1 << 8
    rng = np.random.default_rng(18)
    keys = np.zeros(n, dtype=np.int32)
    keys[: n // 2 - 1] = rng.integers(0, 49, size=n // 2 - 1)
    want = np.asarray(make_bucket_hist(n, nb, interpret=True)(jnp.asarray(keys))[:nb])
    got = bucket_hist(CFG, torch.from_numpy(keys)[None], nb)[0].numpy()
    assert np.array_equal(got, want) and got[0] > n // 2 and not got[49:].any()
