"""The port's own copies of the JAX package's configuration, limb helpers and
CPU oracles (msm_tpu_torch.params, .utils.limbs, .oracle) against the
originals: every curve and derived constant, pick_config, the limb round
trips, the samplers, the pure-Python group law and MSM, and best_msm."""

import dataclasses

import numpy as np
import pytest

import msm_tpu
import msm_tpu_torch
from _torch_helpers import port_cfg
from msm_tpu import oracle as joracle
from msm_tpu import params as jparams
from msm_tpu.oracle import pyecc as jpyecc
from msm_tpu.utils import limbs as jlimbs
from msm_tpu_torch import oracle, params
from msm_tpu_torch.oracle import pyecc
from msm_tpu_torch.utils import limbs

CURVE_NAMES = sorted(jparams.CURVES)


def test_same_curves():
    assert sorted(params.CURVES) == CURVE_NAMES and len(CURVE_NAMES) == 7
    for name in CURVE_NAMES:
        assert dataclasses.asdict(params.CURVES[name]) == dataclasses.asdict(jparams.CURVES[name])
    assert params.DEFAULT_CONFIG == port_cfg(jparams.DEFAULT_CONFIG)


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_derived_constants(name):
    for word_size, chunk_size in ((13, 16), (13, 8), (16, 13), (12, 4)):
        j = jparams.MsmConfig(curve=jparams.CURVES[name], word_size=word_size, chunk_size=chunk_size)
        p = port_cfg(j)
        for attr in ("num_words", "mask", "scalar_bits", "num_subtasks", "num_buckets",
                     "index_shift", "r", "rinv", "n0", "r2", "mu", "small_b3", "slack"):
            assert getattr(p, attr) == getattr(j, attr), (attr, word_size, chunk_size)
    for n in (16, 1 << 16, 1 << 18, 1 << 20):
        j = jparams.pick_config(n, jparams.CURVES[name])
        assert params.pick_config(n, params.CURVES[name]) == port_cfg(j)
        assert params.pick_chunk_size(n) == jparams.pick_chunk_size(n)


def test_glv_is_not_ported():
    """GLV is ported now: its window count is the JAX package's (8 at c = 16
    for BN254, not 16). A bad limb width still raises."""
    for chunk in (16, 13, 8):
        j = jparams.MsmConfig(curve=jparams.BN254, chunk_size=chunk, glv=True)
        assert port_cfg(j).num_subtasks == j.num_subtasks
    assert params.MsmConfig(curve=params.BN254, glv=True).num_subtasks == 8
    with pytest.raises(ValueError):
        params.MsmConfig(curve=params.BN254, word_size=20)


def test_limb_round_trips():
    rng = np.random.default_rng(7)
    p = params.BN254.modulus
    xs = [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(20)]
    for w, nw in ((13, 20), (16, 16), (8, 33)):
        a = limbs.ints_to_limbs(xs, w, nw)
        assert np.array_equal(a, jlimbs.ints_to_limbs(xs, w, nw))
        assert limbs.limbs_to_ints(a, w) == xs == jlimbs.limbs_to_ints(a, w)
        assert limbs.limbs_to_int(limbs.int_to_limbs(xs[5], w, nw), w) == xs[5]
    signed = a.astype(np.int64)
    signed[:, 0] -= 300  # balanced limbs: negative values round-trip exactly
    assert [limbs.limbs_to_int(r, 8) for r in signed] == [jlimbs.limbs_to_int(r, 8) for r in signed]
    with pytest.raises(ValueError):
        limbs.int_to_limbs(1 << 40, 13, 3)


@pytest.mark.parametrize("name", ["bn254", "pallas", "bls12_381"])
def test_pyecc_matches_jax_oracle(name):
    cv, jcv = pyecc.Curve(params.CURVES[name]), jpyecc.Curve(jparams.CURVES[name])
    pts, jpts = cv.sample_points(6, seed=11), jcv.sample_points(6, seed=11)
    ks, jks = cv.sample_scalars(6, seed=12), jcv.sample_scalars(6, seed=12)
    assert [dataclasses.astuple(p) for p in pts] == [dataclasses.astuple(p) for p in jpts]
    assert ks == jks
    for a, b in zip(pts, pts[1:] + pts[:1]):
        assert dataclasses.astuple(cv.add(a, b)) == dataclasses.astuple(jcv.add(a, b))
        assert dataclasses.astuple(cv.double(a)) == dataclasses.astuple(jcv.double(a))
    assert cv.add(pts[0], cv.neg(pts[0])).is_identity()
    assert cv.to_affine(cv.msm(pts, ks)) == jcv.to_affine(jcv.msm(jpts, ks))
    assert cv.eq(cv.msm(pts, ks), cv.msm_naive(pts, ks))


def test_samplers_and_best_msm_match_jax():
    n = 40
    pts, ks = msm_tpu_torch.sample_points(n, seed=3), msm_tpu_torch.sample_scalars(n, seed=4)
    assert pts == msm_tpu.sample_points(n, seed=3) and ks == msm_tpu.sample_scalars(n, seed=4)
    ks[:3] = [0, 1, params.BN254.order - 1]
    pts[5] = pts[4]  # a duplicate
    cv = pyecc.Curve(params.BN254)
    got = oracle.best_msm(pts, ks)
    assert cv.to_affine(got) == jpyecc.Curve(jparams.BN254).to_affine(joracle.best_msm(pts, ks))
    assert cv.eq(got, cv.msm([cv.from_affine(*p) for p in pts], ks))
    assert oracle.best_msm([], []).is_identity()
    assert msm_tpu_torch.cpu_msm(pts, ks) == got
