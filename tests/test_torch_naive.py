"""The naive Pippenger model on the CPU (compute_msm_naive with
device="cpu": every kernel replaced by its plain twin) against the JAX
package's compute_msm_naive and the oracle, and the bucket machinery it
runs on:

- n = 33 (padded to 64) with random points and scalars, and duplicate
  points with the scalars 0, 1 and order - 1 (as tests/test_msm_e2e.py);
- bucket_accumulate (unsigned 8-bit keys, 256 buckets) and
  bucket_reduce_running of two subtasks against the JAX functions, as
  points (the sorts are unstable on both sides);
- sort_payload without signs: unsigned keys, no sign bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import port_cfg, same_points, u16_words_int32
from msm_tpu.models import common as jcommon
from msm_tpu.models.naive import NAIVE_CONFIG as J_NAIVE_CONFIG
from msm_tpu.models.naive import compute_msm_naive as j_compute_msm_naive
from msm_tpu.ops import scan as jscan
from msm_tpu.ops.curve import get_curve_ctx as j_curve_ctx
from msm_tpu.ops.decompose import extract_windows as j_extract_windows
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254
from msm_tpu_torch.models import common
from msm_tpu_torch.models.naive import NAIVE_CONFIG, compute_msm_naive
from msm_tpu_torch.ops import scan
from msm_tpu_torch.ops.curve import get_curve_ctx
from msm_tpu_torch.ops.decompose import extract_windows

CFG = port_cfg(J_NAIVE_CONFIG)
CV = Curve(BN254)


def _fixture(n, seed):
    pts = [CV.to_affine(p) for p in CV.sample_points(n, seed=seed)]
    return pts, CV.sample_scalars(n, seed=seed + 50)


def _duplicates_and_edges():
    pts, _ = _fixture(4, seed=2)
    return [pts[0], pts[0], pts[1], pts[2]], [1, 1, 0, BN254.order - 1]


@pytest.mark.parametrize("case", ["n33", "duplicates_edges"])
def test_naive_msm_matches_jax_and_oracle(case):
    pts, ks = _fixture(33, seed=1) if case == "n33" else _duplicates_and_edges()
    assert NAIVE_CONFIG == CFG and NAIVE_CONFIG.num_subtasks == 32
    got = compute_msm_naive(pts, ks, device="cpu")
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want) and not want.is_identity()
    assert CV.eq(j_compute_msm_naive(pts, ks), want)


def test_naive_empty_and_glv():
    assert compute_msm_naive([], [], device="cpu").is_identity()
    glv = dataclasses.replace(NAIVE_CONFIG, glv=True)
    with pytest.raises(NotImplementedError):
        compute_msm_naive(*_fixture(2, seed=3), config=glv, device="cpu")


def test_bucket_accumulate_and_running_match_jax():
    n, R, c = 64, 8, 8
    pts, ks = _fixture(n, seed=4)
    x_u16, y_u16, s_u16 = common.pad_inputs(pts, ks, CFG)
    keys = extract_windows(torch.from_numpy(s_u16), c, CFG.num_subtasks)[:2]
    packed = common.prepare_points(CFG, torch.from_numpy(x_u16), torch.from_numpy(y_u16))
    ec = get_curve_ctx(CFG)
    buckets = scan.bucket_accumulate(ec, packed, keys, None, 1 << c, R, batch=2)
    w = scan.bucket_reduce_running(ec, buckets)

    jec = j_curve_ctx(J_NAIVE_CONFIG)
    jpts, jpacked = jcommon.prepare_points(jec, *map(jnp.asarray, u16_words_int32(x_u16, y_u16)), R)
    jkeys = j_extract_windows(jnp.asarray(s_u16), c, J_NAIVE_CONFIG.num_subtasks)

    @jax.jit
    def subtask(k):
        b = jscan.bucket_accumulate(jec, jpts, k, 1 << c, R, affine=True, packed=jpacked)
        return b, jscan.bucket_reduce_running(jec, b)

    assert np.array_equal(keys.numpy(), np.asarray(jkeys)[:2])
    for sub in range(2):
        jb, jw = subtask(jkeys[sub])
        assert same_points([np.asarray(a) for a in jb], [a[sub].numpy() for a in buckets], CFG)
        assert same_points([np.asarray(a) for a in jw], [a[sub].numpy() for a in w], CFG)


def test_sort_payload_without_signs():
    rng = np.random.default_rng(5)
    n = 64
    keys = torch.from_numpy(rng.integers(0, 16, size=(3, n)).astype(np.int32))
    pv, sbit = scan.sort_payload(keys, None)
    assert sbit == 6 and pv.shape == keys.shape and (pv >> sbit == 0).all()
    for g in range(3):
        assert sorted(pv[g].tolist()) == list(range(n))  # a permutation
        assert (torch.diff(keys[g, pv[g].long()]) >= 0).all()  # sorted by key
    # the same order and indices as with all-positive signs
    pv0, _ = scan.sort_payload(keys, torch.zeros_like(keys, dtype=torch.bool))
    assert torch.equal(keys.gather(-1, pv.long()), keys.gather(-1, pv0.long()))
    assert (pv0 >> sbit == 0).all()
