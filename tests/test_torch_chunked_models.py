"""The naive and batched models above the port's one-pass cap on the CPU:
with ``CHUNK_MAX`` shrunk to 64, 100 points run as two chunks whose window
sums are merged on the device before the host Horner (naive) or the Horner
kernel's twin (batched), against the oracle and the JAX package's chunked
``compute_msm_jpoint``."""

import pytest

import _torch_helpers  # noqa: F401  (one torch thread)
from _chunked import CFG, CV, inputs, small_cap  # noqa: F401  (fixture)
from msm_tpu_torch.models.batched import compute_msm_batched
from msm_tpu_torch.models.naive import compute_msm_naive
from msm_tpu_torch.oracle import best_msm


@pytest.fixture(scope="module")
def case():
    return inputs(seed=63)


def test_chunked_naive(small_cap, case):
    pts, ks, want, jax_res = case
    got = compute_msm_naive(pts, ks, device="cpu")
    assert CV.eq(got, want) and CV.eq(got, jax_res)


def test_chunked_batched(small_cap, case):
    pts, ks, want, jax_res = case
    got = compute_msm_batched([(pts, ks), (pts[:70], ks[:70])], CFG, device="cpu")
    assert CV.eq(got[0], want) and CV.eq(got[0], jax_res)
    assert CV.eq(got[1], best_msm(pts[:70], ks[:70]))
