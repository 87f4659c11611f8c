"""The serving plan above the port's one-pass cap on the CPU: with
``CHUNK_MAX`` shrunk to 64, a plan over 100 points keeps one table per
chunk, and its calls on ints and on u16 words and its ``run_batch`` merge
the chunks' window sums, against the oracle and the JAX package's chunked
``compute_msm_jpoint``."""

import numpy as np
import pytest

import _torch_helpers  # noqa: F401  (one torch thread)
from _chunked import CAP, CFG, CV, inputs
import msm_tpu_torch
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.oracle import best_msm


@pytest.fixture(scope="module")
def case():
    return inputs(seed=62)


@pytest.fixture(scope="module")
def plan(case):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuzk, "CHUNK_MAX", CAP)
        yield msm_tpu_torch.plan(case[0], config=CFG, device="cpu")


def test_plan_keeps_a_table_per_chunk(plan):
    assert len(plan.tables) == 2 and plan.slices == [slice(0, 64), slice(64, 128)]
    assert all(t.shape[0] == CAP for t in plan.tables)


@pytest.mark.parametrize("form", ["ints", "words"])
def test_plan_call_matches_oracle_and_jax(plan, case, form):
    _, ks, want, jax_res = case
    got = plan.jpoint(ks if form == "ints" else common.ints_to_u16_array(ks))
    assert CV.eq(got, want) and CV.eq(got, jax_res)


def test_plan_run_batch(plan, case):
    pts, ks, _, jax_res = case
    got = plan.run_batch([np.roll(common.ints_to_u16_array(ks), 7, axis=0), ks])
    assert CV.eq(got[0], best_msm(pts, [ks[(j - 7) % len(ks)] for j in range(len(ks))]))
    assert CV.eq(got[1], jax_res)
