"""The port's MSM above its one-pass cap on the CPU: with ``CHUNK_MAX``
shrunk to 64, 100 points run as two chunks whose window sums are merged by
the point add, plain and pair-compressed, against the oracle and against
the JAX package's chunked ``compute_msm_jpoint`` (its caps shrunk the same
way); and the chunk helpers."""

import dataclasses

import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
from _chunked import CAP, CFG, CV, inputs, small_cap  # noqa: F401  (fixture)
import msm_tpu_torch
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import pick_geometry
from msm_tpu_torch.ops.curve import PointBatch, get_curve_ctx


@pytest.fixture(scope="module")
def case():
    return inputs(seed=61)


@pytest.mark.parametrize("compress", [False, True])
def test_chunked_msm_matches_oracle_and_jax(small_cap, case, compress):
    pts, ks, want, jax_res = case
    got = msm_tpu_torch.run_gpu_msm(pts, ks, config=dataclasses.replace(CFG, compress=compress), device="cpu")
    assert not want.is_identity() and got == CV.to_affine(want) == CV.to_affine(jax_res)


def test_chunk_slices(small_cap):
    assert cuzk.chunk_slices(256) == [slice(0, 64), slice(64, 128), slice(128, 192), slice(192, 256)]
    assert cuzk.chunk_slices(32) == [slice(0, 32)]
    parts = list(cuzk.chunks((torch.arange(128), torch.arange(128) + 1), "cpu"))
    assert [p[1][0].item() for p in parts] == [1, 65] and all(len(p[0]) == CAP for p in parts)


def test_device_chunks_sum_to_the_whole(small_cap, case):
    """cuzk_msm_point over device inputs of 128 rows (two chunks) equals the
    oracle, and the merge of the two chunks' window sums is their point sum."""
    pts, ks, want, _ = case
    xd, yd, sd = (torch.from_numpy(a) for a in common.pad_inputs(pts, ks, CFG))
    geom = pick_geometry(CAP, CFG)
    assert CV.eq(common.std_ints_to_jpoint(*cuzk.cuzk_msm_point(xd, yd, sd, CFG, geom), CFG), want)
    ws = [cuzk.cuzk_window_sums(xd[s], yd[s], sd[s], CFG, geom) for s in cuzk.chunk_slices(128)]
    merged = cuzk.merge_window_sums(ws, CFG)
    ec = get_curve_ctx(CFG)
    pair_sum = ec.add(PointBatch(*ws[0].unbind(1)), PointBatch(*ws[1].unbind(1)))
    assert bool(ec.eq(PointBatch(*merged.unbind(1)), pair_sum).all())
    assert cuzk.merge_window_sums(ws[:1], CFG) is ws[0]


def test_host_inputs_and_chunk_log(small_cap, case, monkeypatch, capsys):
    """cuzk_msm_point over host arrays uploads each chunk to the device it
    is given (host arrays without one are refused); with MSM_TPU_DEBUG set,
    each chunk is logged to stderr as its pass starts."""
    pts, ks, want, _ = case
    arrays = common.pad_inputs(pts, ks, CFG)
    geom = pick_geometry(CAP, CFG)
    with pytest.raises(TypeError, match="explicit device"):
        cuzk.cuzk_msm_point(*arrays, CFG, geom)
    monkeypatch.setenv("MSM_TPU_DEBUG", "1")
    assert CV.eq(common.std_ints_to_jpoint(*cuzk.cuzk_msm_point(*arrays, CFG, geom, device="cpu"), CFG), want)
    assert capsys.readouterr().err.splitlines() == ["chunk 1/2: rows 0..64", "chunk 2/2: rows 64..128"]
