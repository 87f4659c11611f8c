"""msm_tpu_torch.parallel.sharded's MSM on the CPU (every kernel replaced
by its plain twin; D shards on ``[torch.device("cpu")] * D``) with
tests/test_sharded.py's config, inputs and seeds: at D = 2 and 8 over 257
points (padding spread across the shards) against the oracle, at D = 4
against the port's single-device MSM, compressed + GLV at D = 2, the
composition with chunks above ``CHUNK_MAX``, and the power-of-two rule."""

import dataclasses

import pytest
import torch

import msm_tpu_torch
from msm_tpu_torch.models import cuzk
from msm_tpu_torch.models.geometry import pick_geometry
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.parallel import compute_msm_sharded, default_mesh
from test_torch_sharded import CFG, CV, WIDE, _cpus, _sample


@pytest.fixture(scope="module")
def inputs100():
    """tests/test_sharded.py::test_sharded_matches_single_chip's inputs."""
    return _sample(100, seed=7)


def test_sharded_matches_single_device(inputs100):
    """D = 4 in the default geometry against the port's single-device
    compute_msm_jpoint."""
    pts, ks = inputs100
    got = msm_tpu_torch.run_gpu_msm_sharded(pts, ks, CFG, devices=_cpus(4))
    assert CV.eq(got, cuzk.compute_msm_jpoint(pts, ks, CFG, geometry=WIDE, device="cpu"))


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_msm_matches_oracle(d):
    pts, ks = _sample(257, seed=3)  # padded to 512 rows, 256 or 64 a shard
    got = compute_msm_sharded(pts, ks, CFG, devices=_cpus(d), geometry=WIDE)
    assert CV.eq(got, best_msm(pts, ks))


def test_sharded_glv_compress_matches_oracle():
    cfg = dataclasses.replace(CFG, compress=True, glv=True)
    pts, ks = _sample(64, seed=21)
    geom = dataclasses.replace(pick_geometry(32, cfg), subtask_batch=cfg.num_subtasks)
    assert CV.eq(compute_msm_sharded(pts, ks, cfg, devices=_cpus(2), geometry=geom), best_msm(pts, ks))


def test_sharded_chunked_composition(monkeypatch):
    """Shards above CHUNK_MAX rows run chunks on their device: 128 points
    over 2 shards with CHUNK_MAX = 32, two chunks a shard, each shard's
    chunks merged before the tree."""
    monkeypatch.setattr(cuzk, "CHUNK_MAX", 32)
    pts, ks = _sample(128, seed=32)
    got = compute_msm_sharded(pts, ks, CFG, devices=_cpus(2), geometry=WIDE)
    assert CV.eq(got, best_msm(pts, ks))


def test_empty_and_mesh_rules():
    """n = 0 is the identity; D not a power of two raises ValueError; no
    CUDA device and no devices raises (no fallback to the CPU)."""
    assert compute_msm_sharded([], [], CFG, devices=_cpus(3)).is_identity()
    pts, ks = _sample(16, seed=5)
    with pytest.raises(ValueError, match="power of two"):
        compute_msm_sharded(pts, ks, CFG, devices=_cpus(3))
    assert default_mesh(["cpu", "cpu"]) == _cpus(2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            msm_tpu_torch.run_gpu_msm_sharded(pts, ks, CFG)
