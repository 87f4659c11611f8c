"""msm_tpu_torch.parallel.sharded_plan on the CPU (every kernel replaced by
its plain twin; D shards on ``[torch.device("cpu")] * D``) against the
oracle and the port's single-device plan, with tests/test_sharded_plan.py's
config, inputs and seeds: two scalar sets at D = 8 over 257 points, the
single-device plan at D = 4, run_batch with a zero set, the words path
(u16 words, int16 words >= 0x8000 and the int32 words of
``pad_scalars_words``; the JAX sharded plan has no words test), chunks
above ``CHUNK_MAX`` a shard, and the power-of-two rule."""

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
import msm_tpu_torch
from msm_tpu_torch.models import common, cuzk
from msm_tpu_torch.models.geometry import MsmGeometry
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254, MsmConfig
from msm_tpu_torch.parallel import ShardedMsmPlan, plan_sharded

CV = Curve(BN254)
CFG8 = MsmConfig(curve=BN254, chunk_size=8)
R = BN254.order
#: every subtask in one batch: the CPU twins' serial steps run once for all
#: 32 windows (the default geometry is covered at D = 4)
WIDE = MsmGeometry(num_rows=8, bpr_threads=8, subtask_batch=CFG8.num_subtasks)


def _fixture(n, seed=0):
    pts = [CV.to_affine(p) for p in CV.sample_points(n, seed=seed)]
    return pts, CV.sample_scalars(n, seed=seed + 50), CV.sample_scalars(n, seed=seed + 51)


def _cpus(d):
    return [torch.device("cpu")] * d


def _ints(words):
    return [int.from_bytes(np.asarray(row).astype("<u2").tobytes(), "little") for row in words]


def test_sharded_plan_two_scalar_sets():
    n = 257  # padding spread across the shards: 512 rows, 64 a shard
    pts, ks1, ks2 = _fixture(n, seed=21)
    splan = ShardedMsmPlan(pts, devices=_cpus(8), config=CFG8, geometry=WIDE)
    assert (splan.N, splan.shard_n, len(splan.tables)) == (512, 64, 8)
    assert all(len(t) == 1 and t[0].shape[0] == 64 for t in splan.tables)
    got = splan.run_batch([ks1, ks2])
    assert CV.eq(got[0], best_msm(pts, ks1)) and CV.eq(got[1], best_msm(pts, ks2))


def test_sharded_plan_matches_single_device_plan():
    """D = 4 in the default geometry against msm_tpu_torch.plan."""
    pts, ks1, _ = _fixture(100, seed=22)
    splan = msm_tpu_torch.plan_sharded(pts, devices=_cpus(4), config=CFG8)
    plan = msm_tpu_torch.plan(pts, config=CFG8, device="cpu")
    assert CV.eq(splan.jpoint(ks1), plan.jpoint(ks1))


def test_sharded_plan_words_and_affine_call():
    """One run_batch over ints, zeros, u16 words [n, 16], int16 words with
    every word but the top one >= 0x8000, and the int32 words of
    pad_scalars_words [N, 16]; the affine call and the identity."""
    n = 128
    pts, ks1, ks2 = _fixture(n, seed=23)
    splan = plan_sharded(pts, devices=_cpus(2), config=CFG8, geometry=WIDE)
    rng = np.random.default_rng(24)
    high = rng.integers(0x8000, 0x10000, size=(n, 16)).astype(np.uint16)
    high[:, 15] = rng.integers(0, R >> 240, size=n)
    sets = [ks1, [0] * n, common.ints_to_u16_array(ks2), high.view(np.int16),
            common.pad_scalars_words(ks1[::-1], CFG8, splan.N)]
    wants = [ks1, [0] * n, ks2, _ints(high), ks1[::-1]]
    got = splan.run_batch(sets)
    for g, ks in zip(got, wants):
        assert CV.eq(g, best_msm(pts, ks))
    assert got[1].is_identity()
    assert splan(common.ints_to_u16_array(ks2)) == CV.to_affine(got[2])
    assert splan.run_batch([]) == []
    with pytest.raises(ValueError, match="scalars"):
        splan(ks1[:-1])


def test_sharded_plan_chunked(monkeypatch):
    """Shards above CHUNK_MAX rows keep a table a chunk: 128 points over 2
    shards with CHUNK_MAX = 32, two tables a shard."""
    monkeypatch.setattr(cuzk, "CHUNK_MAX", 32)
    pts, ks1, ks2 = _fixture(128, seed=24)
    splan = plan_sharded(pts, devices=_cpus(2), config=CFG8, geometry=WIDE)
    assert [len(t) for t in splan.tables] == [2, 2] and splan.slices == [slice(0, 32), slice(32, 64)]
    got = splan.run_batch([ks1, ks2])
    assert CV.eq(got[0], best_msm(pts, ks1)) and CV.eq(got[1], best_msm(pts, ks2))


def test_sharded_plan_rejects_non_pow2_mesh():
    pts, _, _ = _fixture(16, seed=25)
    with pytest.raises(ValueError, match="power of two"):
        plan_sharded(pts, devices=_cpus(3), config=CFG8)
    with pytest.raises(ValueError, match="non-empty"):
        plan_sharded([], devices=_cpus(2), config=CFG8)
