"""The judge catches the control and each fault that a cell can have: the
harness runs a tiny cell on the CPU with the timed path broken underneath
and ``correct`` comes out false."""

import numpy as np
import pytest

import msm_tpu_torch.models.common as common
import msm_tpu_torch.parallel.sharded_plan as sharded_plan
from msm_tpu_torch.models.plan import MsmPlan
from helpers import MIXED, run_tiny, tiny_conf, traffic

CONF = "bn254_groth16_2p20"


def assert_caught(line, lines):
    assert line["correct"] is False and line["failed"] >= 1
    assert line["checks"]["wrong_calls"]["value"] == line["failed"]
    assert lines[-1].startswith("check wrong_calls: ")


def test_control_is_caught(tmp_path):
    """The reference in the program's place, each scalar's lowest 16-bit
    word dropped."""
    assert_caught(*run_tiny(tiny_conf(CONF), traffic("uniform_b1", mix=MIXED), tmp_path, system="control"))


def test_a_call_that_returns_its_state_unchanged_is_caught(tmp_path, monkeypatch):
    """Each call returns the previous call's result."""
    real = MsmPlan.__call__
    last = {}

    def stale(self, scalars):
        out = real(self, scalars)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    monkeypatch.setattr(MsmPlan, "__call__", stale)
    assert_caught(*run_tiny(tiny_conf(CONF), traffic("uniform_b1"), tmp_path, warmup=2))


def test_half_of_the_points_left_out_is_caught(tmp_path, monkeypatch):
    """The second half of each scalar set is zeroed in the pinned buffer."""
    real = MsmPlan._stage

    def half(self, slot, scalars):
        real(self, slot, scalars)
        self._staging[slot, self.n // 2 :] = 0

    monkeypatch.setattr(MsmPlan, "_stage", half)
    assert_caught(*run_tiny(tiny_conf(CONF), traffic("uniform_b4", batch=2), tmp_path))


def test_the_exchange_between_cards_left_out_is_caught(tmp_path, monkeypatch):
    """The sharded plan keeps the first shard's window sums alone."""
    monkeypatch.setattr(sharded_plan, "merge_shards", lambda parts, cfg, device: parts[0].to(device))
    assert_caught(*run_tiny(tiny_conf("bn254_groth16_2p24_4card"), traffic("uniform_b1"), tmp_path, chips=4))


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path, monkeypatch):
    """The affine result negated as the program produces it."""
    real = common.result_to_affine

    def negated(res, cfg):
        xy = real(res, cfg)
        return None if xy is None else (xy[0], (cfg.curve.modulus - xy[1]) % cfg.curve.modulus)

    monkeypatch.setattr(common, "result_to_affine", negated)
    assert_caught(*run_tiny(tiny_conf(CONF), traffic("uniform_b1"), tmp_path))
