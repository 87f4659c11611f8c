"""The port's profiling and log utilities on the CPU: ``stage_timings`` at 64
points reports the JAX package's keys (listed here: the JAX report takes
about a minute to compute on this machine), ``trace`` writes a Chrome
trace, and ``debug`` prints only when MSM_TPU_DEBUG is set."""

import json

import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
from msm_tpu_torch.params import BN254, MsmConfig
from msm_tpu_torch.utils import log, profiling

#: msm_tpu.utils.profiling.stage_timings' report at chunk 8 (S = 32)
JAX_KEYS = {"n", "curve", "num_subtasks", "geometry", "stages_ms", "field_muls_per_sec_nominal"}
JAX_STAGES = {"convert_points", "decompose_scalars", "boundary_prefix_per_subtask", "window_sum_x32_batched",
              "full_pipeline"}


def test_stage_timings_report():
    report = profiling.stage_timings(64, MsmConfig(curve=BN254, chunk_size=8), seed=1, device="cpu", reps=1)
    assert set(report) == JAX_KEYS and set(report["stages_ms"]) == JAX_STAGES
    assert set(report["geometry"]) == {"num_rows", "bpr_threads"}
    assert (report["n"], report["curve"], report["num_subtasks"]) == (64, "bn254", 32)
    assert all(v > 0 for v in report["stages_ms"].values())
    assert report["field_muls_per_sec_nominal"] == round(32 * 64 * 13 / (report["stages_ms"]["full_pipeline"] / 1e3))


def test_trace_writes_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.trace(path):
        torch.arange(8).sum()
    assert "traceEvents" in json.loads(path.read_text())


@pytest.mark.parametrize("value,printed", [("1", True), ("0", False), (None, False)])
def test_debug_gated_by_env(monkeypatch, capsys, value, printed):
    if value is None:
        monkeypatch.delenv("MSM_TPU_DEBUG", raising=False)
    else:
        monkeypatch.setenv("MSM_TPU_DEBUG", value)
    log.debug("stage", 3)
    assert capsys.readouterr().err == ("stage 3\n" if printed else "")
