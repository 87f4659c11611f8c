"""Tiny cells end to end on the CPU (the program's plain twins): the result
line's form and ``correct``, and the command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from msm_bench import core
from helpers import MIXED, run_tiny, tiny_conf, traffic

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def check_form(line):
    assert list(line) == KEYS  # "checks" last
    assert isinstance(line["attempted"], int) and line["attempted"] >= 1
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert line["checks"] == {"wrong_calls": {"value": line["failed"], "limit": 0}}
    json.dumps(line)


@pytest.mark.parametrize("conf,tr,chips", [
    ("bn254_groth16_2p20", traffic("uniform_b1", mix=MIXED), 1),
    ("bls12_377_zprize_2p22", traffic("uniform_b4", batch=2), 1),
    ("bn254_groth16_2p24_4card", traffic("uniform_b1"), 4),
], ids=["mixed_scalars", "bls12_377_batch", "sharded"])
def test_tiny_cell_is_correct(conf, tr, chips, tmp_path):
    line, lines = run_tiny(tiny_conf(conf), tr, tmp_path, chips=chips)
    check_form(line)
    assert line["correct"] and line["failed"] == 0 and line["device"]["count"] == chips
    assert set(line["metrics"]) == {"points_per_s", "setup_s"}  # call_ms_p95 names its cells
    assert lines[-1].startswith("check wrong_calls: 0 (limit 0)")


def test_the_command_refuses_without_a_card():
    """No result line and a non-zero exit without CUDA (this machine has
    none; on a card the test has nothing to show)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    env = dict(os.environ, PYTHONPATH=str(core.ROOT))
    p = subprocess.run([sys.executable, "-m", "msm_bench", "--workload", "bn254_g16_2p20_uniform", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True, cwd=core.ROOT, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == "" and "CUDA" in p.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder gives no result."""
    import shutil

    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "msm_bench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "msm_bench", "--workload", "bn254_g16_2p20_uniform", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True, cwd=tmp_path,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.chip
def test_a_cell_on_the_card():
    """One short run of the headline cell on a CUDA card: correct, with
    every end-to-end metric it names."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "msm_bench", "--workload", "bn254_g16_2p20_uniform", "--seed",
                        "2147483659", "--seconds", "2"], capture_output=True, text=True, cwd=core.ROOT,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"points_per_s", "call_ms_p95", "setup_s"}
