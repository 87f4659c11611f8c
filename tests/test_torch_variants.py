"""mont_variant_bench and the command line's ``variants`` on the CPU: the
report's keys are those of the port (what ran, not the JAX package's
TPU names), every time finite and positive, the per-product time the
point add's over its 12 products; ``--device cuda`` without a card exits
non-zero before anything runs."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from msm_tpu_torch import cli
from msm_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"batch", "word_size", "num_words", "mont_torch_ms", "barrett_torch_ms", "cuda_add_ms",
        "mont_cuda_ms_per_mul_equiv"} | {f"mont_{v}_w{w}_ms" for v in ("eager", "nsafe") for w in (13, 14, 15, 16)}


def _check(report, batch):
    assert set(report) == KEYS
    assert (report["batch"], report["word_size"], report["num_words"]) == (batch, 13, 20)
    for k, v in report.items():
        if k.endswith("_ms"):
            assert math.isfinite(v) and v > 0, k
    assert report["mont_cuda_ms_per_mul_equiv"] == report["cuda_add_ms"] / 12


def test_mont_variant_bench_keys_on_cpu():
    _check(profiling.mont_variant_bench(batch=64, reps=1, device="cpu"), 64)


def test_variants_command_prints_the_report():
    r = subprocess.run([sys.executable, "-m", "msm_tpu_torch", "variants", "--device", "cpu", "--size", "6"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _check(json.loads(r.stdout), 64)


def test_variants_without_a_card_runs_nothing(monkeypatch):
    def ran(*args, **kw):
        raise AssertionError("mont_variant_bench ran")

    monkeypatch.setattr(profiling, "mont_variant_bench", ran)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        cli.main(["variants", "--size", "6"])
    assert exit_.value.code not in (0, None)
    r = subprocess.run([sys.executable, "-m", "msm_tpu_torch", "variants", "--size", "6"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == "" and "no CUDA device" in r.stderr
