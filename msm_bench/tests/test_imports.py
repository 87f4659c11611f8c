"""Nothing the benchmark runs loads JAX, the JAX package or the root
``bench.py``, and the reference side loads nothing of the program either.
Module names are compared by their top-level name (before the first dot),
whole: ``msm_tpu_torch`` is not ``msm_tpu``."""

import ast
import json
import os
import subprocess
import sys

import pytest

from msm_bench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "msm_tpu", "bench"}
#: modules of the yardstick that may not use the program
INDEPENDENT = ["reference", "points", "traffic", "roofline", "trace"]


def imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_top_level_names_are_compared_whole():
    assert core.forbidden_modules() == [] or all(m.split(".")[0] in FORBIDDEN for m in core.forbidden_modules())
    sys.modules["msm_tpu_torch_probe.x"] = sys  # a name that begins with msm_tpu
    try:
        assert "msm_tpu_torch_probe.x" not in core.forbidden_modules()
    finally:
        del sys.modules["msm_tpu_torch_probe.x"]


@pytest.mark.parametrize("path", sorted(p for p in core.HERE.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(core.HERE)))
def test_no_source_imports_a_forbidden_module(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN
    if path.stem in INDEPENDENT:
        assert "msm_tpu_torch" not in tops


def _loaded_after(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(core.ROOT))
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                       capture_output=True, text=True, cwd=core.ROOT, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_side_loads_nothing_of_the_program():
    tops = _loaded_after("\n".join(f"import msm_bench.{m}" for m in INDEPENDENT))
    assert not tops & (FORBIDDEN | {"msm_tpu_torch", "torch"})


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(core.HERE / 'tests')!r})
from pathlib import Path
from helpers import run_tiny, tiny_conf, traffic
line, _ = run_tiny(tiny_conf("bn254_groth16_2p20"), traffic("uniform_b1"), Path({str(tmp_path)!r}))
assert line["correct"]
from msm_bench import core
for name in ("upload_ms", "stage12_ms", "stage3_ms", "stage4_ms", "idle_share", "shard_idle_share_max",
             "device_peak_gib", "msm_roofline", "points_per_s", "call_ms_p95", "setup_s"):
    core.metric_module(name)
core.launches()
"""
    tops = _loaded_after(code)
    assert "msm_tpu_torch" in tops and not tops & FORBIDDEN
