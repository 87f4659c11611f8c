"""msm_tpu_torch must run where JAX is not installed and stand apart from the
JAX package: importing every module of the port leaves jax and msm_tpu out
of sys.modules, and no source of the port, nor chip_smoke.py, imports
either. chip_smoke.py must fail (non-zero exit, no ok line) without a GPU
and outside the repository."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "msm_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _import_all(check: str) -> None:
    """Import every module of the port in a fresh process, then run
    ``check`` there."""
    mods = _modules()
    assert {"msm_tpu_torch.ops.scan", "msm_tpu_torch.models.naive", "msm_tpu_torch.ops.glv", "msm_tpu_torch.cli",
            "msm_tpu_torch.__main__", "msm_tpu_torch.bench", "msm_tpu_torch.utils.profiling",
            "msm_tpu_torch.utils.log", "msm_tpu_torch.parallel", "msm_tpu_torch.parallel.sharded",
            "msm_tpu_torch.parallel.sharded_plan", "msm_tpu_torch.parallel.multihost",
            "msm_tpu_torch.ops.twisted_ec", "msm_tpu_torch.oracle.stages"} <= set(mods)
    code = "import importlib, sys\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods
    ) + check
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_package_imports_without_jax():
    _import_all("assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")


def test_package_imports_without_msm_tpu():
    _import_all(
        "bad = sorted(m for m in sys.modules if m == 'msm_tpu' or m.startswith('msm_tpu.'))\n"
        "assert not bad, bad\n"
    )


def _offenders(pattern: str) -> list[str]:
    pat = re.compile(pattern, re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    return [str(p) for p in files if pat.search(p.read_text())]


def test_no_jax_import_in_sources():
    assert _offenders(r"^\s*(import jax|from jax)") == []


def test_no_msm_tpu_import_in_sources():
    assert _offenders(r"^\s*(from|import) msm_tpu(\.|\s|$)") == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_gpu(tmp_path):
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    r = _run_smoke(alone)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
