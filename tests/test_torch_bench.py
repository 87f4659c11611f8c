"""The port's bench (``python -m msm_tpu_torch.bench``) with ``--device
cpu``: its default and ``--batched`` lines carry ``bench.py``'s keys (less
the TPU calibrations ``measured_floor_*``) plus ``device``, and read
``verified: true``; the folded oracle equals the oracle MSM over every
tiled point."""

import json

import numpy as np
import pytest

import _torch_helpers  # noqa: F401  (one torch thread)
from msm_tpu_torch import bench
from msm_tpu_torch.models import common
from msm_tpu_torch.oracle import best_msm
from msm_tpu_torch.oracle.pyecc import Curve
from msm_tpu_torch.params import BN254

#: bench.py's line in its default mode, less measured_floor_ms and
#: measured_floor_frac, plus device
MSM_KEYS = {"metric", "value", "unit", "vs_baseline", "config", "verified", "field_muls_per_sec_nominal", "device"}


def _line(capsys, argv) -> dict:
    bench.main([*argv, "--size", "6", "--device", "cpu", "--reps", "1", "--verify"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_default_line(capsys):
    out = _line(capsys, [])
    assert set(out) == MSM_KEYS
    assert out["metric"] == "bn254_msm_2^6_wall_clock" and out["unit"] == "ms"
    assert out["verified"] is True and out["config"] == "base" and out["device"] == "cpu"


def test_batched_line(capsys):
    out = _line(capsys, ["--batched", "2"])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "config", "verified", "device"}
    assert out["metric"] == "bn254_batched_msm_2x2^6_per_instance" and out["verified"] is True


@pytest.mark.parametrize("n,dtype", [(3000, np.uint16), (2048, np.int16), (40, np.int32)])
def test_folded_oracle_equals_oracle(n, dtype):
    pts, ks = bench.sample_inputs(n, BN254, seed=8)
    words = common.ints_to_u16_array(ks)
    if dtype == np.int16:
        words = words.view(np.int16)
    got = bench.folded_oracle(pts[:1024], words.astype(dtype) if dtype == np.int32 else words)
    assert Curve(BN254).eq(got, best_msm(pts, ks))
