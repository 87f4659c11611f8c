"""The port's bench in its ``--plan B`` mode with ``--device cpu``: one line
with ``bench.py``'s plan keys (``relay_note``, a TPU-rig note, left out)
plus ``config``, ``verified`` and ``device``, every result held to its
folded oracle."""

import json

import _torch_helpers  # noqa: F401  (one torch thread)
from msm_tpu_torch import bench


def test_plan_line(capsys):
    bench.main(["--plan", "2", "--size", "6", "--device", "cpu", "--reps", "1", "--verify"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "call_ms", "batch_ms_per_instance", "program_ms",
                        "batch_program_ms_per_instance", "config", "verified", "device"}
    assert out["metric"] == "bn254_plan_msm_2^6_per_instance" and out["verified"] is True
    assert out["value"] == min(out["call_ms"], out["batch_ms_per_instance"])
