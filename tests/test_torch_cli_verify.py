"""``python -m msm_tpu_torch verify`` with ``--device cpu``: the plain
twins' MSM bit for bit against the oracle, as the JAX command prints it;
and under ``--glv``."""

import json

import pytest

import _torch_helpers  # noqa: F401  (one torch thread)
from msm_tpu_torch import cli


@pytest.mark.parametrize("flags", [[], ["--glv"]])
def test_verify_on_cpu(capsys, flags):
    cli.main(["verify", "--size", "5", "--seed", "6", "--device", "cpu", *flags])
    assert json.loads(capsys.readouterr().out) == {"size": 5, "curve": "bn254", "bit_exact": True}
