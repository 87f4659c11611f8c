"""The port's command line (``python -m msm_tpu_torch``) on the CPU against
the JAX package's (``msm_tpu/cli.py``): the port's sampler draws the JAX
sampler's points and scalars; ``cpu`` prints the JAX command's x and y (on
BN254 and on another curve); without a CUDA device the default ``--device
cuda`` ends every device command, and the bench, with a non-zero exit
before it samples anything."""

import argparse
import json

import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread)
import msm_tpu
from msm_tpu import cli as jcli
from msm_tpu_torch import bench, cli
from msm_tpu_torch.params import CURVES


@pytest.mark.parametrize("n,seed", [(40, 3), (1100, 5)])
def test_sampler_matches_jax_sampler(n, seed):
    pts, ks = bench.sample_inputs(n, CURVES["bn254"], seed)
    jpts, jks = jcli._sample_lib(n, msm_tpu.BN254, seed=seed)
    assert pts == jpts and ks == jks


def _xy(capsys) -> tuple[str, str]:
    out = json.loads(capsys.readouterr().out)
    return out["x"], out["y"]


@pytest.mark.parametrize("curve,size", [("bn254", 8), ("pallas", 5), ("bls12_377", 4)])
def test_cpu_matches_jax_cpu(capsys, curve, size):
    cli.main(["cpu", "--size", str(size), "--curve", curve, "--seed", "2"])
    got = _xy(capsys)
    jcli.cmd_cpu(argparse.Namespace(size=size, curve=curve, seed=2))
    assert got == _xy(capsys) and got != ("0", "0")


@pytest.mark.parametrize("argv", [["msm"], ["verify", "--glv"], ["profile", "--compress"], ["bench"]])
def test_default_device_needs_cuda(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "sample_inputs", lambda *a: pytest.fail("sampled without a device"))
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--size", "4"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
