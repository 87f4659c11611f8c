"""``python -m msm_tpu_torch msm`` with ``--device cpu`` (the kernels' plain
twins, at the CLI's window size c = 16) against the JAX package's ``cpu``
command on the same sampled inputs."""

import argparse
import json

import _torch_helpers  # noqa: F401  (one torch thread)
from msm_tpu import cli as jcli
from msm_tpu_torch import cli


def test_msm_on_cpu_matches_jax_cpu(capsys):
    jcli.cmd_cpu(argparse.Namespace(size=5, curve="bn254", seed=4))
    want = json.loads(capsys.readouterr().out)
    cli.main(["msm", "--size", "5", "--seed", "4", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert (got["x"], got["y"]) == (want["x"], want["y"])
    assert set(got) == {"x", "y", "elapsed_ms", "first_run_ms"}
