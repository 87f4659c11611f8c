"""Tiny cells for the CPU tests: the benchmark's own configuration and
traffic files with the points cut to 2^log_n, run with 8-bit windows (the
plain twins' Horner ladders are serial on the CPU)."""

import dataclasses
import json
from unittest import mock

from msm_bench import core

#: a mix of every kind the generator makes: zeros, ones, 32-bit and
#: uniform scalars
MIXED = [{"share": 0.4, "kind": "const", "value": 0}, {"share": 0.3, "kind": "const", "value": 1},
         {"share": 0.1, "kind": "range", "lo": 2, "hi": 2**32}, {"share": 0.2, "kind": "uniform"}]


def tiny_conf(name: str, log_n: int = 5) -> dict:
    conf = json.loads((core.HERE / "configs" / f"{name}.json").read_text())
    conf.update(name=f"tiny_{name}", log_n=log_n, points_seed=conf["points_seed"] + 1)
    return conf


def traffic(name: str, **changes) -> dict:
    t = json.loads((core.HERE / "traffic" / f"{name}.json").read_text())
    t.update(changes)
    return t


def run_tiny(conf: dict, tr: dict, tmp_path, seed: int = 2**31 + 7, chips: int = 1, warmup: int = 0,
             system: str = "program"):
    cell = {"name": "tiny", "config": conf["name"], "traffic": "tiny", "chips": chips}
    conf = dict(conf, devices=chips)
    real = core.program_config
    small = mock.patch.object(core, "program_config",
                              lambda c, n: dataclasses.replace(real(c, n), chunk_size=8))
    with small:
            return core.run(cell, conf, tr, seed, 0.0, False, core.load_bench()["end_to_end"], device="cpu",
                        system=system, cache=tmp_path / "points", warmup=warmup)
