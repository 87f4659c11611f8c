"""Every configuration, traffic mix and metric that BENCHMARK.json names
loads by its name, and the file keeps the contract's form."""

import json
import re

import pytest

from msm_bench import core, traffic

BENCH = core.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["msm_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "msm_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_loads(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"} and NAME.match(entry["name"])
    assert entry["file"].startswith("msm_bench/configs/")
    conf = json.loads((core.ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["reduced"] == entry["reduced"]
    assert all(k in conf for k in entry["reduced"])
    core.program_config(conf, 1 << conf["log_n"])  # the program's curve, the file's constants
    assert [w for w in BENCH["workloads"] if w["config"] == entry["name"]], "every configuration has a cell"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and NAME.match(cell["name"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    got, conf, tr = core.cell_files(BENCH, cell["name"])
    assert got is cell and conf["devices"] == cell["chips"]
    traffic.check(tr)


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_loads(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert callable(core.metric_module(entry["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if entry in BENCH["end_to_end"]:
        assert entry["source"] in ("host_clock", "device_trace") and 0.01 <= entry["bound"] <= 0.25
    else:
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]} and "bound" not in entry


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in BENCH["workloads"]:
        for group, least in (("end_to_end", 2), ("per_layer", 1)):
            got = [m for m in BENCH[group] if cell["name"] in m.get("workloads", [cell["name"]])]
            assert len(got) >= least, (cell["name"], group)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_four_card_cells_at_most_one():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
