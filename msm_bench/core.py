"""The harness: one run of one cell, from its files to the result line.

A run builds the cell's system under test (the program's serving plan over
the configuration's points), makes the traffic's scalar pool from
``--seed``, warms up, and then, for ``--seconds``, calls it in a closed
loop with one caller: each call is made as soon as the previous result is
back on the host as an affine point (calls may not overlap: they share the
plan's pinned buffer). The window runs from the first call's start to the
end of the first call that ends past ``--seconds``, so it holds whole calls
and all of their time. Once it has closed, the peaks are read, the program
is freed, and every call's points are held to the plain reference
(``reference.py``). The metrics are read by the files named after them in
``metrics/`` (``read(run)``), the end-to-end ones with ``--trace 0`` and the
per-layer ones, from a ``torch.profiler`` trace of a window of at most
``TRACE_SECONDS``, with ``--trace 1``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from msm_bench import points as points_mod
from msm_bench import reference, traffic as traffic_mod
from msm_bench import roofline
from msm_bench import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "msm_tpu", "bench")
#: calls made before the window (the first loads the library and fills
#: the allocator's cache)
WARMUP_CALLS = 3
#: the program's kernels that one launch of a wrapper runs, where more
#: than one (the trace's count of the program's kernels is held to the
#: wrappers' launch counters)
KERNELS_PER_LAUNCH = {"row_offsets": 3, "point_total": 2}
#: a traced run's window is at most this long: reading its trace takes the
#: host several times as long as the window
TRACE_SECONDS = 5.0
#: traced windows run before a run gives up on a trace that dropped events
TRACE_TRIES = 3


class TraceIncomplete(RuntimeError):
    """Every traced window's trace lacked some of the program's kernels."""


def log(msg: str) -> None:
    print(f"[msm_bench] {msg}", file=sys.stderr, flush=True)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload, each read from its
    file by the name ``BENCHMARK.json`` gives."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {', '.join(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, conf, traffic


def metric_module(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    key = f"msm_bench.metrics.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, HERE / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What a run's metric readers read."""

    cell: dict
    conf: dict
    n: int  # points of one MSM
    batch: int  # MSMs a call
    setup_s: float
    calls: list  # (host start, host end) of each call in the window, seconds
    window_s: float
    peak_bytes: int  # the window's peak allocation on the fullest card
    trace: trace_mod.Summary | None = None

    @property
    def msms(self) -> int:
        return len(self.calls) * self.batch

    def t_min_s(self) -> float:
        c = self.conf["curve"]
        return roofline.msm_min(self.n, int(c["order"]).bit_length(), int(c["modulus"]).bit_length())[2]

    def device_ms_per_msm(self, claims) -> float | None:
        """Device ms a MSM of the operations ``claims`` picks (a predicate
        on ``trace.op_key``), summed over cards; None where the trace holds
        none of them."""
        if self.trace is None or not any(claims(k) for c in self.trace.cards.values() for k in c.by_op):
            return None
        return self.trace.op_s(claims) * 1e3 / self.msms


def program_config(conf: dict, n: int):
    """The program's MsmConfig for a configuration: its ``pick_config(n,
    curve)``, as a caller that passes none gets. The file's curve constants
    have to be the program's."""
    from msm_tpu_torch.params import CURVES, pick_config

    c = conf["curve"]
    spec = CURVES[c["name"]]
    for k in ("modulus", "order", "a", "b", "gx", "gy"):
        if int(c[k]) != getattr(spec, k):
            raise ValueError(f"{conf['name']}: curve {k} is not the program's {spec.name}")
    return pick_config(n, spec)


def program_system(conf: dict, traffic: dict, pts: list, devices: list):
    """The system under test: the program's plan over ``pts`` ->
    (call(sets) -> the B affine points or None, the plan)."""
    import msm_tpu_torch
    from msm_tpu_torch.models import common

    cfg = program_config(conf, len(pts))
    if conf["entry"] == "plan":
        plan = msm_tpu_torch.plan(pts, config=cfg, device=devices[0])
    elif conf["entry"] == "plan_sharded":
        plan = msm_tpu_torch.plan_sharded(pts, devices=devices, config=cfg)
    else:
        raise ValueError(f"entry {conf['entry']!r}")
    if int(traffic["batch"]) == 1:
        return (lambda sets: [plan(sets[0])]), plan
    return (lambda sets: [common.result_to_affine(j, cfg) for j in plan.run_batch(sets)]), plan


def control_system(ps: points_mod.PointSet):
    """The control in the program's place: the reference over each set
    with its scalars' lowest 16-bit word dropped (``reference.control_words``)."""
    def call(sets):
        return [reference.msm_of_words(ps.curve, reference.control_words(s), ps.a, ps.d, ps.perm) for s in sets]

    return call, None


def launches() -> int:
    """The program's kernel launches so far, by its wrappers' counters,
    times the kernels each launch runs."""
    import importlib
    import pkgutil

    import msm_tpu_torch.ops as ops

    total = 0
    for info in pkgutil.iter_modules(ops.__path__):
        if info.name.startswith("cuda_"):
            mod = importlib.import_module(f"msm_tpu_torch.ops.{info.name}")
            for name, fn in vars(mod).items():
                if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                    total += fn.launches * KERNELS_PER_LAUNCH.get(name, 1)
    return total


def card_info() -> dict:
    """The cards' names and power limits from nvidia-smi (empty where it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    rows = [r.split(",") for r in out.strip().splitlines() if "," in r]
    return {"power_limit": [r[1].strip() for r in rows]} if rows else {}


def add_breakdown(line: dict, summary: trace_mod.Summary, run: Run, entries: list, metrics: dict) -> str:
    """A traced run's ``busy_s``, ``window_s`` and ``breakdown`` (the ten
    device operations that took most time and the ten host activities the
    cards idled longest under, each a mean over the cards) into ``line``;
    returns the stderr line of device ms a MSM by layer, with ``other_ms``
    for what no reader claims."""
    k = len(summary.cards)
    line["device"]["busy_s"] = sum(c.busy_s for c in summary.cards.values()) / k
    line["device"]["window_s"] = summary.window_s
    ops: dict = {}
    for c in summary.cards.values():
        for name, s in c.by_op.items():
            ops[name] = ops.get(name, 0.0) + s / k
    line["breakdown"] = {
        "device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": [[n, s / k] for n, s in sorted(summary.idle_by_host.items(), key=lambda x: -x[1])[:10]],
    }
    layers = [m["name"] for m in entries if hasattr(metric_module(m["name"]), "claims")]
    claimed = [metric_module(name).claims for name in layers]
    other = summary.op_s(lambda op: not any(f(op) for f in claimed)) * 1e3 / run.msms
    return "device ms a MSM by layer: " + ", ".join(
        [f"{n} {metrics[n]['value']:.4f}" for n in layers if n in metrics] + [f"other_ms {other:.4f}"])


def window(call, groups, seconds: float, span) -> tuple[float, list, list]:
    """Calls in a closed loop with one caller, group after group of the
    pool, up to the first call that ends past ``seconds`` -> (start, the
    (host start, host end) of each call, its (group, points))."""
    calls, outs = [], []
    with span(trace_mod.WINDOW):
        start = time.perf_counter()
        while True:
            g = len(calls) % len(groups)
            ts = time.perf_counter()
            with span(trace_mod.CALL):
                out = call(groups[g])
            te = time.perf_counter()
            calls.append((ts, te))
            outs.append((g, out))
            if te >= start + seconds:
                return start, calls, outs


def read_trace(prof, devices: list) -> trace_mod.Summary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.summarize(trace_mod.load(path), [d.index for d in devices])
    finally:
        os.unlink(path)


def traced_window(call, groups, seconds: float, devices: list, lines: list):
    """``window`` under ``torch.profiler`` -> (start, calls, outs, Summary).
    A trace that holds another number of the program's kernels than its
    wrappers launched in the window has dropped events: the window is run
    again, up to TRACE_TRIES times, and then ``TraceIncomplete`` is raised.
    ``outs`` holds the calls of every window run, so that all are judged."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    outs = []
    for attempt in range(1, TRACE_TRIES + 1):
        launches0 = launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, calls, outs_k = window(call, groups, seconds, record_function)
            for d in devices:
                torch.cuda.synchronize(d)
            time.sleep(0.1)  # the device's last records reach a trace that stops at once late
        outs += outs_k
        summary = read_trace(prof, devices)
        ours, launched = sum(c.ours for c in summary.cards.values()), launches() - launches0
        lines.append(f"trace {attempt}: {ours} of the program's {launched} kernel launches in the window")
        if ours == launched:
            return start, calls, outs, summary
        log(lines[-1] + ": events dropped")
    raise TraceIncomplete(f"the profiler dropped kernel events in {TRACE_TRIES} traces")


def run(cell: dict, conf: dict, traffic: dict, seed: int, seconds: float, trace: bool, metric_entries: list,
        device: str = "cuda", t0: float | None = None, system: str = "program",
        cache: Path = points_mod.CACHE, warmup: int = WARMUP_CALLS) -> tuple[dict, list[str]]:
    """One run of a cell -> (the result line, its last stderr lines).
    ``device`` "cpu" runs the program's plain twins, and ``warmup`` fewer
    calls, in the tests; ``system`` "control" puts the control in the
    program's place."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cards = int(cell["chips"])
    cuda = device == "cuda"
    devices = [torch.device("cuda", i) for i in range(cards)] if cuda else [torch.device("cpu")] * cards
    if trace and not cuda:
        raise ValueError("a traced run reads the device's trace: it needs CUDA")
    batch = int(traffic["batch"])
    if int(conf["devices"]) != cards:
        raise ValueError(f"{conf['name']} runs on {conf['devices']} card(s), the cell asks for {cards}")

    ps = points_mod.PointSet.from_config(conf)
    pts_bytes = points_mod.load(ps, cache)
    pool = traffic_mod.make_pool(traffic, ps.n, ps.curve.r, seed)
    groups = [pool[i : i + batch] for i in range(0, len(pool), batch)]
    if system == "program":
        call, plan = program_system(conf, traffic, points_mod.as_tuples(ps, pts_bytes), devices)
    else:
        call, plan = control_system(ps)
    del pts_bytes
    for c in range(warmup):
        call(groups[c % len(groups)])

    if trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # its start-up, outside the window
            call(groups[0])
    setup_peak = max((torch.cuda.max_memory_allocated(d) for d in devices), default=0) if cuda else 0
    if cuda:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t0

    lines = []
    summary = None
    if trace:
        start, calls, outs, summary = traced_window(call, groups, min(seconds, TRACE_SECONDS), devices, lines)
    else:
        start, calls, outs = window(call, groups, seconds, lambda name: contextlib.nullcontext())
    window_s = calls[-1][1] - start
    window_peak = max((torch.cuda.max_memory_allocated(d) for d in devices), default=0) if cuda else 0
    del plan, call
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the program is freed: each pool group used
    expected = {g: [reference.msm_of_words(ps.curve, w, ps.a, ps.d, ps.perm)
                    for w in pool[g * batch : (g + 1) * batch]] for g in sorted({g for g, _ in outs})}
    wrong = sum(1 for g, out in outs if list(out) != expected[g])

    r = Run(cell, conf, ps.n, batch, setup_s, calls, window_s, window_peak, summary)
    entries = [m for m in metric_entries if cell["name"] in m.get("workloads", [cell["name"]])]
    metrics = {}
    for m in entries:
        value = metric_module(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cards, "memory_peak_bytes": max(setup_peak, window_peak)}
    if cuda:
        dev.update(card_info())
    line = {"correct": wrong == 0, "attempted": len(outs), "failed": wrong, "metrics": metrics, "device": dev}
    if summary is not None:
        lines.append(add_breakdown(line, summary, r, entries, metrics))
    lines.append(f"{len(calls)} calls of {batch} MSM(s) of {ps.n} points in {window_s:.3f} s; "
                 f"set-up {setup_s:.3f} s")
    line["checks"] = {"wrong_calls": {"value": wrong, "limit": 0}}
    lines.append(f"check wrong_calls: {wrong} (limit 0) of {len(outs)} calls")
    return line, lines


def main(argv: list[str] | None = None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m msm_bench", description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell, conf, traffic = cell_files(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); {have} visible: no result")
        return 2
    entries = bench["per_layer"] if args.trace else bench["end_to_end"]
    try:
        line, lines = run(cell, conf, traffic, args.seed, args.seconds, bool(args.trace), entries, t0=t0)
    except TraceIncomplete as e:
        log(f"{e}: no result")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may load were loaded: {', '.join(bad)}: no result")
        return 3
    for msg in lines:
        log(msg)
    print(json.dumps(line), flush=True)
    return 0
