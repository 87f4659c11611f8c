"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read: each card's busy time, kernel time and device time by
operation, and the idle gaps named by what the host was doing.

Busy time is the union of a card's kernel, copy and fill intervals within
the traced window; kernel time the union of its kernels alone. Kernels of
the program keep their names without their field (``k_scan`` for ``void
msm::k_scan<msm::FpBn254>(...)``); another library's kernel is named by its
function (``at::native::...``), and copies by their direction (``memcpy
HtoD``). The grouping is that of the program's ``chip_smoke.py``
(``device_breakdown``, ``trace_breakdown``, ``_our_kernel``), copied here so
that the yardstick does not change with the program, and so is its guard:
the profiler has been seen to drop kernel events on a loaded host, so the
harness holds ``Card.ours`` to the program's launch counters and reads the
window again where they differ.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
#: the harness's own spans (``record_function``)
WINDOW, CALL = "msm_bench.window", "msm_bench.call"


def our_kernel(name: str) -> str | None:
    """The program's kernel named by a trace event, without its field, or
    None for another library's."""
    m = re.match(r"(?:void )?(?:msm::)?(k_\w+)", name)
    return m.group(1) if m else None


def op_key(e: dict) -> str:
    """The name a device event is counted under."""
    name = e["name"]
    if e["cat"] == "gpu_memcpy":
        m = re.search(r"(HtoD|DtoH|DtoD|HtoH|PtoP)", name)
        return f"memcpy {m.group(1) if m else name}"
    if e["cat"] == "gpu_memset":
        return "memset"
    ours = our_kernel(name)
    if ours:
        return ours
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def _union(spans: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


@dataclass
class Card:
    """One card's device time within the window (seconds)."""

    busy_s: float = 0.0
    kernel_s: float = 0.0
    by_op: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)  # (start_us, end_us)
    ours: int = 0  # the program's kernel events in the window


@dataclass
class Summary:
    window_s: float
    cards: dict  # device index -> Card
    idle_by_host: dict  # host activity -> idle seconds, summed over cards

    def op_s(self, keys) -> float:
        """Device seconds of the operations ``keys`` (a predicate on the
        op key), summed over cards."""
        return sum(s for c in self.cards.values() for k, s in c.by_op.items() if keys(k))


def summarize(events: list[dict], devices: list[int]) -> Summary:
    """The trace's events -> a Summary over the harness's window span, for
    the cards ``devices``."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        raise ValueError("the trace holds no window span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans: dict = defaultdict(list)
    kspans: dict = defaultdict(list)
    cards = {d: Card() for d in devices}
    # a device event whose launch (the runtime call of its correlation id)
    # lies in the window belongs to it whole, also where a loaded host has
    # stamped it before the window's start; any other counts as far as it
    # overlaps the window
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and w0 <= e.get("ts", w0 - 1) <= w1
                and "correlation" in e.get("args", {})}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dev = int(e.get("args", {}).get("device", e.get("pid", -1)))
        if dev not in cards:
            continue
        inside = e.get("args", {}).get("correlation") in launched
        lo, hi = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if hi <= lo and not inside:
            continue
        c = cards[dev]
        key = op_key(e)
        c.by_op[key] = c.by_op.get(key, 0.0) + (e["dur"] if inside else hi - lo) / 1e6
        c.ours += our_kernel(e["name"]) is not None
        if hi > lo:
            spans[dev].append((lo, hi))
            if e["cat"] == "kernel":
                kspans[dev].append((lo, hi))
    for dev, c in cards.items():
        c.busy_s = _union(spans[dev]) / 1e6
        c.kernel_s = _union(kspans[dev]) / 1e6
        end = w0
        for lo, hi in sorted(spans[dev]):
            if lo > end:
                c.gaps.append((end, lo))
            end = max(end, hi)
        if end < w1:
            c.gaps.append((end, w1))
    tid = win[0].get("tid")
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == tid
                  and e["name"] not in (WINDOW, CALL) and w0 <= e["ts"] <= w1)
    calls = sorted((e["ts"], e["ts"] + e["dur"], CALL) for e in events if e.get("name") == CALL and e.get("ph") == "X")
    idle: dict = defaultdict(float)
    for c in cards.values():
        for lo, hi in c.gaps:
            idle[host_at(host, calls, (lo + hi) / 2)] += (hi - lo) / 1e6
    return Summary((w1 - w0) / 1e6, cards, dict(idle))


def host_at(host: list, calls: list, t: float) -> str:
    """What the host was doing at time ``t``: the innermost of its spans
    (sorted by start) that holds ``t``, the shortest of those among the
    last 4096 to start before it; else "host Python in a call" within a
    call span, else "between calls"."""
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    best = None
    for lo, hi, name in reversed(host[max(0, i - 4096) : i]):
        if hi >= t and (best is None or hi - lo < best[1] - best[0]):
            best = (lo, hi, name)
    if best is not None:
        return best[2]
    j = bisect.bisect_right(calls, (t, float("inf"), ""))
    return "host Python in a call" if j and calls[j - 1][1] >= t else "between calls"


def load(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]
