"""The metrics' arithmetic on fixed records, the roofline's figures, and
the trace reduction on a synthetic trace."""

import pytest

from msm_bench import core, roofline, trace
from helpers import tiny_conf


def record(calls, batch=1, n=1 << 20, summary=None, conf="bn254_groth16_2p20", peak=3 << 30):
    c = tiny_conf(conf)
    return core.Run({"name": "x"}, c, n, batch, 12.5, calls, calls[-1][1] - calls[0][0], peak, summary)


def read(name, run):
    return core.metric_module(name).read(run)


def test_points_per_s_counts_every_msm_over_the_whole_window():
    calls = [(10.0 + 0.03 * i, 10.0 + 0.03 * i + 0.028) for i in range(100)]
    r = record(calls, batch=4)
    assert r.window_s == pytest.approx(2.998)
    assert read("points_per_s", r) == pytest.approx((1 << 20) * 400 / 2.998)
    assert read("setup_s", r) == 12.5
    assert read("device_peak_gib", r) == 3.0


def test_call_ms_p95_is_the_tail_of_all_calls():
    calls, t = [], 0.0
    for i in range(100):
        ms = 100.0 if i % 16 == 7 else 20.0 + i * 0.01  # six slow calls of 100
        calls.append((t, t + ms / 1e3))
        t += ms / 1e3
    assert read("call_ms_p95", record(calls)) == pytest.approx(100.0)
    calls = [(i, i + (i + 1) / 1e3) for i in range(20)]  # 1..20 ms
    assert read("call_ms_p95", record(calls)) == pytest.approx(19.05)


@pytest.mark.parametrize("log_n,conf,ops,t_ms", [
    (20, "bn254_groth16_2p20", 5.64e9, 0.337),
    (22, "bls12_377_zprize_2p22", 4.35e10, 2.600),
    (24, "bn254_groth16_2p24_4card", 7.73e10, 4.622),
])
def test_t_min_figures(log_n, conf, ops, t_ms):
    c = tiny_conf(conf)["curve"]
    got_ops, nbytes, t = roofline.msm_min(1 << log_n, int(c["order"]).bit_length(), int(c["modulus"]).bit_length())
    assert got_ops == pytest.approx(ops, rel=2e-3) and t * 1e3 == pytest.approx(t_ms, abs=6e-4)
    assert t == got_ops / roofline.IMAD_PER_S > nbytes / roofline.HBM_BYTES_PER_S


def synthetic():
    """A 10 ms window on cards 0 and 1: on card 0 a copy (0-1 ms) and
    kernels at 0.5-3 ms, 5-6 ms; on card 1 one kernel at 2-4 ms."""
    ev = [{"ph": "X", "name": trace.WINDOW, "cat": "user_annotation", "ts": 1000, "dur": 10000, "tid": 7},
          {"ph": "X", "name": trace.CALL, "cat": "user_annotation", "ts": 1000, "dur": 9000, "tid": 7},
          {"ph": "X", "name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 4000, "dur": 900, "tid": 7},
          {"ph": "X", "name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy", "ts": 1000, "dur": 1000,
           "args": {"device": 0}},
          {"ph": "X", "name": "void msm::k_scan<msm::FpBn254>(int const*)", "cat": "kernel", "ts": 1500,
           "dur": 2500, "args": {"device": 0}},
          {"ph": "X", "name": "void at::native::vectorized_elementwise_kernel<4, X>(int)", "cat": "kernel",
           "ts": 6000, "dur": 1000, "args": {"device": 0}},
          {"ph": "X", "name": "k_horner(int*)", "cat": "kernel", "ts": 3000, "dur": 2000, "args": {"device": 1}}]
    return trace.summarize(ev, [0, 1])


def test_trace_summary():
    s = synthetic()
    c0, c1 = s.cards[0], s.cards[1]
    assert s.window_s == pytest.approx(0.010)
    assert c0.busy_s == pytest.approx(0.004) and c0.kernel_s == pytest.approx(0.0035)
    assert c0.by_op == pytest.approx({"memcpy HtoD": 0.001, "k_scan": 0.0025,
                                      "at::native::vectorized_elementwise_kernel": 0.001})
    assert c1.busy_s == pytest.approx(0.002) and c0.ours == 1 and c1.ours == 1
    assert c0.gaps == [(4000, 6000), (7000, 11000)]
    # card 0's gap at 4-6 ms (midpoint 5 ms) falls after the synchronize:
    # host Python in the call; 7-11 ms: in the call to 10 ms, then
    # between calls; card 1: 1-3 ms and 5-11 ms
    assert sum(s.idle_by_host.values()) == pytest.approx(0.006 + 0.008)
    assert set(s.idle_by_host) <= {"host Python in a call", "between calls", "cudaStreamSynchronize"}


def test_layer_metrics_read_the_trace():
    s = synthetic()
    r = record([(0.0, 0.005), (0.005, 0.010)], summary=s, n=1 << 20)
    assert read("upload_ms", r) == pytest.approx(1.0 / 2)
    assert read("stage12_ms", r) == pytest.approx(1.0 / 2)
    assert read("stage3_ms", r) == pytest.approx(2.5 / 2)
    assert read("stage4_ms", r) == pytest.approx(2.0 / 2)
    assert read("idle_share", r) == pytest.approx(1 - (0.4 + 0.2) / 2)
    assert read("shard_idle_share_max", r) == pytest.approx(0.8)
    t_min = roofline.msm_min(1 << 20, 254, 254)[2]
    assert read("msm_roofline", r) == pytest.approx(100 * t_min * 2 / 0.0055)


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = record([(0.0, 0.005)], summary=None)
    for name in ("upload_ms", "stage3_ms", "idle_share", "shard_idle_share_max", "msm_roofline"):
        assert read(name, r) is None


def test_breakdown_of_a_traced_line():
    s = synthetic()
    r = record([(0.0, 0.005), (0.005, 0.010)], summary=s)
    entries = [m for m in core.load_bench()["per_layer"] if m["name"] in ("upload_ms", "stage3_ms", "idle_share")]
    metrics = {m["name"]: {"value": read(m["name"], r), "unit": m["unit"]} for m in entries}
    line = {"device": {}}
    msg = core.add_breakdown(line, s, r, entries, metrics)
    assert line["device"] == {"busy_s": pytest.approx(0.003), "window_s": pytest.approx(0.010)}
    assert line["breakdown"]["device_ops"][0] == ["k_scan", pytest.approx(0.00125)]
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert msg.endswith("other_ms " + f"{(1.0 + 2.0) / 2:.4f}")  # the elementwise and Horner kernels


def test_a_kernel_launched_in_the_window_counts_whole():
    """A kernel that a loaded host stamped before the window's start but
    launched (its correlation id's runtime call) inside it belongs to the
    window; one launched before it does not."""
    ev = [{"ph": "X", "name": trace.WINDOW, "cat": "user_annotation", "ts": 1000, "dur": 10000, "tid": 7},
          {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 1100, "dur": 10, "tid": 7,
           "args": {"correlation": 5}},
          {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 500, "dur": 10, "tid": 7,
           "args": {"correlation": 6}},
          {"ph": "X", "name": "k_scan(int*)", "cat": "kernel", "ts": 700, "dur": 200,
           "args": {"device": 0, "correlation": 5}},
          {"ph": "X", "name": "k_hist(int*)", "cat": "kernel", "ts": 600, "dur": 200,
           "args": {"device": 0, "correlation": 6}}]
    c = trace.summarize(ev, [0]).cards[0]
    assert c.ours == 1 and c.by_op == pytest.approx({"k_scan": 0.0002})
    assert c.busy_s == 0 and c.gaps == [(1000, 11000)]


def fake_traces(monkeypatch, found):
    """traced_window over stand-ins: each window launches 10 kernels, and
    its trace holds ``found[i]`` of them."""
    import contextlib

    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext())
    launched = {"n": 0}

    def launches():
        return launched["n"]

    def window(call, groups, seconds, span):
        launched["n"] += 10
        return 0.0, [(0.0, seconds)], [(0, ["point"])]

    seen = iter(found)
    monkeypatch.setattr(core, "launches", launches)
    monkeypatch.setattr(core, "window", window)
    monkeypatch.setattr(core, "read_trace",
                        lambda prof, devices: trace.Summary(1.0, {0: trace.Card(ours=next(seen))}, {}))


def test_a_trace_that_dropped_kernels_is_read_again(monkeypatch):
    fake_traces(monkeypatch, [9, 10])
    lines = []
    _, calls, outs, summary = core.traced_window(None, [], 1.0, [], lines)
    assert summary.cards[0].ours == 10 and len(calls) == 1
    assert len(outs) == 2  # the calls of both windows are judged
    assert lines == ["trace 1: 9 of the program's 10 kernel launches in the window",
                     "trace 2: 10 of the program's 10 kernel launches in the window"]


def test_three_traces_that_dropped_kernels_give_no_result(monkeypatch):
    fake_traces(monkeypatch, [9, 11, 9])
    with pytest.raises(core.TraceIncomplete):
        core.traced_window(None, [], 1.0, [], [])
