#!/usr/bin/env python3
"""Sweep of the pair-compressed path's geometry on one GPU: lanes R and
subtasks per launch, ranked by the compressed MSM's stage-3 device time.

    python3 scripts/torch_compress_geometry.py [--sizes 16 20]
        [--rows 1024 2048 4096 8192 16384] [--batches 4 8 16]

For each size n (BN254, ``MsmConfig(compress=True)``: c = 16, S = 16
windows; 1024 distinct points tiled to n and uniform scalars, as
``chip_smoke.sample_msm`` makes them) the point table and the signed digits
are made once. Then, per setting (R, batch) with C = n / R even and >= 2,
the stage-3 call of ``models/cuzk.window_sums_from_table``
(``scan.bucket_boundary_prefix`` over all 16 windows, ``batch`` at a time)
runs once to warm up and once under torch.profiler. Its stage-3 device
time is the sum over every launch of one MSM of the suffix products
(kernel 12), the Fermat inversion (9), the fused emission + scan (13), the
row offsets (5) and the two point adds of each batch's readout (1); the
sort and the histogram do not depend on the setting and are left out. The
call's peak device memory (table and digits included) is printed beside
it. Every setting's window sums must equal, as points, those of the plain
scan (kernel 4) on the same digits, or the script raises.

Prints the card, one line per setting and, per size, the settings ranked by
stage-3 time. Needs one GPU and the CUDA toolkit (the kernels are built as
``chip_smoke.py`` builds them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from msm_tpu_torch.models import common  # noqa: E402
from msm_tpu_torch.models.geometry import pick_geometry  # noqa: E402
from msm_tpu_torch.ops import _build, scan  # noqa: E402
from msm_tpu_torch.ops.curve import get_curve_ctx  # noqa: E402
from msm_tpu_torch.ops.decompose import decompose_signed  # noqa: E402
from msm_tpu_torch.params import BN254, MsmConfig  # noqa: E402


def profiled(fn, trace_path: Path) -> tuple[dict, int]:
    """(device ms by kernel row, launches by wrapper) of one call of fn
    under torch.profiler; a trace that misses a launch the wrappers counted
    is taken again, at most three times."""
    from torch.profiler import ProfilerActivity, profile

    kern = cs._kernels()
    for _ in range(3):
        cs._reset_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(0.1)
        prof.export_chrome_trace(str(trace_path))
        _, by_name, n_ours = cs.trace_breakdown(json.loads(trace_path.read_text())["traceEvents"])
        counts = {name: w.launches for name, (w, _plain) in kern.items()}
        expected = sum(n * len(cs.TRACE_KERNELS.get(name, (name,))) for name, n in counts.items())
        if n_ours == expected:
            return by_name, counts
        print(f"trace holds {n_ours} of {expected} kernel launches; again", flush=True)
    raise RuntimeError("the profiler dropped kernel events in three traces")


def sweep(logn: int, rows: list[int], batches: list[int]) -> list[dict]:
    n = 1 << logn
    cfg = MsmConfig(curve=BN254, compress=True)
    plain = dataclasses.replace(cfg, compress=False)
    _, pts, ks = cs.sample_msm(n)
    x, y, s = common.pad_inputs(pts, ks, cfg)
    xd, yd, sd = (torch.from_numpy(a).cuda() for a in (x, y, s))
    packed = common.prepare_points(cfg, xd, yd)
    keys, signs = decompose_signed(sd, cfg.chunk_size, cfg.num_subtasks)
    S, NB = cfg.num_subtasks, cfg.num_buckets
    # the reference: the plain scan's window sums on the same digits
    pgeo = pick_geometry(n, plain)
    ref = scan.window_sum_from_pe(get_curve_ctx(plain), scan.bucket_boundary_prefix(
        get_curve_ctx(plain), packed, keys, signs, NB, pgeo.num_rows, pgeo.subtask_batch))
    ec = get_curve_ctx(cfg)
    rule = pick_geometry(n, cfg)
    results = []
    for R in rows:
        C = n // R
        if C < 2 or C % 2:
            continue
        for batch in batches:
            G = min(batch, S)

            def stage3():
                return scan.bucket_boundary_prefix(ec, packed, keys, signs, NB, R, G)

            pe = stage3()  # warm-up, and the check
            err = cs._compare(ec.f, tuple(scan.window_sum_from_pe(ec, pe)), tuple(ref), as_points=True)
            if err:
                raise AssertionError(f"2^{logn} R={R} batch={G}: window sums differ from the plain scan's")
            del pe
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            by_name, counts = profiled(stage3, _build.BUILD_ROOT / f"trace_geometry_2e{logn}.json")
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms = {k: by_name.get(k, 0.0) for k in cs.STAGE3_COMPRESSED}
            row = {"logn": logn, "R": R, "C": C, "batch": G, "stage3_ms": sum(ms.values()),
                   "peak_gib": peak, "emit_scan_launches": counts["emit_scan"], "ms": ms,
                   "rule": (R, G) == (rule.num_rows, min(rule.subtask_batch, S))}
            results.append(row)
            print(f"2^{logn} R={R:5d} C={C:4d} batch={G:2d}: stage3_ms={row['stage3_ms']:.3f} "
                  f"peak_gib={peak:.3f} emit_scan_launches={counts['emit_scan']}; "
                  + ", ".join(f"{k}={v:.3f}" for k, v in ms.items())
                  + (" (the rule)" if row["rule"] else ""), flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[16, 20])
    ap.add_argument("--rows", type=int, nargs="+", default=[1024, 2048, 4096, 8192, 16384])
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 8, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sweep times kernels on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _build.load()
    for logn in args.sizes:
        results = sweep(logn, args.rows, args.batches)
        ranked = sorted(results, key=lambda r: r["stage3_ms"])
        print(f"2^{logn} ranked by stage-3 device ms: " + "; ".join(
            f"R={r['R']} batch={r['batch']} {r['stage3_ms']:.3f}" for r in ranked), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
