#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (msm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the seven CUDA kernels
   from msm_tpu_torch/csrc and prints the build time;
2. holds every kernel against its plain PyTorch twin on the card, on the
   same inputs, at a small shape and at the shape the 2^20 MSM gives it,
   as exact integers after canonicalization (points summed in another
   order: by cross-multiplication), timing both with CUDA events (the
   kernels enqueued behind a spin kernel, so host overhead stays out);
3. drives the main path (run_gpu_msm, BN254) at n = 2^20 with every launch
   counter reset, checks that all seven kernels ran and that the result is
   bit-exact (1024 distinct base points tiled to n, scalars folded per base
   point mod r, oracle MSM over the bases); then n = 2^16 against the
   oracle MSM over all 2^16 points;
4. times the end-to-end MSM (warm, median of 3), its stages, its peak
   device memory, and, under torch.profiler, its device time by kernel and
   the device's idle share;
5. prints the kernels' JSON line, then as its last line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the last line.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 2024
REPLACES = {
    "point_add": ("csrc/point_add.cu", "msm_tpu/ops/pallas_curve.py:467"),
    "convert_pack": ("csrc/convert.cu", "msm_tpu/ops/pallas_convert.py:187"),
    "bucket_hist": ("csrc/hist.cu", "msm_tpu/ops/pallas_hist.py:83"),
    "scan_rows": ("csrc/scan.cu", "msm_tpu/ops/pallas_scan.py:374"),
    "row_offsets": ("csrc/prefix.cu", "msm_tpu/ops/pallas_prefix.py:133"),
    "point_total": ("csrc/prefix.cu", "msm_tpu/ops/pallas_prefix.py:231"),
    "horner": ("csrc/prefix.cu", "msm_tpu/ops/pallas_prefix.py:335"),
}


def _kernels():
    from msm_tpu_torch.ops import cuda_convert, cuda_curve, cuda_hist, cuda_prefix, cuda_scan

    return {
        "point_add": (cuda_curve.point_add, cuda_curve.point_add_plain),
        "convert_pack": (cuda_convert.convert_pack, cuda_convert.convert_pack_plain),
        "bucket_hist": (cuda_hist.bucket_hist, lambda cfg, keys, nb: cuda_hist.bucket_hist_plain(keys, nb)),
        "scan_rows": (cuda_scan.scan_rows, cuda_scan.scan_rows_plain),
        "row_offsets": (cuda_prefix.row_offsets, cuda_prefix.row_offsets_plain),
        "point_total": (cuda_prefix.point_total, cuda_prefix.point_total_plain),
        "horner": (cuda_prefix.horner, cuda_prefix.horner_plain),
    }


def _timed(fn):
    """(result, ms) of one call, by CUDA events around it: the plain twins'
    cost, host launch overhead included."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _kernel_ms(fn, reps: int):
    """(result, ms per call) of the device work a wrapper enqueues: CUDA
    events around ``reps`` calls that the host enqueues while a spin kernel
    holds the device, so the calls run back to back and the wrappers' host
    overhead (larger than the shortest kernels) stays out of the time. One
    warm-up call first."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device clock cycles
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _mont(vals, cfg):
    """python ints -> Montgomery-form canonical limbs [n, L] int32."""
    from msm_tpu.utils.limbs import ints_to_limbs

    p = cfg.curve.modulus
    return ints_to_limbs([v * cfg.r % p for v in vals], cfg.word_size, cfg.num_words).astype(np.int32)


def _rand_fe(rng, shape, cfg):
    """Random canonical field elements as int32 limbs [..., L] (top limb
    below the modulus' top limb, so every value is < p)."""
    L, w = cfg.num_words, cfg.word_size
    a = rng.integers(0, 1 << w, size=tuple(shape) + (L,), dtype=np.int64)
    a[..., -1] = rng.integers(0, cfg.curve.modulus >> (w * (L - 1)), size=shape)
    return a.astype(np.int32)


def _curve_points(rng, shape, cfg, base, device):
    """Real curve points in random projective form (x*z : y*z : z), drawn
    from the Montgomery affine ``base`` rows [2, m, L]; index 0 of the last
    batch axis is the identity. Sums in different orders agree only for
    points on the curve, so the reassociating kernels get these."""
    from msm_tpu_torch.ops.field import get_field_ctx

    f = get_field_ctx(cfg)
    idx = torch.from_numpy(rng.integers(0, base.shape[1], size=shape)).to(device)
    z = torch.from_numpy(_rand_fe(rng, shape, cfg)).to(device)
    z[..., 0, :] = 0
    x, y = (f.canonical(f.mont_mul(base[i][idx], z)) for i in range(2))
    y[..., 0, :] = f.const(f.r_limbs, device)
    return x, y, z


def _compare(f, got, want, as_points: bool) -> int:
    """Max abs difference of canonical limbs: of the coordinates themselves,
    or, for points, of the cross products X1 Z2 - X2 Z1 and Y1 Z2 - Y2 Z1."""
    if as_points:
        (x1, y1, z1), (x2, y2, z2) = got, want
        got = (f.mont_mul(x1, z2), f.mont_mul(y1, z2))
        want = (f.mont_mul(x2, z1), f.mont_mul(y2, z1))
    err = 0
    for g, w in zip(got, want):
        d = f.canonical(g).to(torch.int64) - f.canonical(w).to(torch.int64)
        err = max(err, int(d.abs().max()))
    return err


def check_kernels(sizes=("small", "slice"), device="cuda") -> dict:
    """Every kernel against its twin on the card; returns per-kernel
    {max_abs_err, ms, plain_ms} from the slice shape (or the last size)."""
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import BN254, MsmConfig, pick_config
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.ops.field import get_field_ctx

    dev = torch.device(device)
    rng = np.random.default_rng(SEED)
    kern = _kernels()
    out = {}
    base_cfg = MsmConfig(curve=BN254)
    aff = [Curve(BN254).to_affine(p) for p in Curve(BN254).sample_points(256, seed=SEED)]
    base = torch.stack([torch.from_numpy(_mont(v, base_cfg)) for v in zip(*aff)]).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for size in sizes:
        small = size == "small"
        cfg = MsmConfig(curve=BN254, chunk_size=8) if small else pick_config(1 << 20)
        f = get_field_ctx(cfg)
        L = cfg.num_words
        # the 2^20 MSM's shapes: c = 16, S = 16, R = 16384, C = 64, batch 4
        n = 2048 if small else 1 << 20
        R = 512 if small else 1 << 14
        C = 4 if small else n // R
        G = 1 if small else 4
        NB = cfg.num_buckets
        S = 4 if small else cfg.num_subtasks
        cases = {}
        # point add: batch of the prefix_at call; some inputs balanced (-y)
        B = 512 if small else G * NB
        pa = [_rand_fe(rng, (B,), cfg) for _ in range(6)]
        pa[1][: B // 8] *= -1
        cases["point_add"] = ([cfg, *map(t, pa)], False, 5)
        # convert: u16 words of random coordinates below p
        words = rng.integers(0, 1 << 16, size=(2, n, 16), dtype=np.int64)
        words[:, :, 15] = rng.integers(0, cfg.curve.modulus >> 240, size=(2, n))
        cases["convert_pack"] = ([cfg, t(words[0].astype(np.int32)), t(words[1].astype(np.int32))], False, 5)
        # histogram: every subtask's keys at once
        keys = rng.integers(0, NB, size=(S if not small else 2, n), dtype=np.int32)
        cases["bucket_hist"] = ([cfg, t(keys), NB], False, 5)
        # scan: a random canonical table, a random permutation, random signs
        tab = torch.cat([pack_canonical(torch.from_numpy(_rand_fe(rng, (n,), cfg)), cfg)
                         for _ in range(2)], dim=-1)
        perm = np.stack([rng.permutation(n).reshape(R, C).T for _ in range(G)]).astype(np.int32)
        flags = rng.integers(0, 2, size=perm.shape, dtype=np.int32)
        cases["scan_rows"] = ([cfg, tab.to(dev), t(perm), t(flags)], False, 3)
        rows = _curve_points(rng, (G, R), cfg, base, dev)
        cases["row_offsets"] = ([cfg, *(a.transpose(1, 2).contiguous() for a in rows)], True, 3)
        N = 512 if small else NB - 1
        cases["point_total"] = ([cfg, *_curve_points(rng, (S, N), cfg, base, dev)], True, 3)
        cases["horner"] = ([cfg, *(t(_rand_fe(rng, (S,), cfg)) for _ in range(3)),
                            4 if small else cfg.chunk_size], False, 3)
        for name, (args, as_points, reps) in cases.items():
            wrapper, plain = kern[name]
            got, ms = _kernel_ms(lambda: wrapper(*args), reps)
            want, plain_ms = _timed(lambda: plain(*args))
            if name in ("bucket_hist", "convert_pack"):  # plain integers
                err = int((got.long() - want.long()).abs().max())
            else:
                if name == "scan_rows":  # pe3 rows by coordinate; totals limbs-last
                    got, want = ([r[0][..., i * L:(i + 1) * L] for i in range(3)]
                                 + [a.transpose(1, 2) for a in r[1:]] for r in (got, want))
                err = _compare(f, got, want, as_points)
            print(f"check {name:13s} {size:5s} max_abs_err={err} kernel_ms={ms:.4f} plain_ms={plain_ms:.2f}",
                  flush=True)
            if err != 0:
                raise AssertionError(f"{name} ({size}) disagrees with its twin: max_abs_err={err}")
            out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def sample_msm(n: int, seed: int = SEED):
    """1024 distinct points tiled to n, uniform scalars (numpy seed)."""
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import BN254

    cv = Curve(BN254)
    nbase = min(n, 1024)
    base = [cv.to_affine(p) for p in cv.sample_points(nbase, seed=seed)]
    rng = np.random.default_rng(seed + 1)
    raw = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    ks = [int.from_bytes(r.tobytes(), "little") % BN254.order for r in raw]
    return base, [base[i % nbase] for i in range(n)], ks


def folded_oracle(base, ks):
    """The exact MSM of tiled points: scalars folded per base point mod r."""
    from msm_tpu.oracle import best_msm
    from msm_tpu.params import BN254

    nb = len(base)
    folded = [0] * nb
    for i, k in enumerate(ks):
        folded[i % nb] += k
    return best_msm(base, [k % BN254.order for k in folded])


def stage_times(pts, ks, device="cuda") -> dict:
    """One MSM split into its stages, each ended by a synchronize (ms)."""
    from msm_tpu.params import pick_config
    from msm_tpu_torch.models import common, cuzk
    from msm_tpu_torch.models.geometry import pick_geometry

    cfg = pick_config(len(pts))
    st = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    t0 = time.perf_counter()
    x, y, s = common.pad_inputs(pts, ks, cfg)
    t0 = mark("host_serialize", t0)
    xd, yd, sd = (torch.from_numpy(a).to(device) for a in (x, y, s))
    t0 = mark("upload", t0)
    packed = common.prepare_points(cfg, xd, yd)
    t0 = mark("convert", t0)
    ws = cuzk.window_sums_from_table(packed, sd, cfg, pick_geometry(x.shape[0], cfg.chunk_size))
    t0 = mark("window_sums", t0)
    pt = cuzk.msm_point_from_ws(ws, cfg)
    common.std_point_to_jpoint(pt.numpy(), cfg)
    mark("horner_and_host_tail", t0)
    return st


def device_breakdown(pts, ks, trace_path, device="cuda") -> tuple[float, float, dict]:
    """One MSM under torch.profiler: (wall ms, device-busy ms, device ms by
    kernel). Busy time is the union of the device's kernel and copy
    intervals; kernels of this package keep their names, PyTorch's own
    kernels (sort, gathers, elementwise) are summed as "torch_ops". A trace
    must hold every kernel launch the wrappers counted (the profiler has been
    seen to drop device events); an incomplete one is taken again, at most
    three times."""
    import msm_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    kern = _kernels()
    for _ in range(3):
        for wrapper, _plain in kern.values():
            wrapper.launches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            msm_tpu_torch.run_gpu_msm(pts, ks, device=device)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        busy_ms, by_name, n_ours = trace_breakdown(json.loads(trace_path.read_text())["traceEvents"])
        # point_total is two kernels per launch, every other wrapper one
        expected = sum(w.launches for w, _plain in kern.values()) + kern["point_total"][0].launches
        if n_ours == expected:
            return wall_ms, busy_ms, by_name
        print(f"profiled MSM: trace holds {n_ours} of {expected} kernel launches; again", flush=True)
    raise RuntimeError("the profiler dropped kernel events in three traces")


def trace_breakdown(events) -> tuple[float, dict, int]:
    """(device-busy ms, device ms by kernel, number of this package's kernel
    events) of a chrome trace's events."""
    by_name: dict[str, float] = {}
    spans = []
    n_ours = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e["name"]
        n_ours += name.startswith("k_")
        key = (name.split("(")[0] if name.startswith("k_")
               else "memcpy" if e["cat"] != "kernel" else "torch_ops")
        by_name[key] = by_name.get(key, 0.0) + e["dur"] / 1e3
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3, by_name, n_ours


def edge_checks(device="cuda") -> None:
    """Small MSMs through the kernels: n = 35 (padded to 64) with repeated
    points and scalars at the recode edges and out of range, an identity
    result, and the empty MSM."""
    import msm_tpu_torch
    from msm_tpu.oracle import best_msm
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import BN254

    cv, r = Curve(BN254), BN254.order
    base = [cv.to_affine(p) for p in cv.sample_points(12, seed=SEED)]
    pts = [base[i % 12] for i in range(35)]
    ks = [0, 1, r - 1, r, r + 5, 2 * r - 1, (1 << 256) - 1, -3] + list(range(10**6, 10**6 + 27))
    got = msm_tpu_torch.run_gpu_msm(pts, ks, device=device)
    if got != cv.to_affine(best_msm(pts, [k % r for k in ks])):
        raise AssertionError(f"edge-scalar MSM differs from the oracle: {got}")
    if msm_tpu_torch.run_gpu_msm([base[0], base[0], base[1]], [5, r - 5, 0], device=device) is not None:
        raise AssertionError("k P + (r - k) P should be the identity")
    if msm_tpu_torch.run_gpu_msm([], [], device=device) is not None:
        raise AssertionError("empty MSM should be the identity")
    print("edge MSMs (n = 35 edge scalars, identity result, n = 0): bit-exact", flush=True)


def run_msm_checks(log_sizes=(20, 16), device="cuda") -> dict:
    """Main path at 2^20 with counters, 2^16 against the full oracle, and
    end-to-end timings. Returns the launch counts of the 2^20 run."""
    import msm_tpu_torch
    from msm_tpu.oracle import best_msm
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import BN254, pick_config
    from msm_tpu_torch.ops._build import BUILD_ROOT

    cv = Curve(BN254)
    kern = _kernels()
    results = {}
    for logn in log_sizes:
        n = 1 << logn
        t0 = time.perf_counter()
        base, pts, ks = sample_msm(n)
        # 2^20: the folded oracle over the bases; smaller: the oracle MSM over
        # every point
        want = folded_oracle(base, ks) if n > 1 << 16 else best_msm(pts, ks)
        cfg = pick_config(n)
        print(f"msm 2^{logn}: inputs + oracle {time.perf_counter() - t0:.1f} s "
              f"(c={cfg.chunk_size} S={cfg.num_subtasks})", flush=True)
        for wrapper, _ in kern.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        got = msm_tpu_torch.run_gpu_msm(pts, ks, device=device)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = {name: w.launches for name, (w, _) in kern.items()}
        print(f"msm 2^{logn}: launches {json.dumps(counts)} first call {first:.3f} s", flush=True)
        if want.is_identity() or got is None or cv.to_affine(want) != tuple(got):
            raise AssertionError(f"2^{logn} MSM differs from the oracle: {got}")
        missing = [k for k, v in counts.items() if v <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: {missing}")
        if logn == log_sizes[0]:
            results["launches"] = counts
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            again = msm_tpu_torch.run_gpu_msm(pts, ks, device=device)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if again != got:
                raise AssertionError("repeat MSM differs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        st = stage_times(pts, ks, device)
        print(f"msm 2^{logn}: bit-exact; wall_s median of 3 = {statistics.median(walls):.4f} "
              f"(runs {', '.join(f'{w:.4f}' for w in walls)}); peak_mem_gib={peak_gib:.3f}; "
              "stages_ms " + ", ".join(f"{k}={v:.1f}" for k, v in st.items()), flush=True)
        wall_ms, busy_ms, by_name = device_breakdown(
            pts, ks, BUILD_ROOT / f"trace_2e{logn}.json", device)
        print(f"msm 2^{logn}: profiled wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
              f"idle_share={1 - busy_ms / wall_ms:.3f}; device_ms "
              + ", ".join(f"{k}={v:.2f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])),
              flush=True)
    return results


def build_cpp_oracle() -> str:
    """Build the C++ oracle (msm_tpu/oracle/cpp) with the g++ on PATH before
    its first use: its Makefile takes $CXX, which may name a compiler that
    lacks OpenMP. Where the build fails, the reference MSMs run on the pure
    Python oracle, which is exact as well. Returns the oracle in use."""
    from msm_tpu.oracle import native

    cpp = Path(native.__file__).parent / "cpp"
    if not (cpp / "libmsm_oracle.so").exists():
        r = subprocess.run(
            ["make", "-s", "-B", "-C", str(cpp), f"CXX={shutil.which('g++') or 'g++'}"],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            print(f"C++ oracle build failed: {r.stderr.strip()[-400:]}", flush=True)
    return "C++" if native.native_available() else "python"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from msm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so}", flush=True)
    for line in (so.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    print(f"oracle: {build_cpp_oracle()}", flush=True)
    checks = check_kernels()
    edge_checks()
    launches = run_msm_checks()["launches"]
    rows = []
    for name, (src, rep) in REPLACES.items():
        c = checks[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"msm_tpu_torch/{src}",
            "replaces": rep, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
