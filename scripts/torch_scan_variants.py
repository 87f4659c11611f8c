#!/usr/bin/env python3
"""Launch-plan and prefetch variants of kernel 4, the scan
(``msm_tpu_torch/csrc/scan.cu`` + ``scan.cuh``), timed against each other
on one GPU at the scan shapes of the plain 2^20 MSM (G = 4, C = 64,
R = 16384) and the plain 2^16 MSM (G = 4, C = 8, R = 8192).

    python3 scripts/torch_scan_variants.py [--rounds 3]

Each variant is the scan's source with one edit, compiled on its own (all
at once) into ``build/scan_variants/<name>/``, and loaded with ctypes:

- ``base``: the source as it is;
- ``ahead1``: loads the next step's index, flag and packed row before the
  current step's mixed addition (a one-step prefetch);
- ``lb2``, ``lb3``: 128-thread blocks capped at 2 or 3 blocks per SM in
  place of 4 (more registers, fewer warps);
- ``b256``, ``b64``: 256- and 64-thread blocks at the same 128-register
  cap (2 and 8 blocks per SM);
- ``b256_ahead1``: both.

Prints the card, each variant's ptxas report (registers, stack, spills),
then per round, shape and variant the ms per launch (CUDA events over
back-to-back launches queued behind a spin kernel, as ``chip_smoke.py``
times kernels), the variants in a rotated order each round, and last the
median of each over the rounds beside base's. The scan wrapper is first
held exactly against its plain twin at both shapes, and every variant's
outputs must equal the wrapper's bit for bit. Needs the CUDA toolkit and
one GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from msm_tpu_torch.ops import _build  # noqa: E402

OUT = _build.BUILD_ROOT.parent / "scan_variants"

LOOP = """  int64_t e = g * C * R + r;
  for (int c = 0; c < C; ++c, e += R) {
    fe32 x2, y2;
    scan_load_row(x2, y2, packed, perm[e]);
    fe32_cond_neg(y2, flags[e] & 1);
"""
AHEAD1 = """  int64_t e = g * C * R + r;
  fe32 nx, ny;
  int nf = 0;
  if (C > 0) {
    scan_load_row(nx, ny, packed, perm[e]);
    nf = flags[e];
  }
  for (int c = 0; c < C; ++c, e += R) {
    fe32 x2 = nx, y2 = ny;
    const int f = nf;
    if (c + 1 < C) {
      scan_load_row(nx, ny, packed, perm[e + R]);
      nf = flags[e + R];
    }
    fe32_cond_neg(y2, f & 1);
"""
THREADS = "constexpr int THREADS = 128;"
BOUNDS = "__launch_bounds__(THREADS, 4)"


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the scan source no longer holds {old!r}; update the variants")
    return text.replace(old, new)


def _plan(cu: str, threads: int, blocks: int) -> str:
    cu = _edit(cu, THREADS, f"constexpr int THREADS = {threads};")
    return _edit(cu, BOUNDS, f"__launch_bounds__(THREADS, {blocks})")


def variants() -> dict[str, tuple[str, str]]:
    """name -> (scan.cu, scan.cuh) texts."""
    cu = (_build.CSRC / "scan.cu").read_text()
    cuh = (_build.CSRC / "scan.cuh").read_text()
    ahead = _edit(cuh, LOOP, AHEAD1)
    return {
        "base": (cu, cuh),
        "ahead1": (cu, ahead),
        "lb2": (_plan(cu, 128, 2), cuh),
        "lb3": (_plan(cu, 128, 3), cuh),
        "b256": (_plan(cu, 256, 2), cuh),
        "b64": (_plan(cu, 64, 8), cuh),
        "b256_ahead1": (_plan(cu, 256, 2), ahead),
    }


def build_all(nvcc: str) -> dict:
    """Compile every variant at once; returns name -> msm_scan function."""
    procs = {}
    for name, (cu, cuh) in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "scan.cu").write_text(cu)
        (d / "scan.cuh").write_text(cuh)  # shadows csrc/scan.cuh for this file
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(d / "lib.so"),
             str(d / "scan.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if re.search(r"registers|spill|stack frame", line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).msm_scan
        fn.argtypes = _build.SIGNATURES["msm_scan"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def scan_case(rng, n_log2: int):
    """(cfg, packed table, perm, flags) of the plain 2^n MSM's scan launch,
    on the card: random canonical rows, a random permutation, random signs."""
    from msm_tpu_torch.ops.cuda_convert import pack_canonical
    from msm_tpu_torch.params import pick_config

    cfg = pick_config(1 << n_log2)
    G, C, R = (4, 64, 16384) if n_log2 == 20 else (4, 8, 8192)
    n = C * R
    tab = torch.cat([pack_canonical(torch.from_numpy(cs._rand_fe(rng, (n,), cfg)), cfg)
                     for _ in range(2)], dim=-1).cuda()
    perm = np.stack([rng.permutation(n).reshape(R, C).T for _ in range(G)]).astype(np.int32)
    flags = rng.integers(0, 2, size=perm.shape, dtype=np.int32)
    return [cfg, tab, *(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (perm, flags))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.split()[0])
    _build.load()
    fns = build_all(_build.find_nvcc())
    kern = cs._kernels()
    rng = np.random.default_rng(cs.SEED)
    from msm_tpu_torch.ops.field import get_field_ctx

    cases = {}
    for n_log2, reps in ((20, 5), (16, 20)):
        a = scan_case(rng, n_log2)
        cfg = a[0]
        cs._check_case(kern, get_field_ctx(cfg), cfg.num_words, "scan_rows", f"2^{n_log2}", a,
                       False, 3, clock_hz)
        want = kern["scan_rows"][0](*a)
        cases[n_log2] = (a, want, reps)
    times: dict[tuple[int, str], list[float]] = {}
    names = list(fns)
    for rnd in range(args.rounds):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for n_log2, (a, want, reps) in cases.items():
            cfg, tab, perm, flags = a
            G, C, R = perm.shape
            out = [torch.empty_like(w) for w in want]
            for name in order:
                fn = fns[name]

                def run():
                    err = fn(tab.data_ptr(), perm.data_ptr(), flags.data_ptr(),
                             *(o.data_ptr() for o in out), G, C, R,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")

                for o in out:
                    o.zero_()
                _, ms = cs._kernel_ms(run, reps)
                if not all(torch.equal(o, w) for o, w in zip(out, want)):
                    raise AssertionError(f"variant {name} differs from the scan at 2^{n_log2}")
                times.setdefault((n_log2, name), []).append(ms)
                print(f"round {rnd} 2^{n_log2} {name}: {ms:.4f} ms", flush=True)
    for n_log2 in cases:
        base = statistics.median(times[(n_log2, "base")])
        for name in names:
            med = statistics.median(times[(n_log2, name)])
            print(f"median 2^{n_log2} {name:12s} {med:.4f} ms  ({med / base:.3f} x base)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
