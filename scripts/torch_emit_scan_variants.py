#!/usr/bin/env python3
"""Launch-plan and prefetch variants of kernel 13, the fused pair emission +
scan (``k_emit_scan`` in ``msm_tpu_torch/csrc/compress.cu`` +
``emit_scan.cuh``), timed against each other on one GPU on the compressed
MSM's own streams at 2^20 and 2^16 (models/geometry.py's rule).

    python3 scripts/torch_emit_scan_variants.py [--rounds 3]

Each variant is the source with one edit, compiled on its own (all at
once) into ``build/emit_scan_variants/<name>/``, and loaded with ctypes:

- ``base``: the source as it is;
- ``pf``: before pair j's loads, the next pair's two table rows are
  prefetched into L1 (``prefetch.global.L1``: no registers held);
- ``ahead1``: the next pair's rows and flags are loaded into registers a
  pair ahead;
- ``lb3``, ``lb2``: 128-thread blocks capped at 3 or 2 blocks per SM in
  place of 4 (more registers, fewer warps);
- ``b64``: 64-thread blocks at the same 128-register cap (8 per SM);
- ``lb3_pf``: both.

The streams are the real ones: 1024 distinct points tiled to n with
uniform scalars (``chip_smoke.sample_msm``), converted, decomposed and
sorted as ``ops/scan`` does, the first batch of subtasks laid out
step-major over the rule's R lanes, its suffix products and Fermat inverses
from kernels 12 and 9. The wrapper is first held exactly against its plain
twin at both shapes; every variant's outputs must equal the wrapper's bit
for bit. Prints the card, each variant's ptxas report, per round, shape
and variant the ms per launch (CUDA events over back-to-back launches
queued behind a spin kernel, the variants in a rotated order each round),
and last the median of each beside base's. Needs the CUDA toolkit and one
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from msm_tpu_torch.models import common  # noqa: E402
from msm_tpu_torch.models.geometry import pick_geometry  # noqa: E402
from msm_tpu_torch.ops import _build, scan  # noqa: E402
from msm_tpu_torch.ops.cuda_compress import emit_scan, pair_suffix  # noqa: E402
from msm_tpu_torch.ops.cuda_inv import mont_pow  # noqa: E402
from msm_tpu_torch.ops.decompose import decompose_signed  # noqa: E402
from msm_tpu_torch.ops.field import get_field_ctx  # noqa: E402
from msm_tpu_torch.params import BN254, MsmConfig  # noqa: E402

OUT = _build.BUILD_ROOT.parent / "emit_scan_variants"

LOAD = """    pair32 pr;
    pair32_load(pr, packed, perm, flags, e, e + R);
"""
PREFETCH = """#ifdef __CUDA_ARCH__
    if (j + 1 < Cp) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(packed + (int64_t)perm[e + 2 * R] * 2 * NW));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(packed + (int64_t)perm[e + 3 * R] * 2 * NW));
    }
#endif
"""
AHEAD_START = """  int32_t* row = pe3 + (g * Cp * (int64_t)R + r) * 3 * L;
"""
AHEAD_ROWS = """  fe32 nx1, ny1, nx2, ny2;  // the next pair's rows, loaded a pair ahead
  int nf1, nf2;
  scan_load_row(nx1, ny1, packed, perm[e]);
  scan_load_row(nx2, ny2, packed, perm[e + R]);
  nf1 = flags[e];
  nf2 = flags[e + R];
"""
AHEAD_LOAD = """    pair32 pr;
    {
      const int s1 = nf1 & 1, s2 = nf2 & 1;
      pr.x1 = nx1; pr.y1 = ny1; pr.x2 = nx2; pr.y2 = ny2;
      if (j + 1 < Cp) {
        scan_load_row(nx1, ny1, packed, perm[e + 2 * R]);
        scan_load_row(nx2, ny2, packed, perm[e + 3 * R]);
        nf1 = flags[e + 2 * R];
        nf2 = flags[e + 3 * R];
      }
      const bool same_x = fe32_eq(pr.x1, pr.x2);
      const bool same_y = fe32_eq(pr.y1, pr.y2);
      const bool ysum_p = fe32_sum_is_p(pr.y1, pr.y2);
      pr.dbl = same_x && (s1 == s2 ? same_y : ysum_p);
      pr.inf = same_x && (s1 == s2 ? ysum_p : same_y);
      fe32_cond_neg(pr.y1, s1);
      fe32_cond_neg(pr.y2, s2);
    }
"""
THREADS = "constexpr int EMIT_THREADS = 128;"
BOUNDS = "__launch_bounds__(EMIT_THREADS, 4)"


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old!r}; update the variants")
    return text.replace(old, new)


def _plan(cu: str, threads: int, blocks: int) -> str:
    cu = _edit(cu, THREADS, f"constexpr int EMIT_THREADS = {threads};")
    return _edit(cu, BOUNDS, f"__launch_bounds__(EMIT_THREADS, {blocks})")


def variants() -> dict[str, tuple[str, str]]:
    """name -> (compress.cu, emit_scan.cuh) texts."""
    cu = (_build.CSRC / "compress.cu").read_text()
    cuh = (_build.CSRC / "emit_scan.cuh").read_text()
    pf = _edit(cuh, LOAD, PREFETCH + LOAD)
    ahead = _edit(_edit(cuh, AHEAD_START, AHEAD_START + AHEAD_ROWS), LOAD, AHEAD_LOAD)
    return {
        "base": (cu, cuh),
        "pf": (cu, pf),
        "ahead1": (cu, ahead),
        "lb3": (_plan(cu, 128, 3), cuh),
        "lb2": (_plan(cu, 128, 2), cuh),
        "b64": (_plan(cu, 64, 8), cuh),
        "lb3_pf": (_plan(cu, 128, 3), pf),
    }


def build_all(nvcc: str) -> dict:
    """Compile every variant at once; returns name -> msm_emit_scan."""
    procs = {}
    for name, (cu, cuh) in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "compress.cu").write_text(cu)
        (d / "emit_scan.cuh").write_text(cuh)  # shadows csrc/emit_scan.cuh for this file
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(d / "lib.so"),
             str(d / "compress.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "k_emit_scan" in line and "Compiling entry" in line:
                for follow in lines[i + 1:i + 3]:
                    print(f"ptxas {name}: {follow.strip()}", flush=True)
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).msm_emit_scan
        fn.argtypes = _build.SIGNATURES["msm_emit_scan"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def emit_scan_case(n_log2: int) -> list:
    """emit_scan's inputs in the compressed 2^n MSM's first launch: (cfg,
    packed table, perm, flags [G, C, R], s, t0), all on the card."""
    cfg = MsmConfig(curve=BN254, compress=True)
    n = 1 << n_log2
    geo = pick_geometry(n, cfg)
    G = min(geo.subtask_batch, cfg.num_subtasks)
    _, pts, ks = cs.sample_msm(n)
    x, y, s = (torch.from_numpy(a).cuda() for a in common.pad_inputs(pts, ks, cfg))
    packed = common.prepare_points(cfg, x, y)
    keys, signs = decompose_signed(s, cfg.chunk_size, cfg.num_subtasks)
    pv, sbit = scan.sort_payload(keys[:G], signs[:G])
    perm, flags = scan._decode_payload_step_major(pv, sbit, geo.num_rows)
    sfx = pair_suffix(cfg, packed, perm, flags)
    return [cfg, packed, perm, flags, sfx, mont_pow(cfg, sfx[:, 0], cfg.curve.modulus - 2)]


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
    cases = {}
    for n_log2, reps in ((20, 3), (16, 10)):
        a = emit_scan_case(n_log2)
        cfg, perm = a[0], a[2]
        G, C, R = perm.shape
        cs._check_case(kern, get_field_ctx(cfg), cfg.num_words, "emit_scan", f"2^{n_log2} G{G} C{C} R{R}",
                       a, False, 3, clock_hz)
        cases[n_log2] = (a, emit_scan(*a), reps)
    times: dict[tuple[int, str], list[float]] = {}
    names = list(fns)
    for rnd in range(args.rounds):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for n_log2, (a, want, reps) in cases.items():
            _cfg, packed, perm, flags, sfx, t0 = a
            G, C, R = perm.shape
            out = [torch.empty_like(w) for w in want]
            for name in order:
                fn = fns[name]

                def run():
                    err = fn(packed.data_ptr(), perm.data_ptr(), flags.data_ptr(), sfx.data_ptr(),
                             t0.data_ptr(), *(o.data_ptr() for o in out), G, C // 2, R,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name}: CUDA error {err}")

                for o in out:
                    o.zero_()
                _, ms = cs._kernel_ms(run, reps)
                if not all(torch.equal(o, w) for o, w in zip(out, want)):
                    raise AssertionError(f"variant {name} differs from the kernel at 2^{n_log2}")
                times.setdefault((n_log2, name), []).append(ms)
                print(f"round {rnd} 2^{n_log2} {name}: {ms:.4f} ms", flush=True)
    for n_log2 in cases:
        base = statistics.median(times[(n_log2, "base")])
        for name in names:
            med = statistics.median(times[(n_log2, name)])
            print(f"median 2^{n_log2} {name:8s} {med:.4f} ms  ({med / base:.3f} x base)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
