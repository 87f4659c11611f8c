#!/usr/bin/env python3
"""Design variants of kernel 1, the point add (``msm_tpu_torch/csrc/
point_add.cu``), and kernel 6, the point total (``csrc/point_total.cu``),
timed against each other on one GPU at the shapes of the plain 2^20 and
2^16 MSMs.

    python3 scripts/torch_add_total_variants.py [--rounds 3]

The design variants are compiled on their own (all at once) into
``build/add_total_variants/<name>/`` and loaded with ctypes; the sources as
they are run from the library ``msm_tpu_torch.ops._build`` builds:

- point add ``thread`` (the source as it is, a thread per add): each thread
  reads its six 80-byte rows with 16-byte vector loads and writes its three
  rows with 16-byte stores; ``smem``: a block stages its 128 rows of each
  coordinate through shared memory, read and written as whole contiguous
  tiles (coalesced), each thread reading its row there; ``warp`` (the
  source's other mode): a warp per add, its products split over the lanes,
  at the small batches where ops/cuda_curve.point_add_lanes weighs the two
  modes (32 adds, the naive running sum's; 2112, the largest batch that
  takes it);
- point total ``two_launch`` (the source as it is): the partial sums, then a
  second launch with one warp per subtask finishes; ``ticket``: the last
  block of a subtask to write its partial (an atomic ticket per subtask,
  reset by that block) finishes in the same launch; and the source at half,
  twice and four times the plan's points per thread (``k/2``, ``2k``,
  ``4k``; runtime arguments, no rebuild).

Prints the card, each build's ptxas report (registers, stack, spills),
then per round, case and variant the ms per call (CUDA events over calls
queued behind a spin kernel, as ``chip_smoke.py`` times kernels), the
variants in a rotated order each round, and last each variant's median
over the rounds beside the source's. The wrappers are first held exactly
against their plain twins at every case, and every variant's outputs must
equal the wrapper's bit for bit (the point total on real curve points:
its variants sum in other orders, so there as points). Needs the CUDA
toolkit and one GPU.
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

OUT = _build.BUILD_ROOT.parent / "add_total_variants"

SMEM_ADD = r"""
#include <cuda_runtime.h>

#include "point_add.cuh"

using namespace msm;

constexpr int THREADS = 128;

// The block's rows [row0, row0 + rows) of one [n, L] coordinate <-> tile.
__device__ void tile_in(int4* tile, const int32_t* src, int64_t row0, int rows) {
  const int4* q = reinterpret_cast<const int4*>(src + row0 * L);
  for (int i = threadIdx.x; i < rows * L / 4; i += THREADS) tile[i] = __ldg(q + i);
}

__device__ void tile_out(int32_t* dst, const int4* tile, int64_t row0, int rows) {
  int4* q = reinterpret_cast<int4*>(dst + row0 * L);
  for (int i = threadIdx.x; i < rows * L / 4; i += THREADS) q[i] = tile[i];
}

__global__ void __launch_bounds__(THREADS, 4)
    k_point_add(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int64_t n) {
  __shared__ int4 tile[THREADS * L / 4];
  const int64_t row0 = (int64_t)blockIdx.x * THREADS;
  const int rows = (int)(n - row0 < THREADS ? n - row0 : THREADS);
  const bool mine = threadIdx.x < rows;
  const int4* row = tile + threadIdx.x * (L / 4);
  const int32_t* in[6] = {ax, ay, az, bx, by, bz};
  fe32 v[6];
  MSM_UNROLL
  for (int c = 0; c < 6; ++c) {
    tile_in(tile, in[c], row0, rows);
    __syncthreads();
    if (mine) {
      int32_t raw[L];
      MSM_UNROLL
      for (int k = 0; k < L / 4; ++k) {
        const int4 w = row[k];
        raw[4 * k] = w.x; raw[4 * k + 1] = w.y; raw[4 * k + 2] = w.z; raw[4 * k + 3] = w.w;
      }
      fe32_from_balanced(v[c], raw);
    }
    __syncthreads();
  }
  pt32 r;
  if (mine) pt32_add(r, pt32{v[0], v[1], v[2]}, pt32{v[3], v[4], v[5]});
  int32_t* out[3] = {ox, oy, oz};
  const fe32* res[3] = {&r.x, &r.y, &r.z};
  MSM_UNROLL
  for (int c = 0; c < 3; ++c) {
    if (mine) {
      uint32_t l[L];
      fe32_to_limbs(l, *res[c]);
      int4* w = tile + threadIdx.x * (L / 4);
      MSM_UNROLL
      for (int k = 0; k < L / 4; ++k)
        w[k] = make_int4((int)l[4 * k], (int)l[4 * k + 1], (int)l[4 * k + 2], (int)l[4 * k + 3]);
    }
    __syncthreads();
    tile_out(out[c], tile, row0, rows);
    __syncthreads();
  }
}

extern "C" int msm_point_add(const int32_t* ax, const int32_t* ay, const int32_t* az,
                             const int32_t* bx, const int32_t* by, const int32_t* bz,
                             int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, int lanes,
                             void* stream) {
  if (n > 0)
    k_point_add<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        ax, ay, az, bx, by, bz, ox, oy, oz, n);
  return (int)cudaGetLastError();
}
"""

TICKET_TOTAL = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "point_total.cuh"

using namespace msm;

constexpr int BLOCK = 128;

__device__ __forceinline__ void fe32_shfl_down(fe32& o, const fe32& a, int off) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) o.w[i] = __shfl_down_sync(0xffffffffu, a.w[i], off);
}

__device__ __forceinline__ void pt32_lanes_sum(pt32& s, int width) {
  MSM_ROLLED
  for (int h = width / 2; h > 0; h >>= 1) {
    pt32 o;
    fe32_shfl_down(o.x, s.x, h);
    fe32_shfl_down(o.y, s.y, h);
    fe32_shfl_down(o.z, s.z, h);
    pt32_add(s, s, o);
  }
}

__global__ void __launch_bounds__(BLOCK, 4)
    k_point_total(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz, uint32_t* part, unsigned* tickets,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, int64_t N, int k) {
  __shared__ pt32 sw[BLOCK / 2];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x, g = blockIdx.y;
  const int nb = gridDim.x;
  pt32 s;
  pt_total_run(s, px, py, pz, g, N, k, b * BLOCK + t);
  MSM_ROLLED
  for (int h = BLOCK / 2; h >= 32; h >>= 1) {
    if (t >= h && t < 2 * h) sw[t - h] = s;
    __syncthreads();
    if (t < h) pt32_add(s, s, sw[t]);
    __syncthreads();
  }
  if (t >= 32) return;
  pt32_lanes_sum(s, 32);
  unsigned ticket = 0;
  if (t == 0) {
    pt32_store_words(part + (g * nb + b) * pt_words<FpBn254>, s);
    __threadfence();
    ticket = atomicAdd(tickets + g, 1u);
  }
  if (__shfl_sync(0xffffffffu, ticket, 0) != (unsigned)nb - 1) return;
  __threadfence();  // the other blocks' partials are visible
  pt_total_partials(s, part, g, nb, t, 32);
  int width = 1;
  while (width < nb && width < 32) width <<= 1;
  pt32_lanes_sum(s, width);
  if (t == 0) {
    pt32_store_limbs(ox + g * L, oy + g * L, oz + g * L, 1, s);
    tickets[g] = 0;
  }
}

extern "C" int msm_point_total_ticket(const int32_t* px, const int32_t* py, const int32_t* pz,
                                      uint32_t* part, unsigned* tickets, int32_t* ox,
                                      int32_t* oy, int32_t* oz, int64_t groups, int64_t N,
                                      int k, int nb, void* stream) {
  if (groups > 0)
    k_point_total<<<dim3((unsigned)nb, (unsigned)groups), BLOCK, 0, (cudaStream_t)stream>>>(
        px, py, pz, part, tickets, ox, oy, oz, N, k);
  return (int)cudaGetLastError();
}
"""

P = ctypes.c_void_p


#: variant -> (source text, csrc file it replaces, entry, argtypes): the
#: design variants, BN254's alone (no curve index), each compiled on its
#: own; the sources as they are (``thread``/``warp``, ``two_launch``) run
#: from the library that ``_build`` builds, called with BN254's curve index
BUILDS = {
    "smem": (SMEM_ADD, "point_add.cu", "msm_point_add",
             _build.SIGNATURES["msm_point_add"][:-2] + [P]),
    "ticket": (TICKET_TOTAL, "point_total.cu", "msm_point_total_ticket",
               [P] * 8 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, P]),
}


def build_all(nvcc: str) -> dict:
    """Compile every variant at once; returns name -> C entry point, the
    library's own point add and point total included."""
    procs = {}
    for name, (text, src, _entry, _args) in BUILDS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / src
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(d / "lib.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lib = _build.load()
    fns = {"thread": lib.msm_point_add, "two_launch": lib.msm_point_total}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if re.search(r"registers|spill|stack frame|Compiling entry", line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        _text, _src, entry, argtypes = BUILDS[name]
        fn = getattr(ctypes.CDLL(str(OUT / name / "lib.so")), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, *args) -> None:
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")


def add_runs(fns, args) -> dict:
    """name -> zero-argument launch of each point-add variant; outputs in
    fresh tensors, returned by the launch."""
    ins = args[1:]
    B = ins[0].shape[0]
    out = [torch.empty_like(ins[0]) for _ in range(3)]

    def run(fn, *tail):
        def go():
            _call(fn, *ins, *out, B, *tail)
            return out
        return go

    runs = {"thread": run(fns["thread"], 0, 0)}  # lanes, BN254's curve index
    if B <= 2112:
        runs["warp"] = run(fns["thread"], 1, 0)
    runs["smem"] = run(fns["smem"], 0)
    return runs


def total_runs(fns, args) -> dict:
    """name -> zero-argument launch of each point-total variant."""
    from msm_tpu_torch.ops.cuda_prefix import point_total_plan, pt_words

    cfg, ins = args[0], args[1:]
    G, N, L = ins[0].shape
    plan = point_total_plan(cfg, G, N)
    dev = ins[0].device
    out = [torch.empty((G, L), dtype=torch.int32, device=dev) for _ in range(3)]
    tickets = torch.zeros(G, dtype=torch.int32, device=dev)

    def run(name, k):
        nb = max(1, -(-N // (k * 128)))
        part = torch.empty((G, nb, pt_words(cfg)), dtype=torch.int32, device=dev)
        if name == "ticket":
            return lambda: (_call(fns[name], *ins, part, tickets, *out, G, N, k, nb), out)[1]
        return lambda: (_call(fns[name], *ins, part, *out, G, N, k, nb, 0), out)[1]  # BN254

    runs = {"two_launch": run("two_launch", plan.points_per_thread),
            "ticket": run("ticket", plan.points_per_thread)}
    if plan.points_per_thread > 1:
        runs["k/2"] = run("two_launch", plan.points_per_thread // 2)
    runs["2k"] = run("two_launch", 2 * plan.points_per_thread)
    runs["4k"] = run("two_launch", 4 * plan.points_per_thread)
    return runs


def cases(rng, base, dev) -> dict:
    """label -> (kernel name, wrapper arguments, reps): the point add at the
    2^20 MSM's boundary-prefix batch (4 x 32769 adds), at 2112 and at the
    naive running sum's 32; the point total at the 2^20 and 2^16 window sums and the
    blocked tail."""
    from msm_tpu_torch.params import pick_config

    cfg = pick_config(1 << 20)

    def fe(batch):
        return [torch.from_numpy(cs._rand_fe(rng, (batch,), cfg)).to(dev) for _ in range(6)]

    return {
        "add 131076": ("point_add", [cfg, *fe(4 * cfg.num_buckets)], 5),
        "add 2112": ("point_add", [cfg, *fe(2112)], 20),
        "add 32": ("point_add", [cfg, *fe(32)], 20),
        "total 16x32768": ("point_total", [cfg, *cs._curve_points(rng, (16, 32768), cfg, base, dev)], 5),
        "total 20x4096": ("point_total", [cfg, *cs._curve_points(rng, (20, 4096), cfg, base, dev)], 10),
        "total 16x512": ("point_total", [cfg, *cs._curve_points(rng, (16, 512), cfg, base, dev)], 10),
    }


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
    from msm_tpu_torch.oracle.pyecc import Curve
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import BN254, MsmConfig

    _build.load()
    fns = build_all(_build.find_nvcc())
    kern = cs._kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    bcfg = MsmConfig(curve=BN254)
    aff = [Curve(BN254).to_affine(p) for p in Curve(BN254).sample_points(256, seed=cs.SEED)]
    base = torch.stack([torch.from_numpy(cs._mont(v, bcfg)) for v in zip(*aff)]).to(dev)
    runs = {}
    for label, (name, a, reps) in cases(rng, base, dev).items():
        cfg = a[0]
        f = get_field_ctx(cfg)
        as_points = name == "point_total"
        cs._check_case(kern, f, cfg.num_words, name, label, a, as_points, 3, clock_hz)
        want = kern[name][0](*a)
        variants = (add_runs if name == "point_add" else total_runs)(fns, a)
        for vname, fn in variants.items():
            got = [g.clone() for g in fn()]
            torch.cuda.synchronize()
            same = (cs._compare(f, got, want, True) == 0 if as_points
                    else all(torch.equal(g, w) for g, w in zip(got, want)))
            if not same:
                raise AssertionError(f"variant {vname} differs from the wrapper at {label}")
        runs[label] = (variants, reps)
    times: dict[tuple[str, str], list[float]] = {}
    for rnd in range(args.rounds):
        for label, (variants, reps) in runs.items():
            names = list(variants)
            for vname in names[rnd % len(names):] + names[:rnd % len(names)]:
                _, ms = cs._kernel_ms(variants[vname], reps)
                times.setdefault((label, vname), []).append(ms)
                print(f"round {rnd} {label} {vname}: {ms:.4f} ms", flush=True)
    for label, (variants, _reps) in runs.items():
        names = list(variants)
        first = statistics.median(times[(label, names[0])])
        for vname in names:
            med = statistics.median(times[(label, vname)])
            print(f"median {label:15s} {vname:10s} {med:.4f} ms  ({med / first:.3f} x {names[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
