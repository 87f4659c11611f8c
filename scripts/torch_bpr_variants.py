#!/usr/bin/env python3
"""Design variants of kernel 8, phase 1 of the blocked bucket reduction
(``k_bpr_phase1`` in ``msm_tpu_torch/csrc/bpr.cu`` + ``bpr.cuh``), and the
lanes of the blocked stage 4, timed on one GPU.

    python3 scripts/torch_bpr_variants.py [--rounds 3]

Every variant is the one chain body, ``bpr_phase1_chain<LANES>`` of
``csrc/bpr.cuh`` (the m chain on half of a group of LANES lanes, the acc
chain a step behind on the other half), in a kernel template of this
script's own source (built with nvcc into ``build/bpr_variants/``, one
object per group width compiled in parallel, and loaded with ctypes):
LANES in {4, 8, 32} lanes per chain (32: a warp per chain, as kernels 1
and 7 split a formula), in blocks of 64, 128 and 256 threads, each with
launch bounds that let one wave hold the 2^20 shape's chains where 128
registers a thread allow it. The kept kernel runs from the package's
library (``kept`` rows).

Shapes: the blocked reduction's phase 1 at 2^20 (G16 T512 Bl64) and at
2^16 (G20 T256 Bl16) on random field triples with planted rows
(``chip_smoke._bpr_buckets``); the kept kernel and every variant must equal
the plain twin after canonicalization. Then the blocked stage 4
(``ops/scan.bucket_reduce_blocked``: the kept kernel and its tail) over the
buckets of the 2^20 MSM (``chip_smoke.sample_msm``) at bpr_threads T in
{256, 512, 1024, 2048}; each T's 16 window sums must equal the telescoped
ones (by cross-multiplication).

Prints the card, each variant's ptxas report, per round, shape and variant
the ms per launch (CUDA events over back-to-back launches queued behind a
spin kernel, the variants in a rotated order each round), the medians
beside the kept kernel's, and the stage-4 ms per T. Needs the CUDA toolkit
and one GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from msm_tpu_torch.ops import _build  # noqa: E402

OUT = _build.BUILD_ROOT.parent / "bpr_variants"
GROUPS = (4, 8, 32)
BLOCKS = (64, 128, 256)
#: (G, Bl, T) of the 2^20 and 2^16 blocked reductions
SHAPES = {"2^20": (16, 64, 512), "2^16": (20, 16, 256)}
STAGE4_LANES = (256, 512, 1024, 2048)

HEAD = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "bpr.cuh"

using namespace msm;

template <int LANES, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    k_bpr_var(const int32_t* __restrict__ bx, const int32_t* __restrict__ by,
              const int32_t* __restrict__ bz, int32_t* __restrict__ mx,
              int32_t* __restrict__ my, int32_t* __restrict__ mz,
              int32_t* __restrict__ gx, int32_t* __restrict__ gy,
              int32_t* __restrict__ gz, int Bl, int T) {
  const int t = blockIdx.x * (THREADS / LANES) + threadIdx.x / LANES;
  bpr_phase1_chain<LANES>(bx, by, bz, mx, my, mz, gx, gy, gz, blockIdx.y, Bl,
                          T, t < T ? t : T - 1, t < T);
}

template <int LANES, int THREADS, int MIN_BLOCKS>
static int launch(const int32_t* bx, const int32_t* by, const int32_t* bz,
                  int32_t* mx, int32_t* my, int32_t* mz, int32_t* gx,
                  int32_t* gy, int32_t* gz, int64_t groups, int Bl, int T,
                  void* stream) {
  constexpr int CHAINS = THREADS / LANES;
  const dim3 grid((unsigned)((T + CHAINS - 1) / CHAINS), (unsigned)groups);
  k_bpr_var<LANES, THREADS, MIN_BLOCKS>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(bx, by, bz, mx, my, mz, gx,
                                                   gy, gz, Bl, T);
  return (int)cudaGetLastError();
}
"""
ENTRY = """
extern "C" int bpr_{name}(const int32_t* bx, const int32_t* by,
                         const int32_t* bz, int32_t* mx, int32_t* my,
                         int32_t* mz, int32_t* gx, int32_t* gy, int32_t* gz,
                         int64_t groups, int Bl, int T, void* stream) {{
  return launch<{lanes}, {threads}, {min_blocks}>(
      bx, by, bz, mx, my, mz, gx, gy, gz, groups, Bl, T, stream);
}}
"""


def min_blocks(lanes: int, threads: int) -> int:
    """Blocks per SM that hold the 2^20 shape's 16 x 512 chains of ``lanes``
    lanes in one wave, at most 512 threads an SM (128 registers each)."""
    G, _, T = SHAPES["2^20"]
    return max(1, min(-(-G * T * lanes // (_build.SMS * threads)), 512 // threads))


def variant_name(lanes: int, threads: int) -> str:
    return f"l{lanes}_b{threads}"


def build() -> ctypes.CDLL:
    """Compile one object per group width (in parallel) and link them;
    prints each kernel's ptxas registers, frame and spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()

    def compile_one(lanes: int) -> tuple[Path, str]:
        src = OUT / f"bpr_l{lanes}.cu"
        src.write_text(HEAD + "".join(
            ENTRY.format(name=variant_name(lanes, b), lanes=lanes, threads=b,
                         min_blocks=min_blocks(lanes, b))
            for b in BLOCKS))
        obj = src.with_suffix(".o")
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-c", str(src), "-o", str(obj)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stderr}")
        return obj, r.stdout + r.stderr

    with ThreadPoolExecutor(max_workers=len(GROUPS)) as pool:
        results = list(pool.map(compile_one, GROUPS))
    so = OUT / "libbpr_variants.so"
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(so),
                    *[str(o) for o, _ in results]], check=True, capture_output=True, text=True)
    for _, log in results:
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                stats = " ".join(x.strip() for x in lines[i + 1:i + 4] if "Compiling entry" not in x)
                print(f"ptxas {m.group(1)}: {stats}", flush=True)
    lib = ctypes.CDLL(str(so))
    for lanes in GROUPS:
        for b in BLOCKS:
            fn = getattr(lib, f"bpr_{variant_name(lanes, b)}")
            fn.argtypes = _build.SIGNATURES["msm_bpr_phase1"]
            fn.restype = ctypes.c_int
    return lib


def caller(lib, name: str, ins, outs):
    """A launch of variant ``name`` on the current stream (``kept``: the
    kept kernel through its wrapper) that returns the six outputs."""
    from msm_tpu_torch.ops.cuda_bpr import bpr_phase1

    cfg, bx, by, bz = ins
    if name == "kept":
        return lambda: bpr_phase1(cfg, bx, by, bz)
    G, Bl, T, _ = bx.shape
    fn = getattr(lib, f"bpr_{name}")

    def run():
        err = fn(*(a.data_ptr() for a in (bx, by, bz, *outs)), G, Bl, T,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bpr_{name}: CUDA error {err}")
        return outs

    return run


def sweep_kernels(lib, rounds: int) -> None:
    from msm_tpu_torch.ops.cuda_bpr import bpr_phase1_plain
    from msm_tpu_torch.ops.field import get_field_ctx
    from msm_tpu_torch.params import pick_config

    rng = np.random.default_rng(cs.SEED)
    names = ["kept"] + [variant_name(lanes, b) for lanes in GROUPS for b in BLOCKS]
    runs = {}
    for label, (G, Bl, T) in SHAPES.items():
        cfg = pick_config(1 << int(label[2:]))
        f = get_field_ctx(cfg)
        ins = [cfg, *(torch.from_numpy(a).cuda() for a in cs._bpr_buckets(rng, (G, Bl, T), cfg))]
        want = [f.canonical(a) for a in bpr_phase1_plain(*ins)]
        for name in names:
            outs = [torch.empty((G, T, cfg.num_words), dtype=torch.int32, device="cuda") for _ in range(6)]
            runs[label, name] = fn = caller(lib, name, ins, outs)
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} at {label} G{G} T{T} Bl{Bl} differs from the twin")
        print(f"{label} G{G} T{T} Bl{Bl}: the kept kernel and {len(names) - 1} variants equal the twin",
              flush=True)
    times: dict[tuple[str, str], list[float]] = {}
    for rnd in range(rounds):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for label in SHAPES:
            for name in order:
                ms = cs._kernel_ms(runs[label, name], 3)[1]
                times.setdefault((label, name), []).append(ms)
                print(f"round {rnd} {label} {name:9s} {ms:.4f} ms", flush=True)
    for label in SHAPES:
        kept = statistics.median(times[label, "kept"])
        for name in names:
            ms = statistics.median(times[label, name])
            print(f"median {label} {name:9s} {ms:.4f} ms ({ms / kept:.3f} x kept)", flush=True)


def sweep_stage4(rounds: int) -> None:
    """The blocked stage 4 at 2^20 with the kept kernel at each T."""
    from msm_tpu_torch.models import common
    from msm_tpu_torch.models.geometry import pick_geometry
    from msm_tpu_torch.ops import scan
    from msm_tpu_torch.ops.curve import get_curve_ctx
    from msm_tpu_torch.ops.decompose import decompose_signed
    from msm_tpu_torch.params import pick_config

    _, pts, ks = cs.sample_msm(1 << 20)
    n = common.pad_size(len(pts))
    cfg = pick_config(n)
    ec, geom = get_curve_ctx(cfg), pick_geometry(n, cfg)
    batch = min(geom.subtask_batch, cfg.num_subtasks)
    xd, yd, sd = (torch.from_numpy(a).cuda() for a in common.pad_inputs(pts, ks, cfg))
    packed = common.prepare_points(cfg, xd, yd)
    keys, signs = decompose_signed(sd, cfg.chunk_size, cfg.num_subtasks)
    buckets = scan.bucket_accumulate(ec, packed, keys, signs, cfg.num_buckets, geom.num_rows, batch)
    pe = scan.bucket_boundary_prefix(ec, packed, keys, signs, cfg.num_buckets, geom.num_rows, batch)
    tele = scan.window_sum_from_pe(ec, pe)
    for T in STAGE4_LANES:
        err = cs._compare(ec.f, tuple(scan.bucket_reduce_blocked(ec, buckets, T)), tuple(tele), as_points=True)
        if err:
            raise AssertionError(f"blocked stage 4 at T={T}: window sums differ from the telescoped ones")
    print(f"blocked stage 4 2^20: window sums equal the telescoped ones at T = {STAGE4_LANES}", flush=True)
    times: dict[int, list[float]] = {}
    for rnd in range(rounds):
        k = rnd % len(STAGE4_LANES)
        for T in STAGE4_LANES[k:] + STAGE4_LANES[:k]:
            ms = cs._kernel_ms(lambda: scan.bucket_reduce_blocked(ec, buckets, T), 3)[1]
            times.setdefault(T, []).append(ms)
            print(f"round {rnd} stage4 T={T} Bl={(cfg.num_buckets - 1) // T} {ms:.4f} ms", flush=True)
    tele_ms = cs._kernel_ms(lambda: scan.window_sum_from_pe(ec, pe), 3)[1]
    for T in STAGE4_LANES:
        print(f"median stage4 T={T} {statistics.median(times[T]):.4f} ms", flush=True)
    print(f"telescoped stage 4 {tele_ms:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.load()
    lib = build()
    sweep_kernels(lib, args.rounds)
    sweep_stage4(args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
