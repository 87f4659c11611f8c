#!/usr/bin/env python3
"""Where the narrow library's kernels read the limb width's constants
from: the translation unit's ``__constant__`` width block (what the
library does: ``csrc/fields.cuh`` ``width_dev``, loaded by
``csrc/dispatch.cuh``'s ``WidthScope``) or a by-value kernel parameter,
timed on one GPU.

    python3 scripts/torch_width_param_ab.py [--rounds 5] [--iters 256]

The kernels of the library read the block in every Montgomery product
(the REDC's run-time tail step: TAIL and N0T) and at every boundary
(W, L, MASK), from functions many calls below the kernel, so the library
cannot take the block as a parameter without passing it down every call.
This script times the question on a model instead: one thread a lane runs
a chain of ``--iters`` BN254 products (the word core's no-carry CIOS of
``csrc/fe32.cuh``, then its run-time tail step and conditional subtract),
the tail's TAIL and N0T read through a source type: ``const`` from
``width_dev`` (the library's constant block, constant bank 3), ``param``
from a ``__grid_constant__`` WidthBlock parameter (constant bank 0). The
two kernels are the one template; a third, ``real``, runs the library's
own ``fe32_mul`` (narrow build, ``__constant__`` block), which the model
must match. All three must agree word for word, at each width.

Built with nvcc (``_build.NVCC_FLAGS`` and ``NARROW_FLAGS``) into
``build/width_param_ab/``. Prints the card, each kernel's ptxas report and
SASS (instructions, LDC, ``c[0x0]`` and ``c[0x3]`` operands), per round,
width and kernel the ms per launch over 2^20 lanes (CUDA events over
launches queued behind a spin kernel, the kernels in a rotated order each
round), then the medians and ``param / const``. Needs the CUDA toolkit and
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
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from msm_tpu_torch.ops import _build  # noqa: E402
from torch_sass_mix import sass  # noqa: E402

OUT = _build.BUILD_ROOT.parent / "width_param_ab"
KINDS = ("const", "param", "real")
#: BN254 widths timed: TAIL 8 at 8, 4 at 10
WIDTHS = (8, 10)
LANES = 1 << 20

SOURCE = r"""
#include <cuda_runtime.h>

#include <type_traits>

#include "fe32.cuh"

namespace {
using F = msm::FpBn254;
using msm::fe32t;

struct ConstSrc {
  __device__ __forceinline__ int tail() const { return msm::width_block(F::ID).TAIL; }
  __device__ __forceinline__ uint32_t n0t() const { return msm::width_block(F::ID).N0T; }
};

struct ParamSrc {
  const msm::WidthBlock& b;
  __device__ __forceinline__ int tail() const { return b.TAIL; }
  __device__ __forceinline__ uint32_t n0t() const { return b.N0T; }
};

// fe32_mul's no-carry word CIOS and fe32_redc_tail's run-time step, the
// tail's constants from `src`
template <class Src>
__device__ __forceinline__ void model_mul(const Src& src, fe32t<F>& out, const fe32t<F>& a,
                                          const fe32t<F>& b) {
  constexpr int NW = F::NW;
  uint32_t t[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint64_t s = (uint64_t)a.w[0] * bi + t[0];
    uint32_t A = msm::hi32(s);
    const uint32_t t0 = msm::lo32(s);
    const uint32_t m = t0 * F::N0W;
    uint32_t C = msm::hi32((uint64_t)m * F::p(0) + t0);
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)a.w[j] * bi + t[j] + A;
      A = msm::hi32(s);
      const uint64_t u = (uint64_t)m * F::p(j) + msm::lo32(s) + C;
      t[j - 1] = msm::lo32(u);
      C = msm::hi32(u);
    }
    t[NW - 1] = C + A;
  }
  const int tail = src.tail();
  const uint32_t m = (t[0] * src.n0t()) & ((1u << tail) - 1u);
  uint32_t u[NW + 1];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t v = (uint64_t)m * F::p(j) + t[j] + c;
    u[j] = msm::lo32(v);
    c = msm::hi32(v);
  }
  u[NW] = c;
#pragma unroll
  for (int j = 0; j < NW; ++j) out.w[j] = msm::shr_pair(u[j], u[j + 1], tail);
  msm::fe32_reduce_once(out);
}

struct Real {};

template <class Src>
__device__ __forceinline__ void chain(const Src& src, const uint32_t* in, uint32_t* out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe32t<F> a, b;
#pragma unroll
  for (int j = 0; j < F::NW; ++j) {
    a.w[j] = in[(int64_t)j * n + i];
    b.w[j] = in[(int64_t)(F::NW + j) * n + i];
  }
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    if constexpr (std::is_same_v<Src, Real>)
      msm::fe32_mul<F>(a, a, b);
    else
      model_mul(src, a, a, b);
  }
#pragma unroll
  for (int j = 0; j < F::NW; ++j) out[(int64_t)j * n + i] = a.w[j];
}

__global__ void __launch_bounds__(128) k_const(const uint32_t* in, uint32_t* out, int n, int iters) {
  chain(ConstSrc{}, in, out, n, iters);
}

__global__ void __launch_bounds__(128) k_param(const __grid_constant__ msm::WidthBlock wb, const uint32_t* in,
                                               uint32_t* out, int n, int iters) {
  chain(ParamSrc{wb}, in, out, n, iters);
}

__global__ void __launch_bounds__(128) k_real(const uint32_t* in, uint32_t* out, int n, int iters) {
  chain(Real{}, in, out, n, iters);
}
}  // namespace

// BN254's row of `width` in this unit's constant block (what the const
// and real kernels read), before their timed launches
extern "C" int wp_load(int width) {
  if (width < msm::WIDTH_MIN || width > msm::WIDTH_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(msm::width_dev, &msm::WIDTH_BLOCKS[F::ID][width - msm::WIDTH_MIN],
                                 sizeof(msm::WidthBlock), F::ID * sizeof(msm::WidthBlock));
}

// Kernel `kind` (0 const, 1 param: BN254's row of `width` by value, 2 real)
extern "C" int wp_launch(int kind, int width, const uint32_t* in, uint32_t* out, int n, int iters,
                         void* stream) {
  if (width < msm::WIDTH_MIN || width > msm::WIDTH_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + 127) / 128;
  if (kind == 0)
    k_const<<<blocks, 128, 0, st>>>(in, out, n, iters);
  else if (kind == 1)
    k_param<<<blocks, 128, 0, st>>>(msm::WIDTH_BLOCKS[F::ID][width - msm::WIDTH_MIN], in, out, n, iters);
  else
    k_real<<<blocks, 128, 0, st>>>(in, out, n, iters);
  return (int)cudaGetLastError();
}
"""


def build() -> tuple[ctypes.CDLL, Path]:
    """Compile the source, print each kernel's ptxas line, link and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    src, obj, so = OUT / "width_param.cu", OUT / "width_param.o", OUT / "libwidth_param.so"
    src.write_text(SOURCE)
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, *_build.NARROW_FLAGS, f"-I{_build.CSRC}", "-c", str(src),
                        "-o", str(obj)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    lines = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(lines):
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            stats = " ".join(x.strip() for x in lines[i + 1:i + 4] if "Compiling entry" not in x)
            print(f"ptxas {m.group(1)}: {stats}", flush=True)
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(so), str(obj)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.wp_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    lib.wp_launch.restype = ctypes.c_int
    lib.wp_load.argtypes = [ctypes.c_int]
    lib.wp_load.restype = ctypes.c_int
    return lib, obj


def report_sass(obj: Path) -> None:
    """Each kernel's SASS: instructions, LDC, and constant-bank operands."""
    for name, body in sorted(sass(obj).items()):
        kind = next((k for k in KINDS if f"k_{k}" in name), None)
        if kind is None:
            continue
        text = "\n".join(body)
        bank0, bank3 = (len(re.findall(pattern, text)) for pattern in (r"c\[0x0\]", r"c\[0x3\]"))
        ldc = sum("LDC" in x for x in body)
        print(f"sass k_{kind}: {len(body)} instructions, {ldc} LDC, {bank0} c[0x0] and {bank3} c[0x3] operands",
              flush=True)


def inputs(rng) -> torch.Tensor:
    """2 x NW words a lane, word-major: canonical BN254 values below p."""
    from msm_tpu_torch.params import BN254

    p = BN254.modulus
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(2 * 4096)]
    words = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in vals], dtype=np.uint32)
    lanes = words[rng.integers(0, len(vals), size=(2, LANES))]  # [2, LANES, 8]
    flat = np.ascontiguousarray(lanes.transpose(0, 2, 1).reshape(16, LANES))
    return torch.from_numpy(flat.view(np.int32)).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=256, help="products a lane")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    lib, obj = build()
    report_sass(obj)
    x = inputs(np.random.default_rng(cs.SEED))
    outs = {k: torch.empty((8, LANES), dtype=torch.int32, device="cuda") for k in KINDS}

    def launch(kind, width):
        err = lib.wp_launch(KINDS.index(kind), width, x.data_ptr(), outs[kind].data_ptr(), LANES, args.iters,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k_{kind} at width {width}: CUDA error {err}")
        return outs[kind]

    times: dict[tuple[int, str], list[float]] = {}
    for rnd in range(args.rounds):
        order = KINDS[rnd % 3:] + KINDS[:rnd % 3]
        for width in WIDTHS:
            if lib.wp_load(width):
                raise RuntimeError(f"width {width}: the constant block did not load")
            for kind in order:
                _, ms = cs._kernel_ms(lambda: launch(kind, width), 3)
                times.setdefault((width, kind), []).append(ms)
                print(f"round {rnd} w{width} {kind:5s} {ms:.4f} ms", flush=True)
            if not (torch.equal(outs["const"], outs["param"]) and torch.equal(outs["const"], outs["real"])):
                raise AssertionError(f"width {width}: the three kernels' products differ")
    for width in WIDTHS:
        med = {k: statistics.median(times[(width, k)]) for k in KINDS}
        print(f"median w{width} ({LANES} lanes x {args.iters} products): "
              + ", ".join(f"{k} {m:.4f} ms" for k, m in med.items())
              + f"; param / const {med['param'] / med['const']:.4f}, real / const {med['real'] / med['const']:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
