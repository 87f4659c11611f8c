#!/usr/bin/env python3
"""Design variants of kernel 12, the pair suffix products (``k_pair_suffix``
in ``msm_tpu_torch/csrc/compress.cu`` + ``pair32.cuh``), and kernel 9, the
Fermat inversion (``k_mont_pow`` in ``csrc/inv.cu`` + ``pow32.cuh``), timed
against the kept kernels on one GPU on the compressed MSM's own inputs.

    python3 scripts/torch_suffix_pow_variants.py [--rounds 3]

The variants are kernels of this script's own CUDA source (built with nvcc
at once into ``build/suffix_pow_variants/``, on the package's headers, and
loaded with ctypes); the kept kernels run from the package's library
(``kernel`` rows). Kernel 12, one thread per chain unless split, the
gathers x-only (both x coordinates; y where they are equal) and one pair
ahead unless named:

- ``perm2``: perm and flags loaded two pairs ahead and x one, so no load
  waits on a row index issued in the same step (a warp issues in order);
- ``deep``: x two pairs ahead, perm and flags three;
- ``cs``: the kernel with streaming stores of s (``__stcs``, evict-first:
  s is written once and read once by kernel 13);
- ``nopipe``: no software pipelining (each pair's gathers issued just
  before its product);
- ``rows``, ``rows_nopipe``: both full 64-byte rows gathered for every
  pair (the first word-core design), with and without the pipelining;
- ``split2``, ``split4``: each lane's chain split over 2 or 4 threads of a
  block: pass 1 multiplies each segment's denominators, the segment
  offsets (the products of the later segments) are combined through shared
  memory, pass 2 walks each segment again from its offset and stores (2
  products a pair, the gathers twice, 2 or 4 times the chains in flight);
- ``b32``: the kept body in one-warp blocks (the old plan);
- ``limbs13``: the 13-bit kernel that the word-core one replaced
  (``pair_suffix_lane``, formulas out of line, one-warp blocks).

Kernel 9, every variant on the word core unless named: ``bin`` (binary
square-and-multiply, the squaring the general product ``fe32_sqr``),
``bin_sym`` (squarings by ``fe32_sqr_sym``), ``win_mul`` (the fixed 4-bit
window, shared-memory table, squarings by ``fe32_sqr``), ``win_sym`` (the
kept design), each in 64-thread blocks and, suffixed ``_128``, 128-thread
blocks; and ``limbs13``, the 13-bit kernel the word-core one replaced
(``fe_pow``, one-warp blocks).

Inputs: 1024 distinct points tiled to n with uniform scalars
(``chip_smoke.sample_msm``), converted, decomposed and sorted as
``ops/scan`` does, the first batch of subtasks laid out step-major: kernel
12 at the compressed 2^20 and 2^16 MSMs' shapes (models/geometry.py's
rule), kernel 9 on the suffix products' s_0 of the 2^20 stream laid out
over R = 1024, 2048 and 4096 lanes (16 subtasks), e = p - 2. The kept
kernels are first held exactly against their plain twins at every shape;
every variant's output must equal the kept kernel's bit for bit. Prints the
card, each variant's ptxas report, per round, shape and variant the ms per
launch (CUDA events over back-to-back launches queued behind a spin kernel,
the variants in a rotated order each round), and last the median of each
beside the kept kernel's. Needs the CUDA toolkit and one GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import re
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
from msm_tpu_torch.ops.cuda_compress import pair_suffix  # noqa: E402
from msm_tpu_torch.ops.cuda_inv import mont_pow  # noqa: E402
from msm_tpu_torch.ops.decompose import decompose_signed  # noqa: E402
from msm_tpu_torch.ops.field import get_field_ctx  # noqa: E402
from msm_tpu_torch.params import BN254, MsmConfig  # noqa: E402

OUT = _build.BUILD_ROOT.parent / "suffix_pow_variants"

SOURCE = r"""
#include <cuda_runtime.h>

#include "pair.cuh"
#include "pair32.cuh"
#include "pow32.cuh"

using namespace msm;

// ---- kernel 12 ----

// The kept gathers in two halves: a pair's rows and flags, then its x
// coordinates (for the variants that issue them at different steps).
__device__ __forceinline__ void gather_index(pair32_x& q, const int32_t* perm,
                                             const int32_t* flags, int64_t e1,
                                             int64_t e2) {
  q.row1 = perm[e1];
  q.row2 = perm[e2];
  q.f1 = flags[e1];
  q.f2 = flags[e2];
}

__device__ __forceinline__ void gather_xs(pair32_x& q, const int32_t* packed) {
  scan_load_coord(q.x1, packed, q.row1, 0);
  scan_load_coord(q.x2, packed, q.row2, 0);
}

// s_j's limbs with streaming stores (st.global.cs, evict-first): s is
// written once here and read once by kernel 13.
__device__ __forceinline__ void store_limbs_cs(int32_t* dst, int64_t stride,
                                               const fe32& a) {
  uint32_t v[L];
  fe32_to_limbs(v, a);
  MSM_UNROLL
  for (int i = 0; i < L; ++i) __stcs(dst + i * stride, (int32_t)v[i]);
}

// One pair's gathers: the x coordinates only (XONLY, as the kernel: y where
// x1 == x2) or the full rows.
template <bool XONLY>
struct pending;

template <>
struct pending<true> {
  pair32_x q;
  __device__ __forceinline__ void gather(const int32_t* packed,
                                         const int32_t* perm,
                                         const int32_t* flags, int64_t e1,
                                         int64_t e2) {
    pair32_gather_x(q, packed, perm, flags, e1, e2);
  }
  __device__ __forceinline__ void denominator(fe32& d,
                                              const int32_t* packed) const {
    pair32_denominator_x(d, q, packed);
  }
};

template <>
struct pending<false> {
  pair32 pr;
  int f1, f2;
  __device__ __forceinline__ void gather(const int32_t* packed,
                                         const int32_t* perm,
                                         const int32_t* flags, int64_t e1,
                                         int64_t e2) {
    scan_load_row(pr.x1, pr.y1, packed, perm[e1]);
    scan_load_row(pr.x2, pr.y2, packed, perm[e2]);
    f1 = flags[e1];
    f2 = flags[e2];
  }
  __device__ __forceinline__ void denominator(fe32& d, const int32_t*) const {
    pair32 p = pr;
    pair32_make(p, f1, f2);
    pair32_denominator(d, p);
  }
};

// The suffix walk over pairs j_hi down to j_lo of lane r, multiplying into
// run; stores s_j when STORE (streaming stores when CS). PIPE: the next
// pair's gathers issued a pair ahead.
template <bool STORE, bool PIPE, bool XONLY, bool CS = false>
__device__ __forceinline__ void suffix_walk(fe32& run, const int32_t* packed,
                                            const int32_t* perm,
                                            const int32_t* flags, int32_t* s,
                                            int64_t g, int Cp, int R, int r,
                                            int j_hi, int j_lo) {
  if (j_hi < j_lo) return;
  const int64_t s_step = (int64_t)L * R;
  int64_t e = (g * 2 * Cp + 2 * (int64_t)j_hi) * R + r;
  int64_t o = (g * Cp + j_hi) * s_step + r;
  pending<XONLY> next;
  if (PIPE) next.gather(packed, perm, flags, e, e + R);
#pragma unroll 1
  for (int j = j_hi; j >= j_lo; --j, o -= s_step, e -= 2 * (int64_t)R) {
    pending<XONLY> cur;
    if (PIPE) {
      cur = next;
      if (j > j_lo)
        next.gather(packed, perm, flags, e - 2 * (int64_t)R, e - (int64_t)R);
    } else {
      cur.gather(packed, perm, flags, e, e + R);
    }
    fe32 d;
    cur.denominator(d, packed);
    fe32_mul(run, run, d);
    if (STORE) {
      if (CS) {
        store_limbs_cs(s + o, R, run);
      } else {
        fe32_store_limbs_strided(s + o, R, run);
      }
    }
  }
}

template <int T, int MINB, bool PIPE, bool XONLY, bool CS = false>
__global__ void __launch_bounds__(T, MINB)
    k_suffix_one(const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ perm,
                 const int32_t* __restrict__ flags, int32_t* __restrict__ s,
                 int Cp, int R) {
  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= R) return;
  fe32 run;
  fe32_mont_one(run);
  suffix_walk<true, PIPE, XONLY, CS>(run, packed, perm, flags, s, blockIdx.y,
                                     Cp, R, r, Cp - 1, 0);
}

// Deeper pipelines: during pair j's product, pair j-1's x loads and pair
// j-2's perm and flags loads are in flight (DEPTH 0), or pair j-1's and
// j-2's x loads and pair j-3's perm and flags (DEPTH 1): no load then waits
// on a row index issued in the same step.
template <int DEPTH>
__global__ void __launch_bounds__(128, 4)
    k_suffix_ahead(const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ flags, int32_t* __restrict__ s,
                   int Cp, int R) {
  const int r = blockIdx.x * 128 + threadIdx.x;
  if (r >= R) return;
  const int64_t g = blockIdx.y;
  const int64_t pair_step = 2 * (int64_t)R;
  const int64_t s_step = (int64_t)L * R;
  int64_t e = (g * 2 * Cp + 2 * (int64_t)(Cp - 1)) * R + r;
  int64_t o = (g * Cp + Cp - 1) * s_step + r;
  fe32 run;
  fe32_mont_one(run);
  pair32_x q[DEPTH + 2];  // pairs j .. j-DEPTH: x loaded or in flight; j-DEPTH-1: rows
  MSM_UNROLL
  for (int k = 0; k <= DEPTH + 1; ++k) {
    if (Cp - 1 - k < 0) break;
    gather_index(q[k], perm, flags, e - k * pair_step, e - k * pair_step + R);
    if (k <= DEPTH) gather_xs(q[k], packed);
  }
#pragma unroll 1
  for (int j = Cp - 1; j >= 0; --j, o -= s_step, e -= pair_step) {
    const pair32_x cur = q[0];
    MSM_UNROLL
    for (int k = 0; k <= DEPTH; ++k) q[k] = q[k + 1];
    if (j - DEPTH - 1 >= 0) gather_xs(q[DEPTH], packed);
    if (j - DEPTH - 2 >= 0)
      gather_index(q[DEPTH + 1], perm, flags, e - (DEPTH + 2) * pair_step,
                   e - (DEPTH + 2) * pair_step + R);
    fe32 d;
    pair32_denominator_x(d, cur, packed);
    fe32_mul(run, run, d);
    fe32_store_limbs_strided(s + o, R, run);
  }
}

// K threads a lane: segment k of lane r covers pairs [k Cp / K, (k+1) Cp / K).
template <int K>
__global__ void __launch_bounds__(128, 4)
    k_suffix_split(const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ flags, int32_t* __restrict__ s,
                   int Cp, int R) {
  constexpr int LANES = 128 / K;
  __shared__ uint32_t part[K][NW][LANES];
  const int seg = threadIdx.x / LANES, lr = threadIdx.x % LANES;
  const int r = blockIdx.x * LANES + lr;
  const int j_lo = (int)((int64_t)seg * Cp / K);
  const int j_hi = (int)((int64_t)(seg + 1) * Cp / K) - 1;
  fe32 run;
  fe32_mont_one(run);
  if (r < R)
    suffix_walk<false, true, true>(run, packed, perm, flags, s, blockIdx.y,
                                   Cp, R, r, j_hi, j_lo);
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) part[seg][i][lr] = run.w[i];
  __syncthreads();
  if (r >= R) return;
  fe32_mont_one(run);
  for (int q = K - 1; q > seg; --q) {
    fe32 v;
    MSM_UNROLL
    for (int i = 0; i < NW; ++i) v.w[i] = part[q][i][lr];
    fe32_mul(run, run, v);
  }
  suffix_walk<true, true, true>(run, packed, perm, flags, s, blockIdx.y, Cp,
                                R, r, j_hi, j_lo);
}

// The 13-bit kernel the word-core one replaced.
MSM_HD_CALL void pair_suffix_lane13(const int32_t* packed, const int32_t* perm,
                                    const int32_t* flags, int32_t* s, int64_t g,
                                    int Cp, int R, int r) {
  fe run;
  fe_mont_one(run);
  for (int j = Cp - 1; j >= 0; --j) {
    pair_t pr;
    fe d;
    lane_pair(pr, d, packed, perm, flags, g, j, Cp, R, r);
    fe_mul(run, run, d);
    fe_store_strided(s + chain_at(g, j, Cp, R, r), R, run);
  }
}

__global__ void __launch_bounds__(32)
    k_suffix_limbs13(const int32_t* __restrict__ packed,
                     const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ flags, int32_t* __restrict__ s,
                     int Cp, int R) {
  const int r = blockIdx.x * 32 + threadIdx.x;
  if (r < R) pair_suffix_lane13(packed, perm, flags, s, blockIdx.y, Cp, R, r);
}

#define SUFFIX_ENTRY(NAME, KERNEL, LANES_PER_BLOCK, THREADS)                  \
  extern "C" int sfx_##NAME(const int32_t* packed, const int32_t* perm,      \
                            const int32_t* flags, int32_t* s, int64_t groups, \
                            int Cp, int R, void* stream) {                    \
    const dim3 grid((unsigned)((R + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK),  \
                    (unsigned)groups);                                        \
    KERNEL<<<grid, THREADS, 0, (cudaStream_t)stream>>>(packed, perm, flags,   \
                                                       s, Cp, R);             \
    return (int)cudaGetLastError();                                           \
  }

#define COMMA ,
SUFFIX_ENTRY(perm2, k_suffix_ahead<0>, 128, 128)
SUFFIX_ENTRY(deep, k_suffix_ahead<1>, 128, 128)
SUFFIX_ENTRY(cs, k_suffix_one<128 COMMA 4 COMMA true COMMA true COMMA true>, 128,
             128)
SUFFIX_ENTRY(nopipe, k_suffix_one<128 COMMA 4 COMMA false COMMA true>, 128, 128)
SUFFIX_ENTRY(rows, k_suffix_one<128 COMMA 4 COMMA true COMMA false>, 128, 128)
SUFFIX_ENTRY(rows_nopipe, k_suffix_one<128 COMMA 4 COMMA false COMMA false>, 128,
             128)
SUFFIX_ENTRY(b32, k_suffix_one<32 COMMA 16 COMMA true COMMA true>, 32, 32)
SUFFIX_ENTRY(split2, k_suffix_split<2>, 64, 128)
SUFFIX_ENTRY(split4, k_suffix_split<4>, 32, 128)
SUFFIX_ENTRY(limbs13, k_suffix_limbs13, 32, 32)

// ---- kernel 9 ----

constexpr int EXP_WORDS = 32;
struct exp_words {
  uint32_t w[EXP_WORDS];
};

template <bool SYM>
__device__ __forceinline__ void sqr_var(fe32& out, const fe32& a) {
  if (SYM) {
    fe32_sqr_sym(out, a);
  } else {
    fe32_sqr(out, a);
  }
}

template <bool SYM>
__device__ __forceinline__ void pow_binary(fe32& out, const fe32& a,
                                           const uint32_t* e, int nbits) {
  fe32 acc;
  fe32_mont_one(acc);
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {
    sqr_var<SYM>(acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1u) fe32_mul(acc, acc, a);
  }
  out = acc;
}

// pow32_window with the squaring chosen by SYM
template <bool SYM>
__device__ __forceinline__ void pow_window(fe32& out, const fe32& a,
                                           const uint32_t* e, int nbits,
                                           uint32_t* tab, int stride) {
  const int nd = (nbits + POW_WINDOW - 1) / POW_WINDOW;
  fe32 acc;
  fe32_mont_one(acc);
  if (nd == 0) {
    out = acc;
    return;
  }
  fe32 t = a;
  pow32_table_store(tab, stride, 1, t);
#pragma unroll 1
  for (int k = 2; k <= POW_TABLE; ++k) {
    if (k == 2) {
      sqr_var<SYM>(t, a);
    } else {
      fe32_mul(t, t, a);
    }
    pow32_table_store(tab, stride, k, t);
  }
  const int top = pow32_digit(e, nd - 1);
  if (top) pow32_table_load(acc, tab, stride, top);
#pragma unroll 1
  for (int i = nd - 2; i >= 0; --i) {
    MSM_UNROLL
    for (int s = 0; s < POW_WINDOW; ++s) sqr_var<SYM>(acc, acc);
    const int d = pow32_digit(e, i);
    if (d) {
      pow32_table_load(t, tab, stride, d);
      fe32_mul(acc, acc, t);
    }
  }
  out = acc;
}

template <int T, bool SYM, bool WINDOW>
__global__ void __launch_bounds__(T)
    k_pow_var(const int32_t* __restrict__ a, int32_t* __restrict__ out,
              const exp_words e, int nbits, int R) {
  extern __shared__ uint32_t smem[];  // the exponent, then the table
  uint32_t* ew = smem;
  if (threadIdx.x == 0) {
    MSM_UNROLL
    for (int i = 0; i < EXP_WORDS; ++i) ew[i] = e.w[i];
  }
  __syncthreads();
  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= R) return;
  const int64_t o = (int64_t)blockIdx.y * L * R + r;
  int32_t v[L];
  MSM_UNROLL
  for (int i = 0; i < L; ++i) v[i] = a[o + i * (int64_t)R];
  fe32 x, y;
  fe32_from_balanced(x, v);
  if (WINDOW) {
    pow_window<SYM>(y, x, ew, nbits, smem + EXP_WORDS + threadIdx.x, T);
  } else {
    pow_binary<SYM>(y, x, ew, nbits);
  }
  fe32_store_limbs_strided(out + o, R, y);
}

// The 13-bit kernel the word-core one replaced.
MSM_HD_CALL void fe_pow13(fe& out, const fe& a, const uint32_t* e, int nbits) {
  fe acc;
  fe_mont_one(acc);
  for (int i = nbits - 1; i >= 0; --i) {
    fe_sqr(acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1u) fe_mul(acc, acc, a);
  }
  out = acc;
}

__global__ void __launch_bounds__(32)
    k_pow_limbs13(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                  const exp_words e, int nbits, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t o = (int64_t)blockIdx.y * L * R + r;
  fe x, y;
  fe_load_balanced_strided(x, a + o, R);
  fe_pow13(y, x, e.w, nbits);
  fe_store_strided(out + o, R, y);
}

template <typename Kernel>
static int pow_launch(Kernel kernel, int threads, int smem_words,
                      const int32_t* a, int32_t* out, const uint32_t* e_words,
                      int nbits, int64_t batch, int R, void* stream) {
  if (nbits < 0 || nbits > 32 * EXP_WORDS) return (int)cudaErrorInvalidValue;
  exp_words e = {};
  for (int i = 0; i < (nbits + 31) / 32; ++i) e.w[i] = e_words[i];
  const int bytes = smem_words * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((R + threads - 1) / threads), (unsigned)batch);
  kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(a, out, e, nbits, R);
  return (int)cudaGetLastError();
}

#define POW_ENTRY(NAME, T, SYM, WINDOW)                                        \
  extern "C" int pow_##NAME(const int32_t* a, int32_t* out,                   \
                            const uint32_t* e_words, int nbits, int64_t batch, \
                            int R, void* stream) {                            \
    return pow_launch(k_pow_var<T, SYM, WINDOW>, T,                           \
                      EXP_WORDS + (WINDOW ? POW_TABLE * NW * T : 0), a, out,  \
                      e_words, nbits, batch, R, stream);                      \
  }

POW_ENTRY(bin, 64, false, false)
POW_ENTRY(bin_sym, 64, true, false)
POW_ENTRY(win_mul, 64, false, true)
POW_ENTRY(win_sym, 64, true, true)
POW_ENTRY(bin_128, 128, false, false)
POW_ENTRY(bin_sym_128, 128, true, false)
POW_ENTRY(win_mul_128, 128, false, true)
POW_ENTRY(win_sym_128, 128, true, true)

extern "C" int pow_limbs13(const int32_t* a, int32_t* out,
                           const uint32_t* e_words, int nbits, int64_t batch,
                           int R, void* stream) {
  return pow_launch(k_pow_limbs13, 32, 0, a, out, e_words, nbits, batch, R,
                    stream);
}
"""

SUFFIX_VARIANTS = ("perm2", "deep", "cs", "nopipe", "rows", "rows_nopipe", "b32", "split2", "split4",
                   "limbs13")
POW_VARIANTS = ("bin", "bin_sym", "win_mul", "win_sym", "bin_128", "bin_sym_128", "win_mul_128",
                "win_sym_128", "limbs13")


def build(nvcc: str) -> ctypes.CDLL:
    """Compile the variants into one library; prints each kernel's ptxas
    registers, frame and spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "variants.cu"
    src.write_text(SOURCE)
    so = OUT / "libvariants.so"
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variants:\n{r.stderr}")
    lines = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(lines):
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            stats = " ".join(x.strip() for x in lines[i + 1:i + 4] if "ptxas info    : Compiling" not in x)
            print(f"ptxas {m.group(1)}: {stats}", flush=True)
    lib = ctypes.CDLL(str(so))
    for name in SUFFIX_VARIANTS:  # BN254 only: the kept entry's signature less its curve index
        fn = getattr(lib, f"sfx_{name}")
        fn.argtypes, fn.restype = _build.SIGNATURES["msm_pair_suffix"][:-2] + [ctypes.c_void_p], ctypes.c_int
    for name in POW_VARIANTS:
        fn = getattr(lib, f"pow_{name}")
        fn.argtypes, fn.restype = _build.SIGNATURES["msm_mont_pow"][:-2] + [ctypes.c_void_p], ctypes.c_int
    return lib


def stream_case(n_log2: int, R: int | None = None) -> list:
    """pair_suffix's inputs in the compressed 2^n MSM's first launch, its
    lanes R (default: the geometry rule's): (cfg, packed table, perm,
    flags [G, C, R]) on the card."""
    cfg = MsmConfig(curve=BN254, compress=True)
    n = 1 << n_log2
    geo = pick_geometry(n, cfg)
    G = min(geo.subtask_batch, cfg.num_subtasks)
    _, pts, ks = cs.sample_msm(n)
    x, y, s = (torch.from_numpy(a).cuda() for a in common.pad_inputs(pts, ks, cfg))
    packed = common.prepare_points(cfg, x, y)
    keys, signs = decompose_signed(s, cfg.chunk_size, cfg.num_subtasks)
    pv, sbit = scan.sort_payload(keys[:G], signs[:G])
    perm, flags = scan._decode_payload_step_major(pv, sbit, R or geo.num_rows)
    return [cfg, packed, perm, flags]


def _timed_rounds(cases: dict, names: list, launch, rounds: int) -> dict:
    """{(label, name): [ms per round]}; each variant's output must equal the
    kept kernel's."""
    times: dict = {}
    for rnd in range(rounds):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for label, (args, want, reps) in cases.items():
            for name in order:
                out = torch.zeros_like(want)
                run = launch(name, args, out)
                _, ms = cs._kernel_ms(run, reps)
                if not torch.equal(out, want):
                    raise AssertionError(f"variant {name} differs from the kernel at {label}")
                times.setdefault((label, name), []).append(ms)
                print(f"round {rnd} {label} {name}: {ms:.4f} ms", flush=True)
    return times


def _medians(times: dict, cases: dict, names: list, what: str) -> None:
    for label in cases:
        base = statistics.median(times[(label, "kernel")])
        for name in names:
            med = statistics.median(times[(label, name)])
            print(f"median {what} {label} {name:12s} {med:.4f} ms  ({med / base:.3f} x kernel)", flush=True)


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
    lib = _build.load()
    vlib = build(_build.find_nvcc())
    kern = cs._kernels()
    stream = torch.cuda.current_stream

    def suffix_launch(name, a, out):
        fn = lib.msm_pair_suffix if name == "kernel" else getattr(vlib, f"sfx_{name}")
        _cfg, packed, perm, flags = a
        G, C, R = perm.shape

        curve = (0,) if name == "kernel" else ()  # the kept kernel's entry takes BN254's index

        def run():
            err = fn(packed.data_ptr(), perm.data_ptr(), flags.data_ptr(), out.data_ptr(), G, C // 2, R,
                     *curve, stream().cuda_stream)
            if err:
                raise RuntimeError(f"suffix variant {name}: CUDA error {err}")
        return run

    e = BN254.modulus - 2
    e_words = (ctypes.c_uint32 * 8)(*((e >> (32 * i)) & 0xFFFFFFFF for i in range(8)))

    def pow_launch(name, a, out):
        fn = lib.msm_mont_pow if name == "kernel" else getattr(vlib, f"pow_{name}")
        lanes = a[1]
        G, _, R = lanes.shape

        curve = (0,) if name == "kernel" else ()

        def run():
            err = fn(lanes.data_ptr(), out.data_ptr(), ctypes.addressof(e_words), e.bit_length(), G, R,
                     *curve, stream().cuda_stream)
            if err:
                raise RuntimeError(f"pow variant {name}: CUDA error {err}")
        return run

    suffix_cases, pow_cases = {}, {}
    for n_log2, reps in ((20, 5), (16, 10)):
        a = stream_case(n_log2)
        cfg, perm = a[0], a[2]
        G, C, R = perm.shape
        label = f"2^{n_log2} G{G} C{C} R{R}"
        cs._check_case(kern, get_field_ctx(cfg), cfg.num_words, "pair_suffix", label, a, False, 3, clock_hz)
        suffix_cases[label] = (a, pair_suffix(*a), reps)
    for R in (1024, 2048, 4096):
        a = stream_case(20, R)
        cfg = a[0]
        lanes = pair_suffix(*a)[:, 0].contiguous()
        pa = [cfg, lanes, e]
        label = f"{lanes.shape[0]} x {R} lanes"
        cs._check_case(kern, get_field_ctx(cfg), cfg.num_words, "mont_pow", label, pa, False, 3, clock_hz)
        pow_cases[label] = (pa, mont_pow(*pa), 5)
        del a
    names = ["kernel", *SUFFIX_VARIANTS]
    times = _timed_rounds(suffix_cases, names, suffix_launch, args.rounds)
    _medians(times, suffix_cases, names, "pair_suffix")
    names = ["kernel", *POW_VARIANTS]
    times = _timed_rounds(pow_cases, names, pow_launch, args.rounds)
    _medians(times, pow_cases, names, "mont_pow")
    return 0


if __name__ == "__main__":
    sys.exit(main())
