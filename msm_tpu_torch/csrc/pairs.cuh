// The compressed path's kernels and their launches, generic over the field:
// the Fermat inversion (kernel 9, k_mont_pow), the suffix products (12,
// k_pair_suffix), the fused pair emission + scan (13, k_emit_scan), and
// compress_pairs' forward products (10, k_pair_forward) and backward
// emission (11, k_pair_backward); 10-13 also in their GLV modes (*_glv: the
// bodies at COORDS = 3). nvcc only: the bodies are pow32.cuh, pair32.cuh
// and emit_scan.cuh, which the host tests build with g++. Each launch is a
// class template LAUNCH<F> with one static run(...); BN254's is
// instantiated in inv.cu and compress.cu, each other curve's in
// csrc/curve_<name>_pairs.cu (MSM_INSTANTIATE_PAIRS), and the C entries
// dispatch on the curve (dispatch.cuh). The design notes are in inv.cu and
// compress.cu.
//
// Every kernel runs with __launch_bounds__(THREADS, F::BLOCKS_PER_SM) but
// kernel 9 (64 threads, its exponent table in shared memory: POW_TABLE x
// NW words a thread, 30 KiB a block at 8 words, 45 KiB at 12).
#pragma once

#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "emit_scan.cuh"
#include "pow32.cuh"

namespace msm {

// ---- Kernel 9, the Fermat inversion (body: pow32.cuh) ----
constexpr int POW_EXP_WORDS = 32;  // exponents of up to 1024 bits
constexpr int POW_THREADS = 64;

struct pow_exp_words {
  uint32_t w[POW_EXP_WORDS];
};

template <class F>
__global__ void __launch_bounds__(POW_THREADS)
    k_mont_pow(const int32_t* __restrict__ a, int32_t* __restrict__ out,
               const pow_exp_words e, int nbits, int R) {
  constexpr int TABLE_WORDS = POW_TABLE * F::NW * POW_THREADS;
  __shared__ uint32_t ew[POW_EXP_WORDS];
  __shared__ uint32_t tab[TABLE_WORDS];
  if (threadIdx.x == 0) {
    MSM_UNROLL
    for (int i = 0; i < POW_EXP_WORDS; ++i) ew[i] = e.w[i];
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t o = (int64_t)blockIdx.y * limb_count<F>() * R + r;
  fe32t<F> x, y;
  if constexpr (F::RT) {
    fe32_load_balanced_rt(x, a + o, R);
  } else {
    int32_t v[F::L];
    MSM_UNROLL
    for (int i = 0; i < F::L; ++i) v[i] = a[o + i * (int64_t)R];
    fe32_from_balanced(x, v);
  }
  pow32_window(y, x, ew, nbits, tab + threadIdx.x, POW_THREADS);
  fe32_store_limbs_strided(out + o, R, y);
}

template <class F>
struct PowLaunch {
  static int run(const int32_t* a, int32_t* out, const pow_exp_words& e,
                 int nbits, int64_t batch, int R, int width, cudaStream_t st);
};

// a, out [B, L, R] (limbs-first; a balanced, out canonical)
template <class F>
int PowLaunch<F>::run(const int32_t* a, int32_t* out, const pow_exp_words& e,
                      int nbits, int64_t batch, int R, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (batch > 0 && R > 0) {
    const dim3 grid((unsigned)((R + POW_THREADS - 1) / POW_THREADS),
                    (unsigned)batch);
    k_mont_pow<F><<<grid, POW_THREADS, 0, st>>>(a, out, e, nbits, R);
  }
  return (int)cudaGetLastError();
}

// ---- Kernels 10-13, and their GLV modes (bodies: pair32.cuh,
// emit_scan.cuh) ----
constexpr int PAIR_THREADS = 128;

// Thread (blockIdx.y, r) walks the chain of subtask blockIdx.y, lane r.
__device__ __forceinline__ int pair_lane() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

inline dim3 pair_grid(int64_t groups, int R) {
  return dim3((unsigned)((R + PAIR_THREADS - 1) / PAIR_THREADS),
              (unsigned)groups);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_pair_suffix(const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ flags, int32_t* __restrict__ s,
                  int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    pair_chain32_lane<2, false, F>(packed, perm, flags, s, blockIdx.y, Cp, R,
                                   r);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_pair_suffix_glv(const int32_t* __restrict__ packed,
                      const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ flags,
                      int32_t* __restrict__ s, int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    pair_chain32_lane<3, false, F>(packed, perm, flags, s, blockIdx.y, Cp, R,
                                   r);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_emit_scan(const int32_t* __restrict__ packed,
                const int32_t* __restrict__ perm,
                const int32_t* __restrict__ flags,
                const int32_t* __restrict__ s, const int32_t* __restrict__ t0,
                int32_t* __restrict__ pe3, int32_t* __restrict__ tx,
                int32_t* __restrict__ ty, int32_t* __restrict__ tz, int Cp,
                int R) {
  const int r = pair_lane();
  if (r < R)
    emit_scan_lane<2, F>(packed, perm, flags, s, t0, pe3, tx, ty, tz,
                         blockIdx.y, Cp, R, r);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_emit_scan_glv(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ flags,
                    const int32_t* __restrict__ s,
                    const int32_t* __restrict__ t0, int32_t* __restrict__ pe3,
                    int32_t* __restrict__ tx, int32_t* __restrict__ ty,
                    int32_t* __restrict__ tz, int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    emit_scan_lane<3, F>(packed, perm, flags, s, t0, pe3, tx, ty, tz,
                         blockIdx.y, Cp, R, r);
}

// Kernel 12 in the table's row layout `coords` (2, or 3 under GLV).
template <class F>
struct PairSuffixLaunch {
  static int run(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, int32_t* s, int64_t groups, int Cp,
                 int R, int coords, int width, cudaStream_t st);
};

// packed [N, coords NW] 16-byte aligned; perm, flags [G, 2 Cp, R];
// s [G, Cp, L, R]
template <class F>
int PairSuffixLaunch<F>::run(const int32_t* packed, const int32_t* perm,
                             const int32_t* flags, int32_t* s, int64_t groups,
                             int Cp, int R, int coords, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if ((uintptr_t)packed % 16 || (coords != 2 && coords != 3))
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && R > 0 && Cp > 0) {
    if (coords == 2)
      k_pair_suffix<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, s, Cp, R);
    else
      k_pair_suffix_glv<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, s, Cp, R);
  }
  return (int)cudaGetLastError();
}

// Kernel 13 in the table's row layout `coords` (2, or 3 under GLV).
template <class F>
struct EmitScanLaunch {
  static int run(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, const int32_t* s, const int32_t* t0,
                 int32_t* pe3, int32_t* tx, int32_t* ty, int32_t* tz,
                 int64_t groups, int Cp, int R, int coords, int width, cudaStream_t st);
};

// ... s [G, Cp, L, R] canonical; t0 [G, L, R]; pe3 [G, Cp, R, pe3_row<F>];
// t* [G, L, R]; packed and pe3 16-byte aligned
template <class F>
int EmitScanLaunch<F>::run(const int32_t* packed, const int32_t* perm,
                           const int32_t* flags, const int32_t* s,
                           const int32_t* t0, int32_t* pe3, int32_t* tx,
                           int32_t* ty, int32_t* tz, int64_t groups, int Cp,
                           int R, int coords, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (((uintptr_t)packed | (uintptr_t)pe3) % 16 || (coords != 2 && coords != 3))
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && R > 0 && Cp > 0) {
    if (coords == 2)
      k_emit_scan<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, s, t0, pe3, tx, ty, tz, Cp, R);
    else
      k_emit_scan_glv<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, s, t0, pe3, tx, ty, tz, Cp, R);
  }
  return (int)cudaGetLastError();
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_pair_forward(const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ flags, int32_t* __restrict__ m,
                   int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    pair_chain32_lane<2, true, F>(packed, perm, flags, m, blockIdx.y, Cp, R,
                                  r);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_pair_forward_glv(const int32_t* __restrict__ packed,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ flags,
                       int32_t* __restrict__ m, int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    pair_chain32_lane<3, true, F>(packed, perm, flags, m, blockIdx.y, Cp, R,
                                  r);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_pair_backward(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ flags,
                    const int32_t* __restrict__ m,
                    const int32_t* __restrict__ minv,
                    int32_t* __restrict__ cx, int32_t* __restrict__ cy,
                    int32_t* __restrict__ inf, int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    pair_backward32_lane<2, F>(packed, perm, flags, m, minv, cx, cy, inf,
                               blockIdx.y, Cp, R, r);
}

template <class F>
__global__ void __launch_bounds__(PAIR_THREADS, F::BLOCKS_PER_SM)
    k_pair_backward_glv(const int32_t* __restrict__ packed,
                        const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ flags,
                        const int32_t* __restrict__ m,
                        const int32_t* __restrict__ minv,
                        int32_t* __restrict__ cx, int32_t* __restrict__ cy,
                        int32_t* __restrict__ inf, int Cp, int R) {
  const int r = pair_lane();
  if (r < R)
    pair_backward32_lane<3, F>(packed, perm, flags, m, minv, cx, cy, inf,
                               blockIdx.y, Cp, R, r);
}

// Kernel 10 in the table's row layout `coords` (2, or 3 under GLV).
template <class F>
struct PairForwardLaunch {
  static int run(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, int32_t* m, int64_t groups, int Cp,
                 int R, int coords, int width, cudaStream_t st);
};

// packed [N, coords NW] 16-byte aligned; perm, flags [G, 2 Cp, R];
// m [G, Cp, L, R]
template <class F>
int PairForwardLaunch<F>::run(const int32_t* packed, const int32_t* perm,
                              const int32_t* flags, int32_t* m, int64_t groups,
                              int Cp, int R, int coords, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if ((uintptr_t)packed % 16 || (coords != 2 && coords != 3))
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && R > 0 && Cp > 0) {
    if (coords == 2)
      k_pair_forward<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, m, Cp, R);
    else
      k_pair_forward_glv<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, m, Cp, R);
  }
  return (int)cudaGetLastError();
}

// Kernel 11 in the table's row layout `coords` (2, or 3 under GLV).
template <class F>
struct PairBackwardLaunch {
  static int run(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, const int32_t* m, const int32_t* minv,
                 int32_t* cx, int32_t* cy, int32_t* inf, int64_t groups,
                 int Cp, int R, int coords, int width, cudaStream_t st);
};

// ... m [G, Cp, L, R] canonical; minv [G, L, R]; cx, cy [G, Cp, L, R];
// inf [G, Cp, R]; packed 16-byte aligned
template <class F>
int PairBackwardLaunch<F>::run(const int32_t* packed, const int32_t* perm,
                               const int32_t* flags, const int32_t* m,
                               const int32_t* minv, int32_t* cx, int32_t* cy,
                               int32_t* inf, int64_t groups, int Cp, int R,
                               int coords, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if ((uintptr_t)packed % 16 || (coords != 2 && coords != 3))
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && R > 0 && Cp > 0) {
    if (coords == 2)
      k_pair_backward<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, m, minv, cx, cy, inf, Cp, R);
    else
      k_pair_backward_glv<F><<<pair_grid(groups, R), PAIR_THREADS, 0, st>>>(
          packed, perm, flags, m, minv, cx, cy, inf, Cp, R);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
