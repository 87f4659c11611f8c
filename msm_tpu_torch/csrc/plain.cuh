// The plain path's kernels and their launches, generic over the field: the
// point add (kernel 1), the convert (2, and its GLV mode), the scan (4, and
// its GLV mode), the row offsets (5), the point total (6) and the Horner
// ladder (7). nvcc only: the bodies they run are in the headers named below,
// which the host tests build with g++. Each launch is a class template
// LAUNCH<F> with one static run(...); BN254's is instantiated in the
// kernel's own translation unit (point_add.cu ...), each other curve's in
// csrc/curve_<name>.cu (MSM_INSTANTIATE_PLAIN, MSM_INSTANTIATE_GLV),
// curve_<name>_prefix.cu (MSM_INSTANTIATE_ROW_OFFSETS) and
// curve_<name>_total.cu (MSM_INSTANTIATE_POINT_TOTAL), and the
// C entries dispatch on the curve (dispatch.cuh). The design notes of each
// kernel are in its .cu file.
#pragma once

#include <cuda_runtime.h>

#include "convert32.cuh"
#include "dispatch.cuh"
#include "horner.cuh"
#include "point_total.cuh"
#include "prefix.cuh"
#include "scan.cuh"

namespace msm {

// ---- Kernel 1, the point add (bodies: point_add.cuh) ----
constexpr int PA_THREADS = 128;

template <class F>
__global__ void __launch_bounds__(PA_THREADS, F::BLOCKS_PER_SM)
    k_point_add(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  point_add_row<F>(ax, ay, az, bx, by, bz, ox, oy, oz, i);
}

// One warp per add, PA_THREADS / 32 adds per block.
template <class F>
__global__ void __launch_bounds__(PA_THREADS)
    k_point_add_lanes(const int32_t* __restrict__ ax,
                      const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ az,
                      const int32_t* __restrict__ bx,
                      const int32_t* __restrict__ by,
                      const int32_t* __restrict__ bz, int32_t* __restrict__ ox,
                      int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                      int64_t n) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (i >= n) return;  // whole warps: the lanes' shuffles need all 32
  point_add_row_lanes<F>(ax, ay, az, bx, by, bz, ox, oy, oz, i);
}

template <class F>
struct PointAddLaunch {
  static int run(const int32_t* ax, const int32_t* ay, const int32_t* az,
                 const int32_t* bx, const int32_t* by, const int32_t* bz,
                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, int lanes,
                 int width, cudaStream_t st);
};

// Every pointer [n, L], rows_aligned<F> (row_align<L>; a word in the narrow
// build); lanes != 0: a warp per add.
template <class F>
int PointAddLaunch<F>::run(const int32_t* ax, const int32_t* ay,
                           const int32_t* az, const int32_t* bx,
                           const int32_t* by, const int32_t* bz, int32_t* ox,
                           int32_t* oy, int32_t* oz, int64_t n, int lanes,
                           int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  const uintptr_t addr = (uintptr_t)ax | (uintptr_t)ay | (uintptr_t)az |
                         (uintptr_t)bx | (uintptr_t)by | (uintptr_t)bz |
                         (uintptr_t)ox | (uintptr_t)oy | (uintptr_t)oz;
  if (!rows_aligned<F>(addr)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (lanes) {
      const int64_t blocks = (n * 32 + PA_THREADS - 1) / PA_THREADS;
      k_point_add_lanes<F><<<(unsigned)blocks, PA_THREADS, 0, st>>>(
          ax, ay, az, bx, by, bz, ox, oy, oz, n);
    } else {
      const int64_t blocks = (n + PA_THREADS - 1) / PA_THREADS;
      k_point_add<F><<<(unsigned)blocks, PA_THREADS, 0, st>>>(
          ax, ay, az, bx, by, bz, ox, oy, oz, n);
    }
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 2, the convert, plain mode (bodies: convert32.cuh) ----
constexpr int CONVERT_THREADS = 128;

template <class F>
__global__ void __launch_bounds__(CONVERT_THREADS)
    k_convert(const int16_t* __restrict__ xw, const int16_t* __restrict__ yw,
              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) convert_point<F>(xw, yw, out, i);
}

template <class F>
struct ConvertLaunch {
  static int run(const int16_t* xw, const int16_t* yw, int32_t* out, int64_t n,
                 int width, cudaStream_t st);
};

// xw, yw [n, 2 NW] int16 (u16 bits); out [n, 2 NW] int32; all 16-byte
// aligned
template <class F>
int ConvertLaunch<F>::run(const int16_t* xw, const int16_t* yw, int32_t* out,
                          int64_t n, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (((uintptr_t)xw | (uintptr_t)yw | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t blocks = (n + CONVERT_THREADS - 1) / CONVERT_THREADS;
    k_convert<F><<<(unsigned)blocks, CONVERT_THREADS, 0, st>>>(xw, yw, out, n);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 2, the convert, GLV mode (bodies: convert32.cuh) ----

template <class F>
__global__ void __launch_bounds__(CONVERT_THREADS)
    k_convert_glv(const int16_t* __restrict__ xw,
                  const int16_t* __restrict__ yw, int32_t* __restrict__ out,
                  int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) convert_point_glv<F>(xw, yw, out, i);
}

template <class F>
struct ConvertGlvLaunch {
  static int run(const int16_t* xw, const int16_t* yw, int32_t* out, int64_t n,
                 int width, cudaStream_t st);
};

// xw, yw [n, 2 NW] int16 (u16 bits); out [n, 3 NW] int32 (rows x R,
// beta x R, y R); all 16-byte aligned
template <class F>
int ConvertGlvLaunch<F>::run(const int16_t* xw, const int16_t* yw,
                             int32_t* out, int64_t n, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (((uintptr_t)xw | (uintptr_t)yw | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t blocks = (n + CONVERT_THREADS - 1) / CONVERT_THREADS;
    k_convert_glv<F><<<(unsigned)blocks, CONVERT_THREADS, 0, st>>>(xw, yw, out,
                                                                  n);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 4, the scan, plain mode (bodies: scan.cuh) ----
constexpr int SCAN_THREADS = 128;

template <class F>
__global__ void __launch_bounds__(SCAN_THREADS, F::BLOCKS_PER_SM)
    k_scan(const int32_t* __restrict__ packed, const int32_t* __restrict__ perm,
           const int32_t* __restrict__ flags, int32_t* __restrict__ pe3,
           int32_t* __restrict__ tx, int32_t* __restrict__ ty,
           int32_t* __restrict__ tz, int C, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  scan_lane<2, F>(packed, perm, flags, pe3, tx, ty, tz, blockIdx.y, C, R, r);
}

template <class F>
struct ScanLaunch {
  static int run(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, int32_t* pe3, int32_t* tx, int32_t* ty,
                 int32_t* tz, int64_t groups, int C, int R, int width, cudaStream_t st);
};

// packed [N, 2D] and pe3 [G, C, R, pe3_row<F>] 16-byte aligned; perm,
// flags [G, C, R]; t* [G, L, R]
template <class F>
int ScanLaunch<F>::run(const int32_t* packed, const int32_t* perm,
                               const int32_t* flags, int32_t* pe3, int32_t* tx,
                               int32_t* ty, int32_t* tz, int64_t groups, int C,
                               int R, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (((uintptr_t)packed | (uintptr_t)pe3) % 16)
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && R > 0) {
    const dim3 grid((unsigned)((R + SCAN_THREADS - 1) / SCAN_THREADS),
                    (unsigned)groups);
    k_scan<F><<<grid, SCAN_THREADS, 0, st>>>(packed, perm, flags, pe3,
                                                     tx, ty, tz, C, R);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 4, the scan, GLV mode (bodies: scan.cuh, COORDS = 3) ----

template <class F>
__global__ void __launch_bounds__(SCAN_THREADS, F::BLOCKS_PER_SM)
    k_scan_glv(const int32_t* __restrict__ packed,
               const int32_t* __restrict__ perm,
               const int32_t* __restrict__ flags, int32_t* __restrict__ pe3,
               int32_t* __restrict__ tx, int32_t* __restrict__ ty,
               int32_t* __restrict__ tz, int C, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  scan_lane<3, F>(packed, perm, flags, pe3, tx, ty, tz, blockIdx.y, C, R, r);
}

template <class F>
struct ScanGlvLaunch {
  static int run(const int32_t* packed, const int32_t* perm,
                 const int32_t* flags, int32_t* pe3, int32_t* tx, int32_t* ty,
                 int32_t* tz, int64_t groups, int C, int R, int width, cudaStream_t st);
};

// packed [N, 3D] (the GLV table) and pe3 [G, C, R, pe3_row<F>] 16-byte
// aligned; the rest as ScanLaunch
template <class F>
int ScanGlvLaunch<F>::run(const int32_t* packed, const int32_t* perm,
                          const int32_t* flags, int32_t* pe3, int32_t* tx,
                          int32_t* ty, int32_t* tz, int64_t groups, int C,
                          int R, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (((uintptr_t)packed | (uintptr_t)pe3) % 16)
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && R > 0) {
    const dim3 grid((unsigned)((R + SCAN_THREADS - 1) / SCAN_THREADS),
                    (unsigned)groups);
    k_scan_glv<F><<<grid, SCAN_THREADS, 0, st>>>(packed, perm, flags, pe3, tx,
                                                 ty, tz, C, R);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 5, the row offsets (bodies: prefix.cuh) ----
constexpr int RO_BLOCK = 128;  // ops/cuda_prefix.py THREADS

// Hillis-Steele inclusive scan over the block's T points: on return s is
// the sum of threads 0..t and sp[t] holds it, for every t.
template <class F>
__device__ __forceinline__ void block_inclusive_scan(pt32t<F>* sp, pt32t<F>& s,
                                                     int t, int T) {
  sp[t] = s;
  __syncthreads();
  MSM_ROLLED
  for (int k = 1; k < T; k <<= 1) {
    pt32t<F> v;
    if (t >= k) v = sp[t - k];
    __syncthreads();
    if (t >= k) {
      pt32_add(s, v, s);
      sp[t] = s;
    }
    __syncthreads();
  }
}

// 1. k_ro_totals: each thread sums its K lanes, the block scans the sums
//    in shared memory, each thread writes its exclusive in-block prefix to
//    its first lane's output row, and the block writes its total to the
//    scratch s* [G, nb, L].
template <class F>
__global__ void __launch_bounds__(RO_BLOCK)
    k_ro_totals(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
                int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                int32_t* __restrict__ sx, int32_t* __restrict__ sy,
                int32_t* __restrict__ sz, int R, int K) {
  __shared__ pt32t<F> sp[RO_BLOCK];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int64_t r0 = (b * RO_BLOCK + t) * K;
  pt32t<F> s;
  if (r0 < R)
    ro_thread_total(s, tx, ty, tz, g, R, (int)r0, K);
  else
    pt32_identity(s);
  block_inclusive_scan(sp, s, t, RO_BLOCK);
  if (r0 < R) {
    pt32t<F> e;
    if (t > 0)
      e = sp[t - 1];
    else
      pt32_identity(e);
    const int64_t o = (g * R + r0) * limb_count<F>();
    pt32_store_limbs(ox + o, oy + o, oz + o, 1, e);
  }
  if (t == RO_BLOCK - 1) {
    const int64_t o = (g * nb + b) * limb_count<F>();
    pt32_store_limbs(sx + o, sy + o, sz + o, 1, s);
  }
}

// 2. k_ro_blocks: one block of T threads per subtask; thread t owns m =
//    ceil(nb / T) consecutive block totals of s* [G, nb, L]: sum, scan,
//    re-accumulate, in place.
template <class F>
__global__ void __launch_bounds__(RO_BLOCK)
    k_ro_blocks(int32_t* sx, int32_t* sy, int32_t* sz, int nb) {
  __shared__ pt32t<F> sp[RO_BLOCK];
  const int T = blockDim.x, t = threadIdx.x;
  const int64_t g = blockIdx.x;
  const int m = (nb + T - 1) / T;
  pt32t<F> s, v;
  pt32_identity(s);
  MSM_ROLLED
  for (int c = 0; c < m && t * m + c < nb; ++c) {
    const int64_t o = (g * nb + t * m + c) * limb_count<F>();
    pt32_load_canonical(v, sx + o, sy + o, sz + o);
    if (c == 0)
      s = v;
    else
      pt32_add(s, s, v);
  }
  block_inclusive_scan(sp, s, t, T);
  pt32t<F> acc;
  if (t > 0)
    acc = sp[t - 1];
  else
    pt32_identity(acc);
  MSM_ROLLED
  for (int c = 0; c < m && t * m + c < nb; ++c) {
    const int64_t o = (g * nb + t * m + c) * limb_count<F>();
    pt32_load_canonical(v, sx + o, sy + o, sz + o);
    pt32_store_limbs(sx + o, sy + o, sz + o, 1, acc);
    if (c + 1 < m) pt32_add(acc, acc, v);
  }
}

// 3. k_ro_write: each thread adds its block offset to its in-block prefix
//    and writes the prefix of every one of its lanes.
template <class F>
__global__ void __launch_bounds__(RO_BLOCK)
    k_ro_write(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
               const int32_t* __restrict__ tz, int32_t* ox, int32_t* oy,
               int32_t* oz, const int32_t* __restrict__ sx,
               const int32_t* __restrict__ sy, const int32_t* __restrict__ sz,
               int R, int K) {
  const int t = threadIdx.x;
  const int64_t g = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int64_t r0 = (b * RO_BLOCK + t) * K;
  if (r0 >= R) return;
  pt32t<F> off, pre, acc;
  int64_t o = (g * nb + b) * limb_count<F>();
  pt32_load_canonical(off, sx + o, sy + o, sz + o);
  o = (g * R + r0) * limb_count<F>();
  pt32_load_canonical(pre, ox + o, oy + o, oz + o);
  pt32_add(acc, off, pre);
  ro_thread_write(acc, tx, ty, tz, ox, oy, oz, g, R, (int)r0, K);
}

template <class F>
struct RowOffsetsLaunch {
  static int run(const int32_t* tx, const int32_t* ty, const int32_t* tz,
                 int32_t* ox, int32_t* oy, int32_t* oz, int32_t* sx,
                 int32_t* sy, int32_t* sz, int64_t groups, int R, int K,
                 int nb, int scan_threads, int width, cudaStream_t st);
};

// Three launches on the stream. Inputs t* [G, L, R] limbs-first; outputs
// o* [G, R, L]; scratch s* [G, nb, L]. The plan: K lanes per thread (1, 2,
// 4 or 8), nb blocks of RO_BLOCK threads per subtask covering the R lanes,
// scan_threads threads for the block offsets.
template <class F>
int RowOffsetsLaunch<F>::run(const int32_t* tx, const int32_t* ty,
                             const int32_t* tz, int32_t* ox, int32_t* oy,
                             int32_t* oz, int32_t* sx, int32_t* sy,
                             int32_t* sz, int64_t groups, int R, int K, int nb,
                             int scan_threads, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (groups > 0 && R > 0) {
    const int64_t span = (int64_t)RO_BLOCK * K;
    if ((K != 1 && K != 2 && K != 4 && K != 8) || R % K != 0 || nb < 1 ||
        nb * span < R || (nb - 1) * span >= R || scan_threads < 1 ||
        scan_threads > RO_BLOCK)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)nb, (unsigned)groups);
    k_ro_totals<F><<<grid, RO_BLOCK, 0, st>>>(tx, ty, tz, ox, oy, oz, sx, sy,
                                              sz, R, K);
    int err = (int)cudaGetLastError();
    if (err) return err;
    k_ro_blocks<F><<<(unsigned)groups, scan_threads, 0, st>>>(sx, sy, sz, nb);
    err = (int)cudaGetLastError();
    if (err) return err;
    k_ro_write<F><<<grid, RO_BLOCK, 0, st>>>(tx, ty, tz, ox, oy, oz, sx, sy,
                                             sz, R, K);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 6, the point total (bodies: point_total.cuh) ----
constexpr int PT_BLOCK = 128;  // ops/cuda_prefix.py THREADS

template <class F>
__device__ __forceinline__ void fe32_shfl_down(fe32t<F>& o, const fe32t<F>& a,
                                               int off) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) o.w[i] = __shfl_down_sync(0xffffffffu, a.w[i], off);
}

// The halving tree over lanes 0 .. width - 1 of the warp (width a power of
// two, at most 32): at offset h lane l adds lane l + h's sum to its own, and
// lane 0 ends with the sum of the width lanes.
template <class F>
__device__ __forceinline__ void pt32_lanes_sum(pt32t<F>& s, int width) {
  MSM_ROLLED
  for (int h = width / 2; h > 0; h >>= 1) {
    pt32t<F> o;
    fe32_shfl_down(o.x, s.x, h);
    fe32_shfl_down(o.y, s.y, h);
    fe32_shfl_down(o.z, s.z, h);
    pt32_add(s, s, o);
  }
}

template <class F>
__global__ void __launch_bounds__(PT_BLOCK, F::BLOCKS_PER_SM)
    k_point_total(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz, uint32_t* __restrict__ part,
                  int64_t N, int k) {
  __shared__ pt32t<F> sw[PT_BLOCK / 2];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x, nb = gridDim.x, g = blockIdx.y;
  pt32t<F> s;
  pt_total_run(s, px, py, pz, g, N, k, b * PT_BLOCK + t);
  // the upper half of the live warps hands its sums to the lower half
  MSM_ROLLED
  for (int h = PT_BLOCK / 2; h >= 32; h >>= 1) {
    if (t >= h && t < 2 * h) sw[t - h] = s;
    __syncthreads();
    if (t < h) pt32_add(s, s, sw[t]);
    __syncthreads();
  }
  if (t >= 32) return;
  pt32_lanes_sum(s, 32);
  if (t == 0) pt32_store_words(part + (g * nb + b) * pt_words<F>, s);
}

template <class F>
__global__ void __launch_bounds__(32)
    k_point_total_finish(const uint32_t* __restrict__ part,
                         int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz, int nb) {
  const int lane = threadIdx.x;
  const int64_t g = blockIdx.x, o = g * limb_count<F>();
  pt32t<F> s;
  pt_total_partials(s, part, g, nb, lane, 32);
  int width = 1;  // lanes holding a partial, rounded up to a power of two
  while (width < nb && width < 32) width <<= 1;
  pt32_lanes_sum(s, width);
  if (lane == 0) pt32_store_limbs(ox + o, oy + o, oz + o, 1, s);
}

template <class F>
struct PointTotalLaunch {
  static int run(const int32_t* px, const int32_t* py, const int32_t* pz,
                 uint32_t* part, int32_t* ox, int32_t* oy, int32_t* oz,
                 int64_t groups, int64_t N, int k, int nb, int width, cudaStream_t st);
};

// p* [G, N, L], aligned as the rows' vector loads need (16 bytes at
// L = 20); part [G, nb, pt_words<F>] scratch; o* [G, L]. The plan: k
// points per thread, nb blocks of PT_BLOCK threads per subtask covering
// the N points (nb = 1 when N = 0).
template <class F>
int PointTotalLaunch<F>::run(const int32_t* px, const int32_t* py,
                             const int32_t* pz, uint32_t* part, int32_t* ox,
                             int32_t* oy, int32_t* oz, int64_t groups,
                             int64_t N, int k, int nb, int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  if (groups > 0) {
    const uintptr_t addr = (uintptr_t)px | (uintptr_t)py | (uintptr_t)pz;
    const int64_t span = (int64_t)PT_BLOCK * k;
    if (!rows_aligned<F>(addr) || k < 1 || nb < 1 || nb * span < N ||
        (nb - 1) * span >= (N > 0 ? N : 1))
      return (int)cudaErrorInvalidValue;
    k_point_total<F><<<dim3((unsigned)nb, (unsigned)groups), PT_BLOCK, 0, st>>>(
        px, py, pz, part, N, k);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    k_point_total_finish<F><<<(unsigned)groups, 32, 0, st>>>(part, ox, oy, oz, nb);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 7, the Horner ladder (bodies: horner.cuh) ----
constexpr int HORNER_WARP = 32;
constexpr size_t HORNER_SMEM_LIMIT = 48 * 1024;  // static shared memory of a block

template <class F>
__global__ void __launch_bounds__(HORNER_WARP)
    k_horner(const int32_t* __restrict__ wx, const int32_t* __restrict__ wy,
             const int32_t* __restrict__ wz, int32_t* __restrict__ ox,
             int32_t* __restrict__ oy, int32_t* __restrict__ oz, int S,
             int chunk) {
  extern __shared__ __align__(16) unsigned char horner_smem[];
  pt32t<F>* sw = reinterpret_cast<pt32t<F>*>(horner_smem);  // [S]
  const int64_t g = blockIdx.x, i = g * S * limb_count<F>(), o = g * limb_count<F>();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    horner_load(sw[s], wx + i, wy + i, wz + i, s);
  __syncthreads();
  pt32t<F> acc;
  horner_chain(acc, sw, S, chunk);
  if (threadIdx.x == 0) pt32_store_limbs(ox + o, oy + o, oz + o, 1, acc);
}

template <class F>
struct HornerLaunch {
  static int run(const int32_t* wx, const int32_t* wy, const int32_t* wz,
                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t groups, int S,
                 int chunk, int width, cudaStream_t st);
};

// One block of one warp per ladder; its S window sums (S * sizeof(pt32t<F>))
// in shared memory.
template <class F>
int HornerLaunch<F>::run(const int32_t* wx, const int32_t* wy,
                         const int32_t* wz, int32_t* ox, int32_t* oy,
                         int32_t* oz, int64_t groups, int S, int chunk,
                         int width, cudaStream_t st) {
  WidthScope<F> scope(width, st);
  if (scope.err) return scope.err;
  const size_t smem = (size_t)S * sizeof(pt32t<F>);
  if (smem > HORNER_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (groups > 0 && S > 0) {
    k_horner<F><<<(unsigned)groups, HORNER_WARP, smem, st>>>(wx, wy, wz, ox, oy,
                                                             oz, S, chunk);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
