// Batched-affine pair compression of the sorted stream: the four pair
// kernels, one thread per (subtask, lane) chain. The per-lane bodies and the
// shared pair algebra are in pair.cuh.
//
// Replaces, in msm_tpu/ops/pallas_compress.py: make_pair_suffix (pallas_call
// at :427), make_emit_scan (:561), make_pair_forward (:205) and
// make_pair_backward (:333), together with the sorted-order gather that fed
// them (msm_tpu/ops/scan.py:349): each kernel gathers its own packed rows.
// The TPU walked the chain along a sequential grid axis with the running
// value in VMEM scratch; here a thread walks its lane's Cp pairs with the
// running value in registers.
//
// Bound: dependent Montgomery products per pair, in series along the chain
// (suffix and forward 1, backward 6, emit+scan 6 + the 11 of the mixed add),
// plus two 64 B random gathers per pair. Compressed geometry has few lanes
// (R = 1024 at 2^20, so 4 x 1024 threads per launch), so the kernels are
// latency-bound rather than throughput-bound: blocks are one warp wide to put
// the chains on as many of the 132 SMs as possible.
#include <cuda_runtime.h>

#include "pair.cuh"

using namespace msm;

constexpr int THREADS = 32;

// Thread (blockIdx.y, r) walks the chain of subtask blockIdx.y, lane r.
__device__ __forceinline__ int lane() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(THREADS)
    k_pair_suffix(const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ flags, int32_t* __restrict__ s,
                  int Cp, int R) {
  const int r = lane();
  if (r < R) pair_suffix_lane(packed, perm, flags, s, blockIdx.y, Cp, R, r);
}

__global__ void __launch_bounds__(THREADS)
    k_emit_scan(const int32_t* __restrict__ packed,
                const int32_t* __restrict__ perm,
                const int32_t* __restrict__ flags,
                const int32_t* __restrict__ s, const int32_t* __restrict__ t0,
                int32_t* __restrict__ pe3, int32_t* __restrict__ tx,
                int32_t* __restrict__ ty, int32_t* __restrict__ tz, int Cp,
                int R) {
  const int r = lane();
  if (r < R)
    emit_scan_lane(packed, perm, flags, s, t0, pe3, tx, ty, tz, blockIdx.y, Cp,
                   R, r);
}

__global__ void __launch_bounds__(THREADS)
    k_pair_forward(const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ flags, int32_t* __restrict__ m,
                   int Cp, int R) {
  const int r = lane();
  if (r < R) pair_forward_lane(packed, perm, flags, m, blockIdx.y, Cp, R, r);
}

__global__ void __launch_bounds__(THREADS)
    k_pair_backward(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ flags,
                    const int32_t* __restrict__ m,
                    const int32_t* __restrict__ minv,
                    int32_t* __restrict__ cx, int32_t* __restrict__ cy,
                    int32_t* __restrict__ inf, int Cp, int R) {
  const int r = lane();
  if (r < R)
    pair_backward_lane(packed, perm, flags, m, minv, cx, cy, inf, blockIdx.y, Cp,
                       R, r);
}

static dim3 lane_grid(int64_t groups, int R) {
  return dim3((unsigned)((R + THREADS - 1) / THREADS), (unsigned)groups);
}

// packed [N, 2D]; perm, flags [G, 2 Cp, R]; s [G, Cp, L, R]
extern "C" int msm_pair_suffix(const int32_t* packed, const int32_t* perm,
                               const int32_t* flags, int32_t* s,
                               int64_t groups, int Cp, int R, void* stream) {
  if (groups > 0 && R > 0 && Cp > 0)
    k_pair_suffix<<<lane_grid(groups, R), THREADS, 0, (cudaStream_t)stream>>>(
        packed, perm, flags, s, Cp, R);
  return (int)cudaGetLastError();
}

// ... s [G, Cp, L, R] canonical; t0 [G, L, R]; pe3 [G, Cp, R, 3L];
// t* [G, L, R]
extern "C" int msm_emit_scan(const int32_t* packed, const int32_t* perm,
                             const int32_t* flags, const int32_t* s,
                             const int32_t* t0, int32_t* pe3, int32_t* tx,
                             int32_t* ty, int32_t* tz, int64_t groups, int Cp,
                             int R, void* stream) {
  if (groups > 0 && R > 0 && Cp > 0)
    k_emit_scan<<<lane_grid(groups, R), THREADS, 0, (cudaStream_t)stream>>>(
        packed, perm, flags, s, t0, pe3, tx, ty, tz, Cp, R);
  return (int)cudaGetLastError();
}

// ... m [G, Cp, L, R]
extern "C" int msm_pair_forward(const int32_t* packed, const int32_t* perm,
                                const int32_t* flags, int32_t* m,
                                int64_t groups, int Cp, int R, void* stream) {
  if (groups > 0 && R > 0 && Cp > 0)
    k_pair_forward<<<lane_grid(groups, R), THREADS, 0, (cudaStream_t)stream>>>(
        packed, perm, flags, m, Cp, R);
  return (int)cudaGetLastError();
}

// ... m [G, Cp, L, R] canonical; minv [G, L, R]; cx, cy [G, Cp, L, R];
// inf [G, Cp, R]
extern "C" int msm_pair_backward(const int32_t* packed, const int32_t* perm,
                                 const int32_t* flags, const int32_t* m,
                                 const int32_t* minv, int32_t* cx, int32_t* cy,
                                 int32_t* inf, int64_t groups, int Cp, int R,
                                 void* stream) {
  if (groups > 0 && R > 0 && Cp > 0)
    k_pair_backward<<<lane_grid(groups, R), THREADS, 0,
                      (cudaStream_t)stream>>>(packed, perm, flags, m, minv, cx,
                                              cy, inf, Cp, R);
  return (int)cudaGetLastError();
}
