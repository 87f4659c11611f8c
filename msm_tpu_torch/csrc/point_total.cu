// Sum of N points per subtask on the word core: [G, N, L] balanced limbs in,
// [G, L] canonical limbs out.
//
// Replaces: msm_tpu/ops/pallas_prefix.py::make_point_total (pallas_call at
// :231), which summed the N points in one grid-less program, 128 VMEM lanes
// wide, and folded the lanes with pltpu.roll.
//
// Bound: the complete additions (12 products of 2 x 64 word multiply-adds
// each, N - 1 per subtask) over the card's integer rate; at the 2^16 MSM's
// and the blocked tail's shapes the serial depth of the tree instead. The
// points are read once (240 B each at 13-bit limbs). The design, two
// launches:
//   1. k_point_total, grid (nb, G) of 128 threads: thread j of subtask g
//      sums its contiguous run of k points (csrc/point_total.cuh
//      pt_total_run, loads with 16-byte vectors, pt32_add inlined). The
//      block folds its 128 sums in 7 levels: warps 2-3 hand theirs to warps
//      0-1 through shared memory as 96-byte pt32s, warp 1 to warp 0, and
//      warp 0 folds its lanes with __shfl_down_sync over a pt32's 24 words.
//      Whole warps drop out of the first two levels, so a block spends 8
//      warp-wide additions on its tree where a shuffle tree in every warp
//      would spend 22 (every lane of a warp adds at every level). The
//      block writes its partial as words to part [G, nb, 24].
//   2. k_point_total_finish, one warp per subtask: lane l sums partials l,
//      l + 32, ..., and the warp folds only as many levels as the lanes
//      that hold a partial need; lane 0 writes canonical limbs.
// k and nb come from ops/cuda_prefix.point_total_plan: the fewest points
// per thread that keep G N / k threads within one wave of 4 blocks of 128
// per SM (__launch_bounds__(128, 4): at most 128 registers), so every
// shape fills the card. Serial depth: k - 1 + 7 additions, then
// ceil(nb / 32) - 1 + log2(min(nb, 32)). Each loop keeps its addition
// rolled (MSM_ROLLED): one copy of the formula per loop, not one per step.
// scripts/torch_add_total_variants.py times this against a finish by the
// last block to arrive (an atomic ticket) and against other plans
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "point_total.cuh"

using namespace msm;

constexpr int BLOCK = 128;  // ops/cuda_prefix.py THREADS

__device__ __forceinline__ void fe32_shfl_down(fe32& o, const fe32& a, int off) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) o.w[i] = __shfl_down_sync(0xffffffffu, a.w[i], off);
}

// The halving tree over lanes 0 .. width - 1 of the warp (width a power of
// two, at most 32): at offset h lane l adds lane l + h's sum to its own, and
// lane 0 ends with the sum of the width lanes.
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
                  const int32_t* __restrict__ pz, uint32_t* __restrict__ part,
                  int64_t N, int k) {
  __shared__ pt32 sw[BLOCK / 2];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x, nb = gridDim.x, g = blockIdx.y;
  pt32 s;
  pt_total_run(s, px, py, pz, g, N, k, b * BLOCK + t);
  // the upper half of the live warps hands its sums to the lower half
  MSM_ROLLED
  for (int h = BLOCK / 2; h >= 32; h >>= 1) {
    if (t >= h && t < 2 * h) sw[t - h] = s;
    __syncthreads();
    if (t < h) pt32_add(s, s, sw[t]);
    __syncthreads();
  }
  if (t >= 32) return;
  pt32_lanes_sum(s, 32);
  if (t == 0) pt32_store_words(part + (g * nb + b) * PT_WORDS, s);
}

__global__ void __launch_bounds__(32)
    k_point_total_finish(const uint32_t* __restrict__ part,
                         int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz, int nb) {
  const int lane = threadIdx.x;
  const int64_t g = blockIdx.x;
  pt32 s;
  pt_total_partials(s, part, g, nb, lane, 32);
  int width = 1;  // lanes holding a partial, rounded up to a power of two
  while (width < nb && width < 32) width <<= 1;
  pt32_lanes_sum(s, width);
  if (lane == 0) pt32_store_limbs(ox + g * L, oy + g * L, oz + g * L, 1, s);
}

// p* [G, N, L], 16-byte aligned; part [G, nb, PT_WORDS] scratch; o* [G, L].
// The plan: k points per thread, nb blocks of BLOCK threads per subtask
// covering the N points (nb = 1 when N = 0).
extern "C" int msm_point_total(const int32_t* px, const int32_t* py,
                               const int32_t* pz, uint32_t* part, int32_t* ox,
                               int32_t* oy, int32_t* oz, int64_t groups,
                               int64_t N, int k, int nb, void* stream) {
  if (groups > 0) {
    const uintptr_t addr = (uintptr_t)px | (uintptr_t)py | (uintptr_t)pz;
    const int64_t span = (int64_t)BLOCK * k;
    if (addr % 16 || k < 1 || nb < 1 || nb * span < N ||
        (nb - 1) * span >= (N > 0 ? N : 1))
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    k_point_total<<<dim3((unsigned)nb, (unsigned)groups), BLOCK, 0, st>>>(
        px, py, pz, part, N, k);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    k_point_total_finish<<<(unsigned)groups, 32, 0, st>>>(part, ox, oy, oz, nb);
  }
  return (int)cudaGetLastError();
}
