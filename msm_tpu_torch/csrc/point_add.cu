// Batched complete point addition (RCB16 Algorithm 7) on the word core.
//
// Replaces: msm_tpu/ops/pallas_curve.py::make_point_add (pallas_call at
// :467). The TPU kernel existed to keep a whole add's 12 Montgomery
// products in VMEM instead of round-tripping each product through HBM.
//
// On the H100 one thread owns one add (csrc/point_add.cuh point_add_row),
// so nothing leaves registers between products. Bound: integer
// instruction throughput, 12 products of 2 x 64 word multiply-adds each
// (csrc/fe32.cuh), whose carry handling's add and logic instructions
// outnumber the multiplies (PERF.md), plus six balanced-row loads; the
// 9 x 80 B of rows per add come second. The design:
//   - the word core with pt32_add inlined: no out-of-line call, no stack
//     frame (the 13-bit core took 2 x 400 multiply-adds per product at ~255
//     registers);
//   - __launch_bounds__(128, 4), as the scan (csrc/scan.cu): at most 128
//     registers, 4 blocks of 128 per SM;
//   - each 80-byte row read with five 16-byte loads and written with five
//     16-byte stores (scripts/torch_add_total_variants.py times this
//     against staging a block's rows through shared memory, PERF.md).
// Small batches are latency-bound instead: the naive path's running sum
// launches 510 adds of 32 points each, one after another, and one add in
// one thread is 12 products deep. For a batch whose warps fit in one wave
// (ops/cuda_curve.point_add_lanes), k_point_add_lanes gives each add a
// warp that splits its products over the lanes (two products deep, as the
// Horner ladder's chain does).
#include <cuda_runtime.h>

#include "point_add.cuh"

using namespace msm;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS, 4)
    k_point_add(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  point_add_row(ax, ay, az, bx, by, bz, ox, oy, oz, i);
}

// One warp per add, THREADS / 32 adds per block.
__global__ void __launch_bounds__(THREADS)
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
  point_add_row_lanes(ax, ay, az, bx, by, bz, ox, oy, oz, i);
}

// Every pointer [n, L], 16-byte aligned; lanes != 0: a warp per add.
extern "C" int msm_point_add(const int32_t* ax, const int32_t* ay,
                             const int32_t* az, const int32_t* bx,
                             const int32_t* by, const int32_t* bz, int32_t* ox,
                             int32_t* oy, int32_t* oz, int64_t n, int lanes,
                             void* stream) {
  const uintptr_t addr = (uintptr_t)ax | (uintptr_t)ay | (uintptr_t)az |
                         (uintptr_t)bx | (uintptr_t)by | (uintptr_t)bz |
                         (uintptr_t)ox | (uintptr_t)oy | (uintptr_t)oz;
  if (addr % 16) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (lanes) {
      const int64_t blocks = (n * 32 + THREADS - 1) / THREADS;
      k_point_add_lanes<<<(unsigned)blocks, THREADS, 0, st>>>(ax, ay, az, bx, by,
                                                              bz, ox, oy, oz, n);
    } else {
      const int64_t blocks = (n + THREADS - 1) / THREADS;
      k_point_add<<<(unsigned)blocks, THREADS, 0, st>>>(ax, ay, az, bx, by, bz,
                                                        ox, oy, oz, n);
    }
  }
  return (int)cudaGetLastError();
}
