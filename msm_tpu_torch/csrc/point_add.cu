// Batched complete point addition (RCB16 Algorithm 7).
//
// Replaces: msm_tpu/ops/pallas_curve.py::make_point_add (pallas_call at
// :467). The TPU kernel existed to keep a whole add's 12 Montgomery
// products in VMEM instead of round-tripping each product through HBM.
//
// On the H100 one thread owns one add, so nothing leaves registers between
// products. The kernel is bound by integer multiply throughput (12 CIOS
// products of 800 32-bit multiply-adds each, plus six signed products to
// canonicalize balanced inputs) and by register pressure (about a dozen
// live 20-limb values): 128-thread blocks, and spills are accepted for now.
// Inputs are read as balanced limbs so that tensors from plain PyTorch code
// are accepted; outputs are canonical.
#include <cuda_runtime.h>

#include "curve.cuh"

using namespace msm;

__global__ void __launch_bounds__(128)
    k_point_add(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                int32_t* __restrict__ oz, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t o = i * L;
  point p, q, r;
  pt_load_balanced(p, ax + o, ay + o, az + o, 1);
  pt_load_balanced(q, bx + o, by + o, bz + o, 1);
  pt_add(r, p, q);
  pt_store(ox + o, oy + o, oz + o, 1, r);
}

extern "C" int msm_point_add(const int32_t* ax, const int32_t* ay,
                             const int32_t* az, const int32_t* bx,
                             const int32_t* by, const int32_t* bz, int32_t* ox,
                             int32_t* oy, int32_t* oz, int64_t n,
                             void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    k_point_add<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        ax, ay, az, bx, by, bz, ox, oy, oz, n);
  }
  return (int)cudaGetLastError();
}
