// Point conversion: 16-bit coordinate words -> canonical Montgomery form
// (one product by R^2) -> the packed table's dense radix-2^32 words.
//
// Replaces: msm_tpu/ops/pallas_convert.py::make_convert_pack (pallas_call
// at :187), in both modes: k_convert the plain one, [n, 2D] rows (D = 8
// words per BN254 coordinate, x words then y words); k_convert_glv the GLV
// one (dual_x_scale_int = beta R^2, triple=True, :101-145), [n, 3D] rows x,
// beta x, y. Bit for bit, since a canonical value has one encoding.
//
// Bound: bytes. Each point reads 64 B (two coordinates of 16 u16 words,
// int16 on the wire) and writes 64 B, against 2 Montgomery products; at
// 2^20 points the 128 MiB moved and the 2^21 products take about the same
// least time (~0.04 ms). The design (csrc/convert32.cuh): the word core,
// on which little-endian u16 words already are the 32-bit words of a
// coordinate -- no unpacking into 13-bit limbs and no repacking -- with
// two 16-byte loads and two 16-byte stores per coordinate, a reduction
// below p by three conditional subtracts, and one fe32_mul by R^2 mod p.
// One thread per point, so its two products are independent. The GLV mode
// writes 96 B a point against its 3 products (~0.05 ms at 2^20, set by
// the products).
#include <cuda_runtime.h>

#include "convert32.cuh"

using namespace msm;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    k_convert(const int16_t* __restrict__ xw, const int16_t* __restrict__ yw,
              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) convert_point(xw, yw, out, i);
}

// xw, yw [n, 16] int16 (u16 bits); out [n, 2D] int32; all 16-byte aligned
extern "C" int msm_convert(const int16_t* xw, const int16_t* yw, int32_t* out,
                           int64_t n, void* stream) {
  if (((uintptr_t)xw | (uintptr_t)yw | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    k_convert<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(xw, yw,
                                                                     out, n);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
    k_convert_glv(const int16_t* __restrict__ xw,
                  const int16_t* __restrict__ yw, int32_t* __restrict__ out,
                  int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) convert_point_glv(xw, yw, out, i);
}

// xw, yw [n, 16] int16 (u16 bits); out [n, 3D] int32; all 16-byte aligned
extern "C" int msm_convert_glv(const int16_t* xw, const int16_t* yw,
                               int32_t* out, int64_t n, void* stream) {
  if (((uintptr_t)xw | (uintptr_t)yw | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    k_convert_glv<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        xw, yw, out, n);
  }
  return (int)cudaGetLastError();
}
