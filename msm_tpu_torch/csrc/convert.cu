// Point conversion: 16-bit coordinate words -> 13-bit limbs -> Montgomery
// form (one product by R^2) -> canonical -> dense radix-2^32 words.
//
// Replaces: msm_tpu/ops/pallas_convert.py::make_convert_pack (pallas_call
// at :187), non-GLV mode. Output is the same [n, 2D] wire format (D = 8
// words per BN254 coordinate, x words then y words), bit for bit, since a
// canonical value has one encoding.
//
// One thread per point. Each point is 2 Montgomery products on 128 B read
// and 64 B written, so at 2^20 points the kernel is short either way; the
// 64 B rows a thread writes are contiguous, and the 16-word input rows are
// read with plain loads (L1 absorbs the row-per-thread pattern).
#include <cuda_runtime.h>

#include "field.cuh"

using namespace msm;

constexpr int WORDS16 = 16;  // u16 words per input coordinate
constexpr int D = 8;         // 32-bit words per packed coordinate

__device__ __forceinline__ void words_to_limbs(fe& out,
                                               const int32_t* __restrict__ w) {
  uint32_t u[WORDS16];
#pragma unroll
  for (int k = 0; k < WORDS16; ++k) u[k] = (uint32_t)w[k] & 0xFFFFu;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int lo = W * i, a = lo / 16, off = lo % 16;
    uint32_t v = 0;
    if (a < WORDS16) {
      v = u[a] >> off;
      if (off + W > 16 && a + 1 < WORDS16) v |= u[a + 1] << (16 - off);
    }
    out.v[i] = v & MASK;
  }
}

__device__ __forceinline__ void pack_dense(int32_t* __restrict__ dst,
                                           const fe& a) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int lo = W * j - 32 * k;  // limb j's bit offset inside word k
      if (lo >= 32 || lo + W <= 0) continue;
      word |= lo >= 0 ? (a.v[j] << lo) : (a.v[j] >> (-lo));
    }
    dst[k] = (int32_t)word;
  }
}

__global__ void __launch_bounds__(128)
    k_convert(const int32_t* __restrict__ xw, const int32_t* __restrict__ yw,
              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe r2, a, m;
#pragma unroll
  for (int j = 0; j < L; ++j) r2.v[j] = r2_limb(j);
  words_to_limbs(a, xw + i * WORDS16);
  fe_mul(m, a, r2);
  pack_dense(out + i * 2 * D, m);
  words_to_limbs(a, yw + i * WORDS16);
  fe_mul(m, a, r2);
  pack_dense(out + i * 2 * D + D, m);
}

extern "C" int msm_convert(const int32_t* xw, const int32_t* yw, int32_t* out,
                           int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    k_convert<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        xw, yw, out, n);
  }
  return (int)cudaGetLastError();
}
