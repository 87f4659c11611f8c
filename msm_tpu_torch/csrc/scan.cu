// Per-lane inclusive prefix of mixed point additions over the bucket-sorted
// affine points -- the hot kernel of the MSM.
//
// Replaces: msm_tpu/ops/pallas_scan.py::make_scan_rows (pallas_call at
// :374), non-GLV mode, together with the sorted-order gather that fed it
// (msm_tpu/ops/scan.py:545, packed[perm2]).
//
// Layout: subtask g, lane r owns sorted positions [r*C, (r+1)*C); step c of
// lane r is element (c, r) of the step-major permutation. Thread (g, r)
// walks its C steps: it gathers the packed canonical row of point
// perm[g, c, r], negates y (p - y) when the flag's bit 0 is set, folds the
// point in with RCB16 Algorithm 8, and writes the running sum as one
// x||y||z row pe3[g, c, r, 0:3L]. The last step also goes to the lane
// totals t{x,y,z}[g, :, r], limbs-first (coalesced across lanes).
//
// Bound: 11 Montgomery products per step (~9k 32-bit multiply-adds) --
// integer-multiply bound; the 64 B random gather and the 240 B row write
// per step are second. One thread per lane keeps the accumulator in
// registers across all C steps (the TPU kept it in VMEM scratch across
// grid steps); at 2^20 points and R = 16384 lanes a batch of 4 subtasks
// gives 65536 threads, enough to fill the 132 SMs at the register count
// this kernel needs.
#include <cuda_runtime.h>

#include "curve.cuh"

using namespace msm;

constexpr int D = DENSE_WORDS;  // 32-bit words per packed coordinate

__global__ void __launch_bounds__(128)
    k_scan(const int32_t* __restrict__ packed, const int32_t* __restrict__ perm,
           const int32_t* __restrict__ flags, int32_t* __restrict__ pe3,
           int32_t* __restrict__ tx, int32_t* __restrict__ ty,
           int32_t* __restrict__ tz, int C, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t g = blockIdx.y;
  if (r >= R) return;
  point acc;
  pt_identity(acc);
  for (int c = 0; c < C; ++c) {
    const int64_t e = (g * C + c) * R + r;
    const int64_t row = perm[e];
    fe x2, y2;
    fe_unpack_dense(x2, packed + row * 2 * D);
    fe_unpack_dense(y2, packed + row * 2 * D + D);
    if (flags[e] & 1) fe_neg(y2, y2);
    pt_madd(acc, acc, x2, y2);
    int32_t* o = pe3 + e * 3 * L;
    fe_store(o, acc.x);
    fe_store(o + L, acc.y);
    fe_store(o + 2 * L, acc.z);
  }
  const int64_t t = g * L * R + r;
  pt_store(tx + t, ty + t, tz + t, R, acc);
}

// packed [N, 2D]; perm, flags [G, C, R]; pe3 [G, C, R, 3L]; t* [G, L, R]
extern "C" int msm_scan(const int32_t* packed, const int32_t* perm,
                        const int32_t* flags, int32_t* pe3, int32_t* tx,
                        int32_t* ty, int32_t* tz, int64_t groups, int C, int R,
                        void* stream) {
  if (groups > 0 && R > 0) {
    const int threads = 128;
    const dim3 grid((unsigned)((R + threads - 1) / threads), (unsigned)groups);
    k_scan<<<grid, threads, 0, (cudaStream_t)stream>>>(packed, perm, flags,
                                                       pe3, tx, ty, tz, C, R);
  }
  return (int)cudaGetLastError();
}
