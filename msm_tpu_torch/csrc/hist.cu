// Bucket-count histogram of the window keys; the caller's cumulative sum
// turns counts into bucket ends (ends[b] = #{keys <= b}).
//
// Replaces: msm_tpu/ops/pallas_hist.py::make_bucket_hist (pallas_call at
// :83). The TPU built one-hot matrices in VMEM and counted them with a bf16
// MXU product, which is exact only below 2^24 keys. Hopper has atomics, so
// each thread adds one to its key's counter in device memory.
//
// Bound: one 4 B key read and one atomic per key -- memory and atomic
// throughput; skew (many zero digits in bucket 0) serializes atomics on a
// few addresses, which L2 atomics absorb at the sizes the main path runs.
// CUDA rather than Triton so that every kernel of the slice shares one
// build. Keys outside [0, num_buckets) are not counted (they cannot occur
// for digits of reduced scalars; the bucket ends would show the loss).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void k_hist(const int32_t* __restrict__ keys,
                       int32_t* __restrict__ counts, int64_t n,
                       int num_buckets) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t g = blockIdx.y;
  if (i >= n) return;
  const int32_t k = keys[g * n + i];
  if ((uint32_t)k < (uint32_t)num_buckets)
    atomicAdd(&counts[g * num_buckets + k], 1);
}

// keys [G, n] -> counts [G, num_buckets]; counts must be zeroed by the caller
extern "C" int msm_hist(const int32_t* keys, int32_t* counts, int64_t groups,
                        int64_t n, int num_buckets, void* stream) {
  if (n > 0 && groups > 0) {
    const int threads = 256;
    const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)groups);
    k_hist<<<grid, threads, 0, (cudaStream_t)stream>>>(keys, counts, n,
                                                       num_buckets);
  }
  return (int)cudaGetLastError();
}
