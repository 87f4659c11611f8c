// Bucket-count histogram of the window keys; the caller's cumulative sum
// turns counts into bucket ends (ends[b] = #{keys <= b}).
//
// Replaces: msm_tpu/ops/pallas_hist.py::make_bucket_hist (pallas_call at
// :83). The TPU built one-hot matrices in VMEM and counted them with a bf16
// MXU product, which is exact only below 2^24 keys. Hopper has atomics in
// shared memory.
//
// Bound: one 4 B key read per key. One global atomic per key (the first
// design) serialized on hot addresses: with 256 buckets thousands of keys
// contend for each counter, and zero padding sends half of a row to bucket
// 0. So each block takes a contiguous range of one row's keys and counts
// them into a private copy of that row's counters in shared memory; a warp
// adds equal keys once (__match_any_sync, then one atomic by the lowest
// lane with the popcount), so a warp of equal keys costs one shared atomic,
// not 32. At the end the block adds its non-zero counters to `counts` with
// one global atomic each; the launch plan (ops/cuda_hist.hist_plan) gives a
// block at least three keys per counter it flushes, where the row is long
// enough. Where the row's counters exceed the shared memory a block may
// use, a third grid axis tiles the bucket range and each block counts only
// the keys in its tile. CUDA rather than Triton so that every kernel of the
// slice shares one build. Keys outside [0, num_buckets) are not counted
// (they cannot occur for digits of reduced scalars; the bucket ends would
// show the loss).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 1024;  // ops/cuda_hist.py HIST_THREADS
constexpr int UNROLL = 4;      // key loads in flight per thread
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use

// Block (b, g, z) counts keys [b*key_chunk, (b+1)*key_chunk) of row g that
// fall in bucket tile [z*bucket_tile, (z+1)*bucket_tile).
__global__ void __launch_bounds__(THREADS)
    k_hist(const int32_t* __restrict__ keys, int32_t* __restrict__ counts,
           int64_t n, int num_buckets, int64_t key_chunk, int bucket_tile) {
  extern __shared__ int32_t sh[];
  const int64_t g = blockIdx.y;
  const uint32_t lo = blockIdx.z * (uint32_t)bucket_tile;
  const uint32_t width = min((uint32_t)bucket_tile, (uint32_t)num_buckets - lo);
  for (uint32_t b = threadIdx.x; b < width; b += THREADS) sh[b] = 0;
  __syncthreads();

  const int64_t start = blockIdx.x * key_chunk;
  const int64_t end = start + key_chunk < n ? start + key_chunk : n;
  const int32_t* row = keys + g * n;
  const int lane = threadIdx.x & 31;
  // A warp's lanes share `i0`, so the loop and __match_any_sync run on the
  // full warp; lanes past the end hold a key that no tile accepts.
  for (int64_t i0 = start + (threadIdx.x & ~31); i0 < end;
       i0 += (int64_t)THREADS * UNROLL) {
    uint32_t rel[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + (int64_t)u * THREADS + lane;
      rel[u] = (i < end ? (uint32_t)row[i] : 0xffffffffu) - lo;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool mine = rel[u] < width;
      const uint32_t peers = __match_any_sync(0xffffffffu, mine ? rel[u] : 0xffffffffu);
      if (mine && lane == __ffs(peers) - 1) atomicAdd(&sh[rel[u]], __popc(peers));
    }
  }
  __syncthreads();
  int32_t* out = counts + g * num_buckets + lo;
  for (uint32_t b = threadIdx.x; b < width; b += THREADS) {
    const int32_t c = sh[b];
    if (c) atomicAdd(&out[b], c);
  }
}

// keys [G, n] -> counts [G, num_buckets]; counts must be zeroed by the
// caller. key_chunk keys and bucket_tile counters per block (the plan of
// ops/cuda_hist.hist_plan).
extern "C" int msm_hist(const int32_t* keys, int32_t* counts, int64_t groups,
                        int64_t n, int num_buckets, int64_t key_chunk,
                        int bucket_tile, void* stream) {
  if (n > 0 && groups > 0 && num_buckets > 0) {
    const size_t smem = (size_t)bucket_tile * sizeof(int32_t);
    if (key_chunk <= 0 || bucket_tile <= 0 || smem > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    int err = (int)cudaFuncSetAttribute(
        k_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    const dim3 grid((unsigned)((n + key_chunk - 1) / key_chunk), (unsigned)groups,
                    (unsigned)((num_buckets + bucket_tile - 1) / bucket_tile));
    k_hist<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        keys, counts, n, num_buckets, key_chunk, bucket_tile);
  }
  return (int)cudaGetLastError();
}
