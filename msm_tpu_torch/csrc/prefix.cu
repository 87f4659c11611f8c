// Row offsets on the 13-bit core: the exclusive point prefix over the scan's
// lane totals. Takes balanced limbs (so plain PyTorch tensors are accepted)
// and writes canonical limbs. The other two kernels of pallas_prefix.py are
// csrc/point_total.cu and csrc/horner.cu (word core).
//
// Replaces msm_tpu/ops/pallas_prefix.py::make_row_offsets (pallas_call at
// :133) -> k_ro_totals, k_ro_blocks, k_ro_write.
//
// The TPU ran it as one grid-less program with every lane resident in
// VMEM, crossing lanes with pltpu.roll. Here a block holds at most 128
// projective points (30 KB) in shared memory, under the 48 KB static limit;
// 1024 points would exceed the 227 KB a block may use. It is bound by the
// serial chain of complete additions (12 Montgomery products each) in its
// longest thread, not by memory: a few MB per call. The core runs at ~255
// registers per thread, so an SM holds about 256 threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefix.cuh"

using namespace msm;

constexpr int BLOCK = 128;  // ops/cuda_prefix.py THREADS

// Hillis-Steele inclusive scan over the block's T points: on return s is
// the sum of threads 0..t and sp[t] holds it, for every t.
__device__ void block_inclusive_scan(point* sp, point& s, int t, int T) {
  sp[t] = s;
  __syncthreads();
  for (int k = 1; k < T; k <<= 1) {
    point v;
    if (t >= k) v = sp[t - k];
    __syncthreads();
    if (t >= k) {
      pt_add(s, v, s);
      sp[t] = s;
    }
    __syncthreads();
  }
}

// Row offsets, the exclusive prefix over R lane totals, as a reduce-then-
// scan over the whole card in three launches (msm_row_offsets): one block
// per subtask would leave most SMs idle and give each thread a chain of
// 2 R / BLOCK dependent additions. A grid of R / (K * BLOCK) blocks per
// subtask gives every thread K contiguous lanes (K = 1..8, from the plan in
// ops/cuda_prefix.row_offsets_plan, so the G * R / K threads about fill
// the card), read with one vector load per limb row. Serial depth:
// 2K + log2(BLOCK) + log2(nb) + 2 additions.
//
// 1. k_ro_totals: each thread sums its K lanes, the block scans the sums
//    in shared memory, each thread writes its exclusive in-block prefix to
//    its first lane's output row, and the block writes its total to the
//    scratch s* [G, nb, L].
// 2. k_ro_blocks: one block per subtask turns the nb block totals into
//    exclusive block offsets, in place.
// 3. k_ro_write: each thread adds its block offset to its in-block prefix
//    and writes the prefix of every one of its lanes.
__global__ void __launch_bounds__(BLOCK)
    k_ro_totals(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
                int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                int32_t* __restrict__ sx, int32_t* __restrict__ sy,
                int32_t* __restrict__ sz, int R, int K) {
  __shared__ point sp[BLOCK];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int64_t r0 = (b * BLOCK + t) * K;
  point s;
  if (r0 < R) {
    switch (K) {
      case 1: ro_thread_total<1>(s, tx, ty, tz, g, R, (int)r0); break;
      case 2: ro_thread_total<2>(s, tx, ty, tz, g, R, (int)r0); break;
      case 4: ro_thread_total<4>(s, tx, ty, tz, g, R, (int)r0); break;
      default: ro_thread_total<8>(s, tx, ty, tz, g, R, (int)r0); break;
    }
  } else {
    pt_identity(s);
  }
  block_inclusive_scan(sp, s, t, BLOCK);
  if (r0 < R) {
    point e;
    if (t > 0)
      e = sp[t - 1];
    else
      pt_identity(e);
    const int64_t o = (g * R + r0) * L;
    pt_store(ox + o, oy + o, oz + o, 1, e);
  }
  if (t == BLOCK - 1) {
    const int64_t o = (g * nb + b) * L;
    pt_store(sx + o, sy + o, sz + o, 1, s);
  }
}

// One block of T threads per subtask; thread t owns m = ceil(nb / T)
// consecutive block totals of s* [G, nb, L]: sum, scan, re-accumulate.
__global__ void __launch_bounds__(BLOCK)
    k_ro_blocks(int32_t* sx, int32_t* sy, int32_t* sz, int nb) {
  __shared__ point sp[BLOCK];
  const int T = blockDim.x, t = threadIdx.x;
  const int64_t g = blockIdx.x;
  const int m = (nb + T - 1) / T;
  point s, v;
  pt_identity(s);
  for (int c = 0; c < m && t * m + c < nb; ++c) {
    const int64_t o = (g * nb + t * m + c) * L;
    pt_load_canonical(v, sx + o, sy + o, sz + o);
    if (c == 0)
      s = v;
    else
      pt_add(s, s, v);
  }
  block_inclusive_scan(sp, s, t, T);
  point acc;
  if (t > 0)
    acc = sp[t - 1];
  else
    pt_identity(acc);
  for (int c = 0; c < m && t * m + c < nb; ++c) {
    const int64_t o = (g * nb + t * m + c) * L;
    pt_load_canonical(v, sx + o, sy + o, sz + o);
    pt_store(sx + o, sy + o, sz + o, 1, acc);
    if (c + 1 < m) pt_add(acc, acc, v);
  }
}

__global__ void __launch_bounds__(BLOCK)
    k_ro_write(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
               const int32_t* __restrict__ tz, int32_t* ox, int32_t* oy,
               int32_t* oz, const int32_t* __restrict__ sx,
               const int32_t* __restrict__ sy, const int32_t* __restrict__ sz,
               int R, int K) {
  const int t = threadIdx.x;
  const int64_t g = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int64_t r0 = (b * BLOCK + t) * K;
  if (r0 >= R) return;
  point off, pre, acc;
  int64_t o = (g * nb + b) * L;
  pt_load_canonical(off, sx + o, sy + o, sz + o);
  o = (g * R + r0) * L;
  pt_load_canonical(pre, ox + o, oy + o, oz + o);
  pt_add(acc, off, pre);
  switch (K) {
    case 1: ro_thread_write<1>(acc, tx, ty, tz, ox, oy, oz, g, R, (int)r0); break;
    case 2: ro_thread_write<2>(acc, tx, ty, tz, ox, oy, oz, g, R, (int)r0); break;
    case 4: ro_thread_write<4>(acc, tx, ty, tz, ox, oy, oz, g, R, (int)r0); break;
    default: ro_thread_write<8>(acc, tx, ty, tz, ox, oy, oz, g, R, (int)r0); break;
  }
}

// Three launches on the stream (see k_ro_totals). Inputs t* [G, L, R]
// limbs-first, 16-byte aligned; outputs o* [G, R, L]; scratch s* [G, nb, L].
// The plan: K lanes per thread, nb blocks of BLOCK threads per subtask
// covering the R lanes, scan_threads threads for the block offsets.
extern "C" int msm_row_offsets(const int32_t* tx, const int32_t* ty,
                               const int32_t* tz, int32_t* ox, int32_t* oy,
                               int32_t* oz, int32_t* sx, int32_t* sy,
                               int32_t* sz, int64_t groups, int R, int K,
                               int nb, int scan_threads, void* stream) {
  if (groups > 0 && R > 0) {
    const uintptr_t addr = (uintptr_t)tx | (uintptr_t)ty | (uintptr_t)tz;
    const int64_t span = (int64_t)BLOCK * K;
    if ((K != 1 && K != 2 && K != 4 && K != 8) || R % K != 0 || addr % 16 ||
        nb < 1 || nb * span < R || (nb - 1) * span >= R || scan_threads < 1 ||
        scan_threads > BLOCK)
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((unsigned)nb, (unsigned)groups);
    k_ro_totals<<<grid, BLOCK, 0, st>>>(tx, ty, tz, ox, oy, oz, sx, sy, sz, R, K);
    int err = (int)cudaGetLastError();
    if (err) return err;
    k_ro_blocks<<<(unsigned)groups, scan_threads, 0, st>>>(sx, sy, sz, nb);
    err = (int)cudaGetLastError();
    if (err) return err;
    k_ro_write<<<grid, BLOCK, 0, st>>>(tx, ty, tz, ox, oy, oz, sx, sy, sz, R, K);
  }
  return (int)cudaGetLastError();
}
