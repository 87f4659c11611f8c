// The three small point-sum kernels around the scan: row offsets, point
// total and the Horner ladder. All take balanced limbs (so plain PyTorch
// tensors are accepted) and write canonical limbs.
//
// Replaces msm_tpu/ops/pallas_prefix.py:
//   make_row_offsets   (pallas_call at :133) -> k_row_offsets
//   make_point_total   (pallas_call at :231) -> k_point_total
//   make_horner_ladder (pallas_call at :335) -> k_horner
//
// The TPU ran each as one grid-less program with every lane resident in
// VMEM, crossing lanes with pltpu.roll. Here a block holds at most 128
// projective points (30 KB) in shared memory, under the 48 KB static limit;
// 1024 points would exceed the 227 KB a block may use. All three are bound
// by the serial chain of complete additions (12 Montgomery products each)
// in their longest thread, not by memory: a few hundred KB per call.
#include <cuda_runtime.h>

#include "curve.cuh"

using namespace msm;

constexpr int BLOCK = 128;

// Exclusive prefix over R lane totals, one block per subtask. Thread t owns
// the contiguous lanes [t*C2, (t+1)*C2): pass 1 sums them, a Hillis-Steele
// ladder in shared memory turns the T sums into exclusive offsets, and
// pass 2 re-accumulates from each thread's offset, writing every lane's
// exclusive prefix. Inputs t* [G, L, R] limbs-first; outputs o* [G, R, L].
__global__ void __launch_bounds__(BLOCK)
    k_row_offsets(const int32_t* __restrict__ tx,
                  const int32_t* __restrict__ ty,
                  const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz, int R) {
  __shared__ point sp[BLOCK];
  const int T = blockDim.x, t = threadIdx.x;
  const int64_t g = blockIdx.x;
  const int C2 = R / T;
  const int32_t* bx = tx + g * L * R;
  const int32_t* by = ty + g * L * R;
  const int32_t* bz = tz + g * L * R;
  point s, v;
  pt_identity(s);
  for (int c = 0; c < C2; ++c) {
    const int r = t * C2 + c;
    pt_load_balanced(v, bx + r, by + r, bz + r, R);
    pt_add(s, s, v);
  }
  sp[t] = s;
  __syncthreads();
  for (int k = 1; k < T; k <<= 1) {
    if (t >= k) v = sp[t - k];
    __syncthreads();
    if (t >= k) {
      pt_add(s, s, v);
      sp[t] = s;
    }
    __syncthreads();
  }
  point acc;
  if (t > 0)
    acc = sp[t - 1];
  else
    pt_identity(acc);
  for (int c = 0; c < C2; ++c) {
    const int r = t * C2 + c;
    const int64_t o = (g * R + r) * L;
    pt_store(ox + o, oy + o, oz + o, 1, acc);
    pt_load_balanced(v, bx + r, by + r, bz + r, R);
    pt_add(acc, acc, v);
  }
}

// Sum of N points per subtask. Block (b, g) sums a contiguous range of
// subtask g's points, strided over its threads, then tree-reduces in
// shared memory and writes one partial point. Inputs p* [G, N, L];
// outputs o* [G, nb, L].
__global__ void __launch_bounds__(BLOCK)
    k_point_total(const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  int64_t N) {
  __shared__ point sp[BLOCK];
  const int T = blockDim.x, t = threadIdx.x;
  const int64_t b = blockIdx.x, nb = gridDim.x, g = blockIdx.y;
  const int64_t lo = N * b / nb, hi = N * (b + 1) / nb;
  point s, v;
  pt_identity(s);
  for (int64_t i = lo + t; i < hi; i += T) {
    const int64_t o = (g * N + i) * L;
    pt_load_balanced(v, px + o, py + o, pz + o, 1);
    pt_add(s, s, v);
  }
  sp[t] = s;
  __syncthreads();
  for (int h = T / 2; h > 0; h >>= 1) {
    if (t < h) {
      pt_add(s, sp[t], sp[t + h]);
      sp[t] = s;
    }
    __syncthreads();
  }
  if (t == 0) {
    const int64_t o = (g * nb + b) * L;
    pt_store(ox + o, oy + o, oz + o, 1, sp[0]);
  }
}

// sum_s 2^(chunk*s) * W_s by Horner's rule in one thread: chunk*(S-1)
// doublings (RCB16 Algorithm 9) and S-1 additions. Inputs w* [S, L];
// outputs o* [L].
__global__ void k_horner(const int32_t* __restrict__ wx,
                         const int32_t* __restrict__ wy,
                         const int32_t* __restrict__ wz,
                         int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz, int S, int chunk) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  point acc, v;
  int64_t o = (int64_t)(S - 1) * L;
  pt_load_balanced(acc, wx + o, wy + o, wz + o, 1);
  for (int s = S - 2; s >= 0; --s) {
    for (int k = 0; k < chunk; ++k) pt_double(acc, acc);
    o = (int64_t)s * L;
    pt_load_balanced(v, wx + o, wy + o, wz + o, 1);
    pt_add(acc, acc, v);
  }
  pt_store(ox, oy, oz, 1, acc);
}

// R must be a multiple of threads = min(128, R) (R is a power of two).
extern "C" int msm_row_offsets(const int32_t* tx, const int32_t* ty,
                               const int32_t* tz, int32_t* ox, int32_t* oy,
                               int32_t* oz, int64_t groups, int R,
                               void* stream) {
  if (groups > 0 && R > 0) {
    const int threads = R < BLOCK ? R : BLOCK;
    if (R % threads != 0) return (int)cudaErrorInvalidValue;
    k_row_offsets<<<(unsigned)groups, threads, 0, (cudaStream_t)stream>>>(
        tx, ty, tz, ox, oy, oz, R);
  }
  return (int)cudaGetLastError();
}

// Two launches: `nb` partial sums per subtask into the scratch s* [G, nb, L],
// then one block per subtask over the partials into o* [G, 1, L].
extern "C" int msm_point_total(const int32_t* px, const int32_t* py,
                               const int32_t* pz, int32_t* sx, int32_t* sy,
                               int32_t* sz, int32_t* ox, int32_t* oy,
                               int32_t* oz, int64_t groups, int64_t N, int nb,
                               void* stream) {
  if (groups > 0 && nb > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    k_point_total<<<dim3((unsigned)nb, (unsigned)groups), BLOCK, 0, st>>>(
        px, py, pz, sx, sy, sz, N);
    int err = (int)cudaGetLastError();
    if (err) return err;
    k_point_total<<<dim3(1, (unsigned)groups), BLOCK, 0, st>>>(sx, sy, sz, ox,
                                                               oy, oz, nb);
  }
  return (int)cudaGetLastError();
}

extern "C" int msm_horner(const int32_t* wx, const int32_t* wy,
                          const int32_t* wz, int32_t* ox, int32_t* oy,
                          int32_t* oz, int S, int chunk, void* stream) {
  if (S > 0) {
    k_horner<<<1, 1, 0, (cudaStream_t)stream>>>(wx, wy, wz, ox, oy, oz, S,
                                                chunk);
  }
  return (int)cudaGetLastError();
}
