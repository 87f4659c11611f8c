// Phase 1 of the blocked bucket reduction (cuZK Algorithm 4): the chain
// body of kernel 8 (csrc/bpr.cu; kernel and launch in offpath.cuh) on the
// word core, generic over the field (the last template parameter, BN254 by
// default). __host__ __device__, so the host C++ compiler builds it for the
// CPU tests (there one thread runs both halves of a group, step by step,
// and computes every product of a level).
#pragma once

#include "point_add.cuh"

namespace msm {

// The bucket at offset o of b* onto the word core.
template <class F>
MSM_HD void bpr_load(pt32t<F>& s, const int32_t* bx, const int32_t* by,
                     const int32_t* bz, int64_t o) {
  pa_load(s.x, bx + o);
  pa_load(s.y, by + o);
  pa_load(s.z, bz + o);
}

// a where c, else b: word by word, so neither point needs an address.
template <class F>
MSM_HD void pt32_select(pt32t<F>& out, bool c, const pt32t<F>& a,
                        const pt32t<F>& b) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    out.x.w[i] = c ? a.x.w[i] : b.x.w[i];
    out.y.w[i] = c ? a.y.w[i] : b.y.w[i];
    out.z.w[i] = c ? a.z.w[i] : b.z.w[i];
  }
}

// The halves of a group of LANES lanes that one thread runs: on the device
// its own half (bpr_half: 0 the lower, 1 the upper), on the host both.
// bpr_from_half: half h's point, which every lane of that half holds.
#ifdef __CUDA_ARCH__
constexpr int BPR_HALVES = 1;

template <int LANES>
__device__ __forceinline__ int bpr_half(int) {
  return (threadIdx.x & (LANES - 1)) >= LANES / 2;
}

template <int LANES, class F>
__device__ __forceinline__ void bpr_from_half(pt32t<F>& out,
                                              const pt32t<F> (&own)[1], int h) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    out.x.w[i] = __shfl_sync(0xffffffffu, own[0].x.w[i], h * LANES / 2, LANES);
    out.y.w[i] = __shfl_sync(0xffffffffu, own[0].y.w[i], h * LANES / 2, LANES);
    out.z.w[i] = __shfl_sync(0xffffffffu, own[0].z.w[i], h * LANES / 2, LANES);
  }
}
#else
constexpr int BPR_HALVES = 2;

template <int LANES>
int bpr_half(int h) {
  return h;
}

template <int LANES, class F>
void bpr_from_half(pt32t<F>& out, const pt32t<F> (&own)[2], int h) {
  out = own[h];
}
#endif

// Chain t of subtask g walks its block of Bl buckets from the top down:
//     m <- m + B[g, b, t],  acc <- acc + m,   b = Bl-1 .. 0
// from m = acc = identity, so m is the block sum and acc the sum of the
// running sums. These are the twin's additions in the twin's order, so the
// outputs equal its canonical ones even on field triples off the curve.
//
// A group of LANES lanes (a power of two from 4 to 32, aligned within the
// warp) runs the chain. The lower half of the group runs the m chain and
// the upper half the acc chain a step behind (step b's m + B[b] and step
// b + 1's acc + m are independent), each half splitting its addition's
// levels of six products (lanes32.cuh); after every step the lower half
// hands m over by shuffle. Bl + 1 steps, the first acc step and the last
// m step discarded. Every lane loads each bucket row (one transaction for
// the group). Every lane of the warp must run a chain to its end (the
// shuffles take the whole warp): a group past the last chain runs chain
// T - 1 with store = false. Buckets b* [G, Bl, T, L] step-major (balanced
// limbs); outputs m*, g* [G, T, L] (canonical), each row stored by one
// lane of the group. Rows rows_aligned<F> on the device
// (point_add.cuh pa_load).
template <int LANES, class F = FpBn254>
MSM_HD void bpr_phase1_chain(const int32_t* bx, const int32_t* by,
                             const int32_t* bz, int32_t* mx, int32_t* my,
                             int32_t* mz, int32_t* gx, int32_t* gy,
                             int32_t* gz, int64_t g, int Bl, int T, int t,
                             bool store) {
  static_assert(LANES >= 4 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
                "two halves of a power of two of lanes, 2 to 16 each");
  const int L = limb_count<F>();
  pt32t<F> own[BPR_HALVES], handed, s;  // own: m on the lower half, acc on the upper
  pt32_identity(handed);
  s = handed;
  MSM_UNROLL
  for (int h = 0; h < BPR_HALVES; ++h) own[h] = handed;
  const int64_t step = (int64_t)T * L;
  int64_t o = ((g * Bl + Bl - 1) * T + t) * L;
  MSM_ROLLED
  for (int b = Bl - 1; b >= -1; --b, o -= step) {
    if (b >= 0) bpr_load(s, bx, by, bz, o);
    MSM_UNROLL
    for (int h = 0; h < BPR_HALVES; ++h) {
      const bool acc_half = bpr_half<LANES>(h);
      pt32t<F> in, r;
      pt32_select(in, acc_half, handed, s);
      pt32_add_lanes<LANES / 2>(r, own[h], in);
      pt32_select(own[h], acc_half ? b < Bl - 1 : b >= 0, r, own[h]);
    }
    bpr_from_half<LANES>(handed, own, 0);
  }
  pt32t<F> acc;
  bpr_from_half<LANES>(acc, own, 1);
  if (!store) return;
  const pt32t<F>& m = handed;
#ifdef __CUDA_ARCH__
  const int lane = threadIdx.x & (LANES - 1), stride = LANES;
#else
  const int lane = 0, stride = 1;
#endif
  o = (g * T + t) * L;  // row k by lane k mod LANES
  if (lane == 0 % stride) pa_store(mx + o, m.x);
  if (lane == 1 % stride) pa_store(my + o, m.y);
  if (lane == 2 % stride) pa_store(mz + o, m.z);
  if (lane == 3 % stride) pa_store(gx + o, acc.x);
  if (lane == 4 % stride) pa_store(gy + o, acc.y);
  if (lane == 5 % stride) pa_store(gz + o, acc.z);
}

}  // namespace msm
