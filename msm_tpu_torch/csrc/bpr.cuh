// Phase 1 of the blocked bucket reduction (cuZK Algorithm 4): the per-lane
// body of kernel 8 (csrc/bpr.cu). __host__ __device__, so the host C++
// compiler builds it for the CPU tests; out of line (MSM_HD_CALL) like the
// point formulas.
#pragma once

#include "curve.cuh"

namespace msm {

// Lane t of subtask g walks its block of Bl buckets from the top down:
//     m <- m + B[g, b, t],  acc <- acc + m,   b = Bl-1 .. 0
// from m = acc = identity, so m is the block sum and acc the sum of the
// running sums. Buckets b* [G, Bl, T, L] step-major (balanced limbs);
// outputs m*, g* [G, T, L] (canonical).
MSM_HD_CALL void bpr_phase1_lane(const int32_t* bx, const int32_t* by,
                                 const int32_t* bz, int32_t* mx, int32_t* my,
                                 int32_t* mz, int32_t* gx, int32_t* gy,
                                 int32_t* gz, int64_t g, int Bl, int T,
                                 int t) {
  point m, acc, s;
  pt_identity(m);
  pt_identity(acc);
  for (int b = Bl - 1; b >= 0; --b) {
    const int64_t o = ((g * Bl + b) * T + t) * L;
    pt_load_balanced(s, bx + o, by + o, bz + o, 1);
    pt_add(m, m, s);
    pt_add(acc, acc, m);
  }
  const int64_t o = (g * T + t) * L;
  pt_store(mx + o, my + o, mz + o, 1, m);
  pt_store(gx + o, gy + o, gz + o, 1, acc);
}

}  // namespace msm
