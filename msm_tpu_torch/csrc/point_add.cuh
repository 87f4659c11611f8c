// Kernel 1 (csrc/point_add.cu): the bodies on the word core, generic over
// the field. __host__ __device__, so the host C++ compiler builds them for
// the CPU tests; the kernels and their launch (PointAddLaunch<F>) are in
// plain.cuh.
//
// Row i of the six [B, L] balanced-limb inputs is added with RCB16
// Algorithm 7 and written as row i of the three [B, L] outputs in canonical
// W-bit limbs: by one thread (point_add_row, pt32_add inlined), or, for
// small batches, by one warp that splits the 12 products over its lanes
// (point_add_row_lanes, csrc/lanes32.cuh pt32_add_lanes).
#pragma once

#include "lanes32.cuh"

namespace msm {

// One [L] limb row onto the word core; on the device in the widest vector
// loads the row allows (BN254: 80 B, five 16-byte loads) through the
// read-only cache.
template <class F>
MSM_HD void pa_load(fe32t<F>& out, const int32_t* src) {
  int32_t raw[F::L];
  row_load(raw, src);
  fe32_from_balanced(out, raw);
}

// One [L] row of canonical limbs; on the device in the widest vector
// stores the row allows (BN254: five 16-byte stores).
template <class F>
MSM_HD void pa_store(int32_t* dst, const fe32t<F>& a) {
  uint32_t v[F::L];
  fe32_to_limbs(v, a);
  row_store(dst, v);
}

template <class F>
MSM_HD void pa_load_points(pt32t<F>& p, pt32t<F>& q, const int32_t* ax,
                           const int32_t* ay, const int32_t* az,
                           const int32_t* bx, const int32_t* by,
                           const int32_t* bz, int64_t o) {
  pa_load(p.x, ax + o);
  pa_load(p.y, ay + o);
  pa_load(p.z, az + o);
  pa_load(q.x, bx + o);
  pa_load(q.y, by + o);
  pa_load(q.z, bz + o);
}

template <class F = FpBn254>
MSM_HD void point_add_row(const int32_t* ax, const int32_t* ay,
                          const int32_t* az, const int32_t* bx,
                          const int32_t* by, const int32_t* bz, int32_t* ox,
                          int32_t* oy, int32_t* oz, int64_t i) {
  const int64_t o = i * F::L;
  pt32t<F> p, q, r;
  pa_load_points(p, q, ax, ay, az, bx, by, bz, o);
  pt32_add(r, p, q);
  pa_store(ox + o, r.x);
  pa_store(oy + o, r.y);
  pa_store(oz + o, r.z);
}

// Row i by a whole warp: every lane loads the row (one transaction per
// row) and ends with the sum; lanes 0, 1, 2 store x, y, z.
template <class F = FpBn254>
MSM_HD void point_add_row_lanes(const int32_t* ax, const int32_t* ay,
                                const int32_t* az, const int32_t* bx,
                                const int32_t* by, const int32_t* bz,
                                int32_t* ox, int32_t* oy, int32_t* oz,
                                int64_t i) {
  const int64_t o = i * F::L;
  pt32t<F> p, q, r;
  pa_load_points(p, q, ax, ay, az, bx, by, bz, o);
  pt32_add_lanes(r, p, q);
#ifdef __CUDA_ARCH__
  const int lane = threadIdx.x & 31;
  if (lane == 0) pa_store(ox + o, r.x);
  if (lane == 1) pa_store(oy + o, r.y);
  if (lane == 2) pa_store(oz + o, r.z);
#else
  pa_store(ox + o, r.x);
  pa_store(oy + o, r.y);
  pa_store(oz + o, r.z);
#endif
}

}  // namespace msm
