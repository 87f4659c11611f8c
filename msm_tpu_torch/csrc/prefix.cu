// Row offsets: the exclusive point prefix over the scan's lane totals, on
// the word core (csrc/fe32.cuh), generic over the field. Takes balanced
// limbs (so plain PyTorch tensors are accepted) and writes canonical limbs.
// The other two kernels of pallas_prefix.py are csrc/point_total.cu and
// csrc/horner.cu.
//
// Replaces msm_tpu/ops/pallas_prefix.py::make_row_offsets (pallas_call at
// :133) -> k_ro_totals, k_ro_blocks, k_ro_write (csrc/plain.cuh; their
// per-thread bodies in prefix.cuh).
//
// The TPU ran it as one grid-less program with every lane resident in
// VMEM, crossing lanes with pltpu.roll. It is bound by the serial chain of
// complete additions (12 Montgomery products each) in its longest thread,
// not by memory: a few MB per call.
//
// A reduce-then-scan over the whole card in three launches: one block per
// subtask would leave most SMs idle and give each thread a chain of 2 R /
// BLOCK dependent additions. A grid of R / (K * BLOCK) blocks per subtask
// gives every thread K contiguous lanes (K = 1..8, from the plan in
// ops/cuda_prefix.row_offsets_plan, so the G * R / K threads about fill
// the card). Serial depth: 2K + log2(BLOCK) + log2(nb) + 2 additions.
// A block holds its 128 points in shared memory (12 KiB at 8 words an
// element, 18 KiB at 12). The additions are pt32_add inlined: the kernels
// make no out-of-line call.
//
// The kernels and their launch are in plain.cuh (RowOffsetsLaunch<F>);
// msm_row_offsets dispatches on the curve (csrc/dispatch.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "plain.cuh"

MSM_EXTERN_OTHER_FIELDS(RowOffsetsLaunch)

// Inputs t* [G, L, R] limbs-first; outputs o* [G, R, L]; scratch s*
// [G, nb, L]; L the curve's. The plan: K lanes per thread, nb blocks of 128
// threads per subtask covering the R lanes, scan_threads threads for the
// block offsets.
extern "C" int msm_row_offsets(const int32_t* tx, const int32_t* ty,
                               const int32_t* tz, int32_t* ox, int32_t* oy,
                               int32_t* oz, int32_t* sx, int32_t* sy,
                               int32_t* sz, int64_t groups, int R, int K,
                               int nb, int scan_threads, int curve,
                               int width, void* stream) {
  MSM_FIELD_SWITCH(curve, RowOffsetsLaunch,
                   (tx, ty, tz, ox, oy, oz, sx, sy, sz, groups, R, K, nb,
                    scan_threads, width, (cudaStream_t)stream))
}
