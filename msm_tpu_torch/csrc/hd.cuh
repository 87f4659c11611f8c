// Compilation macros shared by every header of csrc: the same code builds
// with nvcc for the card and with a host C++ compiler for the CPU tests.
//
// MSM_HD functions inline into their caller (plain `static inline` outside
// nvcc); MSM_HDM is the same for a member function; MSM_HD_CALL functions
// (the 13-bit core's point formulas and balanced-input product) stay out
// of line, one copy per translation unit, which keeps nvcc's inlined code
// size bounded. MSM_ROLLED keeps a loop whose body is a whole inlined
// point formula rolled: one copy of the formula in the kernel, not one per
// iteration.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MSM_HD __host__ __device__ __forceinline__
#define MSM_HDM __host__ __device__ __forceinline__
#define MSM_HD_CALL static __host__ __device__ __noinline__
#define MSM_UNROLL _Pragma("unroll")
#define MSM_ROLLED _Pragma("unroll 1")
#else
#define MSM_HD static inline
#define MSM_HDM inline
#define MSM_HD_CALL static inline
#define MSM_UNROLL
#define MSM_ROLLED
#endif
