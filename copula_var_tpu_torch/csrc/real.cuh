// Scalar traits of the kernels, which are templates over the working type
// Real: double (the f64 `xla` engine's path) or float (the f32 engine,
// `engine="pallas"`, the counterpart of the JAX package's f32 Pallas
// kernels).
//
// Rn<Real> gives the round-to-nearest arithmetic that nvcc cannot
// contract into an FMA (__dmul_rn ... for double, __fmul_rn ... for
// float), so the masks' dynamic bounds and the cells are rounded after
// every operation as the plain PyTorch twins round them; the accurate
// exp / log1p of the type (never __expf); the largest finite value (what
// nan_to_num saturates to); and a quiet NaN. The double members are the
// intrinsics the f64 kernels called before the templates, so the f64
// instantiations run the same instructions.
//
// Sums are another matter: every prefix, row sum and partial is
// accumulated in double for both types and rounded to Real once, where it
// is stored (interval.cuh).

#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>

template <typename Real>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double log1p(double v) {
    return ::log1p(v);
  }
  static __device__ __forceinline__ double max() { return DBL_MAX; }
  static __device__ __forceinline__ double nan() { return CUDART_NAN; }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float exp(float v) { return ::expf(v); }
  static __device__ __forceinline__ float log1p(float v) {
    return ::log1pf(v);
  }
  static __device__ __forceinline__ float max() { return FLT_MAX; }
  static __device__ __forceinline__ float nan() { return CUDART_NAN_F; }
};
