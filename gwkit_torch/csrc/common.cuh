// Shared device helpers for the gwkit_torch kernels (the wgmma and TMA
// helpers are in hopper.cuh, which builds on the bf16 type below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


namespace gw {

typedef __nv_bfloat16 bf16;

// GELU of a value already rounded to bf16, in f32: the tanh form
// (approx != 0, gwkit's accelerator setting) or the erf form. Kernels B, C
// and E round its result to bf16.
__device__ __forceinline__ float gelu(float h, int approx) {
  if (approx) return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

}  // namespace gw

// the dtype code the Python wrappers pass: the kernels take bfloat16 only
#define GW_BF16 1
