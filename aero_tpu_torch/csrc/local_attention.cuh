// Shared pieces of the LocalState attention kernels (forward and backward).
//
// Every kernel works on the folded layout: q, k, v, out and their
// gradients are contiguous [rows, T, C] in float32 or bfloat16 (rows =
// batch * heads); the per-query decay w, the log-sum-exp and the
// backward's D = <out, grad_out> are contiguous float32 [rows, T].
// Arithmetic is float32 throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace aero {

constexpr int kThreads = 128;  // queries (or keys) per block, one per thread
constexpr int kTile = 64;      // keys (or queries) per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace aero

// Expands CASE(C) once per head width the kernels are instantiated for.
// Keep in step with KERNEL_WIDTHS in aero_tpu_torch/ops/attention.py.
#define AERO_FOR_EACH_WIDTH(CASE) \
  CASE(2) CASE(4) CASE(8) CASE(12) CASE(16) CASE(24) CASE(32)
