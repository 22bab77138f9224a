// Shared pieces of the LocalState attention kernels (forward and backward).
//
// Every kernel works on the folded layout: q, k, v, out and their
// gradients are contiguous [rows, T, C] in float32 or bfloat16 (rows =
// batch * heads); the per-query decay w, the log-sum-exp and the
// backward's D = <out, grad_out> are contiguous float32 [rows, T].
// Arithmetic is float32 throughout.
//
// Band: with band W in [1, T), only keys with |t - s| <= W enter query s's
// softmax (the JAX package's banded operator); the entry points map
// W <= 0 or W >= T to T, where every key is in the band (exact attention).

#pragma once

#include "common.cuh"

namespace aero {

constexpr int kThreads = 128;  // queries (or keys) per block, one per thread
constexpr int kTile = 64;      // keys (or queries) per shared-memory tile

inline int effective_band(int band, int t_len) {
  return (band <= 0 || band > t_len) ? t_len : band;
}

// The bfloat16 forward on the tensor cores (local_attention_mma.cu): the
// arguments of aero_local_attention_fwd, band already effective.
cudaError_t local_attention_fwd_mma(const void* q, const void* k, const void* v,
                                    const float* w, void* out, float* lse, int rows,
                                    int t_len, int c, int band, cudaStream_t stream);

// The bfloat16 backward on the tensor cores (local_attention_bwd_mma.cu):
// the arguments of aero_local_attention_bwd, band already effective.
cudaError_t local_attention_bwd_mma(const void* q, const void* k, const void* v, const float* w,
                                    const void* out, const void* g, const float* lse,
                                    float* delta, void* dq, void* dk, void* dv, float* dw,
                                    int rows, int t_len, int c, int band, cudaStream_t stream);

}  // namespace aero

// Expands CASE(C) once per head width the kernels are instantiated for.
// Keep in step with KERNEL_WIDTHS in aero_tpu_torch/ops/attention.py.
#define AERO_FOR_EACH_WIDTH(CASE) \
  CASE(2) CASE(4) CASE(8) CASE(12) CASE(16) CASE(24) CASE(32) CASE(48)
