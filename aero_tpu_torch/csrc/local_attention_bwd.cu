// LocalState attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel _pallas_bwd_kernel of aero_tpu/ops/attention.py
// (line 422, called through pallas_attention_bwd and the custom VJP
// _fla_bwd). With p[t, s] the forward's softmax over keys t for query s,
// recomputed from the forward's log-sum-exp as exp(score[t, s] - lse_s),
// g the gradient of out and D_s = <out_s, g_s>:
//
//   dv_t  = sum_s p[t, s] * g_s
//   ds    = p[t, s] * (<v_t, g_s> - D_s),   0 on the diagonal (the -100
//                                           there is a constant)
//   dq_s  = sum_t ds[t, s] * k_t
//   dk_t  = sum_s ds[t, s] * q_s
//   dw_s  = -sum_t ds[t, s] * |t - s|
//
// What bounds it on this card: as in the forward, the T^2 pairs. Each pair
// costs 3*C FMAs in the query-major pass and 4*C in the key-major pass,
// plus one exponential in each; HBM traffic is O(T * C) per row.
//
// Design: two deterministic kernels, no atomics, in the forward's
// one-thread-per-row style with f32 accumulators in registers:
// (a) query-major: one thread per query s holds q_s, g_s, w_s, lse_s and
//     D_s (which it writes for (b)); key tiles of K and V stream through
//     shared memory; it sums dq_s and dw_s;
// (b) key-major: one thread per key t holds k_t and v_t; query tiles of
//     q, g, w, lse and D stream through shared memory; it sums dk_t and
//     dv_t. Queries s >= T carry lse = +inf, so their p is 0.
// The TPU kernel kept whole rows in VMEM and summed dk/dv in scratch over
// a sequential grid; blocks here run in no order, so each output has
// exactly one owning thread instead.

#include "local_attention.cuh"

namespace {

using aero::kThreads;
using aero::kTile;
using aero::store;
using aero::to_f32;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
local_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ w,
                              const T* __restrict__ out,
                              const T* __restrict__ g,
                              const float* __restrict__ lse,
                              float* __restrict__ delta, T* __restrict__ dq,
                              float* __restrict__ dw, int t_len) {
  __shared__ __align__(16) float ks[kTile * C];
  __shared__ __align__(16) float vs[kTile * C];

  const int row = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;  // this thread's query
  const bool live = s < t_len;
  const size_t base = static_cast<size_t>(row) * t_len * C;
  const size_t qoff = base + static_cast<size_t>(s) * C;
  const size_t ridx = static_cast<size_t>(row) * t_len + s;

  float qr[C];
  float gr[C];
  float acc[C];
  float d_s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = live ? to_f32(q[qoff + c]) : 0.f;
    gr[c] = live ? to_f32(g[qoff + c]) : 0.f;
    d_s = fmaf(live ? to_f32(out[qoff + c]) : 0.f, gr[c], d_s);
    acc[c] = 0.f;
  }
  const float ws = live ? w[ridx] : 0.f;
  const float ls = live ? lse[ridx] : 0.f;
  if (live) delta[ridx] = d_s;
  const float sf = static_cast<float>(s);
  float dw_s = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    const int n_valid = min(kTile, t_len - t0) * C;
    const size_t tile = base + static_cast<size_t>(t0) * C;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
      const bool in = i < n_valid;
      ks[i] = in ? to_f32(k[tile + i]) : 0.f;
      vs[i] = in ? to_f32(v[tile + i]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const int t = t0 + j;
      float sc = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sc = fmaf(qr[c], ks[j * C + c], sc);
        dp = fmaf(gr[c], vs[j * C + c], dp);
      }
      const float dist = fabsf(static_cast<float>(t) - sf);
      sc = fmaf(-ws, dist, sc);
      // the diagonal and the keys past T contribute no ds
      const float p = (t != s && t < t_len) ? __expf(sc - ls) : 0.f;
      const float ds = p * (dp - d_s);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(ds, ks[j * C + c], acc[c]);
      dw_s = fmaf(-ds, dist, dw_s);
    }
  }

  if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c) store(dq + qoff + c, acc[c]);
    dw[ridx] = dw_s;
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
local_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ w,
                               const T* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int t_len) {
  __shared__ __align__(16) float qs[kTile * C];
  __shared__ __align__(16) float gs[kTile * C];
  __shared__ float wsh[kTile];
  __shared__ float lsh[kTile];
  __shared__ float dsh[kTile];

  const int row = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // this thread's key
  const bool live = t < t_len;
  const size_t base = static_cast<size_t>(row) * t_len * C;
  const size_t koff = base + static_cast<size_t>(t) * C;
  const size_t rbase = static_cast<size_t>(row) * t_len;

  float kr[C];
  float vr[C];
  float dk_t[C];
  float dv_t[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    kr[c] = live ? to_f32(k[koff + c]) : 0.f;
    vr[c] = live ? to_f32(v[koff + c]) : 0.f;
    dk_t[c] = 0.f;
    dv_t[c] = 0.f;
  }
  const float tf = static_cast<float>(t);

  for (int s0 = 0; s0 < t_len; s0 += kTile) {
    const int n_live = min(kTile, t_len - s0);
    const size_t tile = base + static_cast<size_t>(s0) * C;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
      const bool in = i < n_live * C;
      qs[i] = in ? to_f32(q[tile + i]) : 0.f;
      gs[i] = in ? to_f32(g[tile + i]) : 0.f;
    }
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = i < n_live;
      wsh[i] = in ? w[rbase + s0 + i] : 0.f;
      lsh[i] = in ? lse[rbase + s0 + i] : INFINITY;  // p = 0 past T
      dsh[i] = in ? delta[rbase + s0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const int s = s0 + j;
      float sc = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sc = fmaf(kr[c], qs[j * C + c], sc);
        dp = fmaf(vr[c], gs[j * C + c], dp);
      }
      sc = fmaf(-wsh[j], fabsf(tf - static_cast<float>(s)), sc);
      sc = (s == t) ? -100.f : sc;
      const float p = __expf(sc - lsh[j]);
      const float ds = (s == t) ? 0.f : p * (dp - dsh[j]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dv_t[c] = fmaf(p, gs[j * C + c], dv_t[c]);
        dk_t[c] = fmaf(ds, qs[j * C + c], dk_t[c]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      store(dk + koff + c, dk_t[c]);
      store(dv + koff + c, dv_t[c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* w,
                   const void* out, const void* g, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, float* dw,
                   int rows, int t_len, int c, cudaStream_t stream) {
  const dim3 grid((t_len + kThreads - 1) / kThreads, rows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(g);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaError_t err;
  switch (c) {
#define AERO_WIDTH(C)                                                        \
  case C:                                                                    \
    local_attention_bwd_dq_kernel<T, C><<<grid, kThreads, 0, stream>>>(      \
        qt, kt, vt, w, ot, gt, lse, delta, dqt, dw, t_len);                  \
    err = cudaGetLastError();                                                \
    if (err != cudaSuccess) return err;                                      \
    local_attention_bwd_dkv_kernel<T, C><<<grid, kThreads, 0, stream>>>(     \
        qt, kt, vt, w, gt, lse, delta, dkt, dvt, t_len);                     \
    break;
    AERO_FOR_EACH_WIDTH(AERO_WIDTH)
#undef AERO_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, g (the gradient of out), dq, dk, dv: contiguous
// [rows, t_len, c] of dtype (0 = float32, 1 = bfloat16); w, lse (from the
// forward), delta (scratch) and dw: contiguous float32 [rows, t_len].
// Launches the query-major kernel, then the key-major kernel that reads
// its delta, on `stream`; allocates nothing and does not synchronize.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int aero_local_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* w,
                                        const void* out, const void* g,
                                        const void* lse, void* delta,
                                        void* dq, void* dk, void* dv, void* dw,
                                        int rows, int t_len, int c, int dtype,
                                        void* stream) {
  if (rows <= 0 || rows > 65535 || t_len <= 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  float* dwf = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, wf, out, g, lf, df, dq, dk, dv, dwf, rows,
                         t_len, c, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, wf, out, g, lf, df, dq, dk, dv, dwf,
                                 rows, t_len, c, st);
  return cudaErrorInvalidValue;
}
