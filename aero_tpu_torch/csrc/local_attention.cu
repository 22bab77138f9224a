// LocalState attention forward for Hopper (sm_90a).
//
// Replaces the two TPU kernels of aero_tpu/ops/attention.py that compute
// this function: _pallas_kernel_resident (line 298, one program per
// batch*head row with the whole row in VMEM) and _pallas_kernel (line 240,
// gridded over query blocks with an online softmax). Their split was a
// VMEM budget; here one kernel serves every T.
//
// For each row r = b*H + h of the folded [rows, T, C] tensors:
//
//   scores[t, s] = <k_t, q_s> - w_s * |t - s|     (q pre-scaled by 1/sqrt(C))
//   scores[s, s] = -100                            (self-reference kill)
//   out_s        = sum_t softmax_t(scores)[t, s] * v_t
//   lse_s        = log sum_t exp(scores[t, s])     (only when asked for:
//                                                   the backward needs it)
//
// What bounds it on this card: the T^2 (query, key) pairs. Each pair costs
// 2*C FMAs (score and accumulate) and one exponential, against 4*C bytes of
// K/V per key that all queries of a block share. At C = 12 or 24 that is
// far above the card's bytes-per-operation balance, so the kernel is bound
// by FMA and MUFU (exp) issue and by shared-memory reads, not by HBM.
//
// Design (simple and right first; tensor cores, TMA and wgmma come later):
// - one block per (tile of kThreads queries, row); one thread per query,
//   holding q_s and an f32 accumulator of C values in registers;
// - keys stream through shared memory in tiles of kTile, converted to f32
//   once per tile; every thread reads the same key, so the reads broadcast;
// - online softmax in f32 per tile: scores of the tile into registers, one
//   rescale of the running sum per tile, one exp per (query, key);
// - keys t >= T are masked to -inf; queries s >= T compute and are not
//   stored.

#include "local_attention.cuh"

namespace {

using aero::kThreads;
using aero::kTile;
using aero::store;
using aero::to_f32;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
local_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ w,
                           T* __restrict__ out, float* __restrict__ lse,
                           int t_len) {
  __shared__ __align__(16) float ks[kTile * C];
  __shared__ __align__(16) float vs[kTile * C];

  const int row = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;  // this thread's query
  const bool live = s < t_len;
  const size_t base = static_cast<size_t>(row) * t_len * C;

  float qr[C];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = live ? to_f32(q[base + static_cast<size_t>(s) * C + c]) : 0.f;
    acc[c] = 0.f;
  }
  const float ws = live ? w[static_cast<size_t>(row) * t_len + s] : 0.f;
  const float sf = static_cast<float>(s);
  float m = -INFINITY;  // running max
  float l = 0.f;        // running sum of exp(score - m)

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

    float sc[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int t = t0 + j;
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) d = fmaf(qr[c], ks[j * C + c], d);
      d = fmaf(-ws, fabsf(static_cast<float>(t) - sf), d);
      d = (t == s) ? -100.f : d;
      d = (t < t_len) ? d : -INFINITY;
      sc[j] = d;
      tile_max = fmaxf(tile_max, d);
    }
    // Every tile holds at least one real key, so m_new is finite; on the
    // first tile m = -inf and alpha = 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = __expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(p, vs[j * C + c], acc[c]);
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + base + static_cast<size_t>(s) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) store(o + c, acc[c] * inv);
    if (lse != nullptr) lse[static_cast<size_t>(row) * t_len + s] = m + logf(l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* w,
                   void* out, float* lse, int rows, int t_len, int c,
                   cudaStream_t stream) {
  const dim3 grid((t_len + kThreads - 1) / kThreads, rows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (c) {
#define AERO_WIDTH(C)                                                        \
  case C:                                                                    \
    local_attention_fwd_kernel<T, C><<<grid, kThreads, 0, stream>>>(         \
        qt, kt, vt, w, ot, lse, t_len);                                      \
    break;
    AERO_FOR_EACH_WIDTH(AERO_WIDTH)
#undef AERO_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous [rows, t_len, c] of dtype (0 = float32,
// 1 = bfloat16); w: contiguous float32 [rows, t_len]; lse: null, or
// float32 [rows, t_len] that receives each query's log-sum-exp of scores.
// Launches on `stream`, allocates nothing and does not synchronize.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aero_local_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* w,
                                        void* out, void* lse, int rows,
                                        int t_len, int c, int dtype,
                                        void* stream) {
  if (rows <= 0 || rows > 65535 || t_len <= 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, wf, out, lf, rows, t_len, c, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, wf, out, lf, rows, t_len, c, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* aero_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
