// LocalState attention forward for Hopper (sm_90a): the entry point, and
// the float32 kernel.
//
// Replaces the three TPU kernels of aero_tpu/ops/attention.py that compute
// this function: _pallas_kernel_resident (line 298, one program per
// batch*head row with the whole row in VMEM), _pallas_kernel (line 240,
// gridded over query blocks with an online softmax) and
// _pallas_kernel_banded (line 180, the same with keys restricted to
// |t - s| <= W). Their split was a VMEM budget and a band; here one kernel
// per dtype serves every T, with the band as an argument. bfloat16 runs
// on the tensor cores (local_attention_mma.cu); float32 runs the kernel
// below, whose float32 FMAs hold the float32 checks (atol 1e-3 with TF32
// off) that bfloat16 products cannot.
//
// For each row r = b*H + h of the folded [rows, T, C] tensors:
//
//   scores[t, s] = <k_t, q_s> - w_s * |t - s|     (q pre-scaled by 1/sqrt(C))
//   scores[s, s] = -100                            (self-reference kill)
//   out_s        = sum_t softmax_t(scores)[t, s] * v_t
//   lse_s        = log sum_t exp(scores[t, s])     (only when asked for:
//                                                   the backward needs it)
//
// With a band W, scores[t, s] = -inf where |t - s| > W (the diagonal is
// always in the band, so every query keeps a finite score).
//
// What bounds the float32 kernel on this card: the T^2 (query, key)
// pairs. Each pair costs 2*C FMAs (score and accumulate) and one
// exponential, against 4*C bytes of K/V per key that all queries of a
// block share. At C = 12 or 24 that is far above the card's
// bytes-per-operation balance, so the kernel is bound by FMA and MUFU
// (exp) issue and by shared-memory reads, not by HBM.
//
// Design of the float32 kernel (simple and right):
// - one block per (tile of kThreads queries, row); one thread per query,
//   holding q_s and an f32 accumulator of C values in registers;
// - keys stream through shared memory in tiles of kTile; every thread
//   reads the same key, so the reads broadcast;
// - online softmax in f32 per tile: scores of the tile into registers, one
//   rescale of the running sum per tile, one exp per (query, key);
// - keys t >= T are masked to -inf; queries s >= T compute and are not
//   stored;
// - with a band, a block visits only the keys [q_lo - W, q_hi + W] of its
//   queries q_lo..q_hi, and masks |t - s| > W to -inf. A tile can then lie
//   wholly outside one thread's band: its running max stays -inf, and the
//   rescale subtracts 0 instead, so exp(-inf - -inf) never makes a NaN.

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
                           int t_len, int band) {
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
  const float bandf = static_cast<float>(band);
  float m = -INFINITY;  // running max
  float l = 0.f;        // running sum of exp(score - m)
  // the keys any query of this block sees: [q_lo - band, q_hi + band]
  const int q_lo = blockIdx.x * kThreads;
  const int k_lo = max(0, q_lo - band);
  const int k_end = min(t_len, min(q_lo + kThreads, t_len) + band);

  for (int t0 = k_lo; t0 < k_end; t0 += kTile) {
    const int n_valid = min(kTile, k_end - t0) * C;
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
      const float dist = fabsf(static_cast<float>(t) - sf);
      d = fmaf(-ws, dist, d);
      d = (t == s) ? -100.f : d;
      d = (t < k_end && dist <= bandf) ? d : -INFINITY;
      sc[j] = d;
      tile_max = fmaxf(tile_max, d);
    }
    // On the first tile with a key in this query's band, m = -inf and
    // alpha = 0. Before it, m_new = -inf too: subtract 0 instead, so that
    // alpha and every p are exp(-inf) = 0 and not NaN.
    const float m_new = fmaxf(m, tile_max);
    const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = __expf(m - m_ref);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = __expf(sc[j] - m_ref);
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
                   int band, cudaStream_t stream) {
  const dim3 grid((t_len + kThreads - 1) / kThreads, rows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (c) {
#define AERO_WIDTH(C)                                                        \
  case C:                                                                    \
    local_attention_fwd_kernel<T, C><<<grid, kThreads, 0, stream>>>(         \
        qt, kt, vt, w, ot, lse, t_len, band);                                \
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
// float32 [rows, t_len] that receives each query's log-sum-exp of scores;
// band: 0 for exact attention, else the half-width W of the band.
// Launches on `stream`, allocates nothing and does not synchronize.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aero_local_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* w,
                                        void* out, void* lse, int rows,
                                        int t_len, int c, int band, int dtype,
                                        void* stream) {
  if (rows <= 0 || rows > 65535 || t_len <= 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  float* lf = static_cast<float*>(lse);
  const int bw = aero::effective_band(band, t_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, wf, out, lf, rows, t_len, c, bw, st);
  if (dtype == 1)
    return aero::local_attention_fwd_mma(q, k, v, wf, out, lf, rows, t_len, c, bw, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* aero_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
