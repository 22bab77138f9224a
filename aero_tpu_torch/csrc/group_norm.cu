// GroupNorm forward for Hopper (sm_90a) with the activation that follows it
// fused into the normalising pass: float32 or bfloat16 storage, float32
// statistics and arithmetic, one rounding to the storage dtype.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses the float32 upcasts into its reductions. The port's eager form
// (F.group_norm on a float32 copy, a cast back, then GELU, GLU or Snake as
// separate passes) moves about 28 bytes per bfloat16 element and gives
// each (sample, group) row to one block, so at batch 1 a handful of rows
// hold the card's 132 SMs.
//
//   y[n, c, s]  = x[n, c, s] * scale[n, c] + shift[n, c]
//   scale[n, c] = rstd[n, g(c)] * gamma[c],  shift = beta[c] - mean * scale
//   out         = act(y): none; GELU (exact erf); GLU over channels,
//                 y[n, c] * sigmoid(y[n, c + C/2]); Snake,
//                 y + sin^2(a y) / a with a = snake_a[n mod snake_rows]
//
// over x [N, C, S] (S the product of the trailing dims), G groups of C/G
// channels, the biased variance and eps as F.group_norm takes them.
//
// What bounds it on this card: bytes. A bfloat16 element is read twice
// (statistics, then apply) and written once: 6 bytes, against a few dozen
// float32 operations, far below the ridge. So the design keeps the float32
// copy out of device memory and spreads every row over many blocks:
//
// 1. gn_stats: grid rows x splits, each block a contiguous slice of one
//    row (splits chosen by the wrapper so that rows x splits fills the card
//    at batch 1 as at batch 16). Threads read 16-byte vectors of the
//    storage dtype and keep a float32 Welford triple (count, mean, M2),
//    merged by Chan's formula per group of vectors, across the warp by
//    shuffles and across the block through shared memory, all in a fixed
//    order: no atomics, so a replay gives the same bits. Each block writes
//    its triple to the scratch buffer `part` [rows, splits, 3].
// 2. gn_apply: grid samples x chunks of the output plane. Each block merges
//    its sample's partials per group (one warp a group, again in a fixed
//    order), folds gamma and beta into per-channel scale and shift in
//    shared memory, then streams its chunk with 16-byte loads and stores,
//    applying the activation in float32. GLU reads its two halves from the
//    same sample plane, C/2 channels apart. A misaligned chunk start or a
//    GLU half-plane that is not a multiple of the vector width falls back
//    to 2- or 4-byte accesses for the ragged part.

#include <stdint.h>

#include "common.cuh"

namespace {

using aero::store;
using aero::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // vectors in flight per thread

enum Act { kNone = 0, kGelu = 1, kGlu = 2, kSnake = 3 };

struct Welford {
  float n, mean, m2;
};

// Chan's parallel merge of two (count, mean, M2) triples.
__device__ __forceinline__ Welford merge(Welford a, Welford b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Welford warp_merge(Welford w) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Welford o{__shfl_xor_sync(0xffffffffu, w.n, off),
              __shfl_xor_sync(0xffffffffu, w.mean, off),
              __shfl_xor_sync(0xffffffffu, w.m2, off)};
    w = merge(w, o);
  }
  return w;
}

// 16 bytes of storage as float32 values
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  float v[kN];

  __device__ __forceinline__ void load(const T* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = to_f32(e[j]);
  }

  __device__ __forceinline__ void store_to(T* p) const {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) store(e + j, v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats(const T* __restrict__ x, float* __restrict__ part, int row_len,
         int splits, int chunk) {
  constexpr int V = Vec<T>::kN;
  __shared__ Welford warp_sums[kWarps];
  const long long row = blockIdx.x / splits;
  const int split = blockIdx.x - static_cast<int>(row * splits);
  const T* xr = x + row * row_len;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, row_len);
  const int tid = threadIdx.x;

  // [lo, vb) and [ve, hi) element by element, [vb, ve) in 16-byte vectors
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(xr + lo) / sizeof(T)) % V);
  const int vb = min(hi, lo + (mis ? V - mis : 0));
  const int nvec = (hi - vb) / V;
  const int ve = vb + nvec * V;

  Welford w{0.f, 0.f, 0.f};
  if (tid < vb - lo) w = merge(w, {1.f, to_f32(xr[lo + tid]), 0.f});
  if (tid < hi - ve) w = merge(w, {1.f, to_f32(xr[ve + tid]), 0.f});

  const T* xv = xr + vb;
  for (int v0 = tid; v0 < nvec; v0 += kThreads * kUnroll) {
    Vec<T> buf[kUnroll];
    int valid = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < nvec) {
        buf[u].load(xv + static_cast<long long>(v0 + u * kThreads) * V);
        valid = u + 1;
      }
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < valid)
#pragma unroll
        for (int j = 0; j < V; ++j) sum += buf[u].v[j];
    const float cnt = static_cast<float>(valid * V);
    const float mean = sum / cnt;
    float m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < valid)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = buf[u].v[j] - mean;
          m2 = fmaf(d, d, m2);
        }
    w = merge(w, {cnt, mean, m2});
  }

  w = warp_merge(w);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = w;
  __syncthreads();
  if (tid < 32) {
    w = tid < kWarps ? warp_sums[tid] : Welford{0.f, 0.f, 0.f};
    w = warp_merge(w);
    if (tid == 0) {
      float* p = part + 3 * static_cast<long long>(blockIdx.x);
      p[0] = w.n;
      p[1] = w.mean;
      p[2] = w.m2;
    }
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float ya, float yb, float a,
                                          float inv_a) {
  if (ACT == kGelu) return ya * 0.5f * (1.f + erff(ya * 0.70710678118654752f));
  if (ACT == kGlu) return ya * (1.f / (1.f + expf(-yb)));
  if (ACT == kSnake) {
    const float s = sinf(ya * a);
    return ya + inv_a * (s * s);
  }
  return ya;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, const float* __restrict__ part,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         const float* __restrict__ snake_a, T* __restrict__ out, int groups,
         int channels, int spatial, int splits, int chunk, int chunks,
         int snake_rows, float eps, int vec_ok) {
  constexpr int V = Vec<T>::kN;
  constexpr bool kGluAct = ACT == kGlu;
  extern __shared__ float smem[];  // mean, rstd [groups]; scale, shift [C]
  float* g_mean = smem;
  float* g_rstd = smem + groups;
  float* scale = smem + 2 * groups;
  float* shift = scale + channels;

  const long long n = blockIdx.x / chunks;
  const int k = blockIdx.x - static_cast<int>(n * chunks);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int g = warp; g < groups; g += kWarps) {
    const float* p = part + 3 * (n * groups + g) * splits;
    Welford w{0.f, 0.f, 0.f};
    for (int i = lane; i < splits; i += 32)
      w = merge(w, {p[3 * i], p[3 * i + 1], p[3 * i + 2]});
    w = warp_merge(w);
    if (lane == 0) {
      g_mean[g] = w.mean;
      g_rstd[g] = rsqrtf(fmaxf(w.m2 / w.n, 0.f) + eps);
    }
  }
  __syncthreads();
  const int per_group = channels / groups;
  for (int c = tid; c < channels; c += kThreads) {
    const int g = c / per_group;
    const float s = g_rstd[g] * gamma[c];
    scale[c] = s;
    shift[c] = fmaf(-s, g_mean[g], beta[c]);
  }
  __syncthreads();

  const int c_out = kGluAct ? channels / 2 : channels;
  const int plane_out = c_out * spatial;
  const int half = kGluAct ? plane_out : 0;  // the gate's offset in the plane
  const T* xin = x + n * channels * spatial;
  T* o = out + n * plane_out;
  float a = 1.f, inv_a = 1.f;
  if (ACT == kSnake) {
    a = snake_a[n % snake_rows];
    inv_a = 1.f / a;
  }

  const int lo = k * chunk;
  const int hi = min(lo + chunk, plane_out);
  int vb = hi;  // everything element by element unless vectors line up
  if (vec_ok) {
    const int mis = static_cast<int>((n * plane_out + lo) % V);
    vb = min(hi, lo + (mis ? V - mis : 0));
  }
  const int nvec = (hi - vb) / V;
  const int ve = vb + nvec * V;

  auto one = [&](int i) {
    const int c = i / spatial;
    const float ya = fmaf(to_f32(xin[i]), scale[c], shift[c]);
    float yb = 0.f;
    if (kGluAct)
      yb = fmaf(to_f32(xin[half + i]), scale[c_out + c], shift[c_out + c]);
    store(o + i, activate<ACT>(ya, yb, a, inv_a));
  };
  for (int i = lo + tid; i < vb; i += kThreads) one(i);
  for (int i = ve + tid; i < hi; i += kThreads) one(i);

  constexpr int kU = kGluAct ? 1 : 2;
  for (int v0 = tid; v0 < nvec; v0 += kThreads * kU) {
    Vec<T> va[kU], vg[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i0 = vb + (v0 + u * kThreads) * V;
      if (v0 + u * kThreads < nvec) {
        va[u].load(xin + i0);
        if (kGluAct) vg[u].load(xin + half + i0);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (v0 + u * kThreads >= nvec) break;
      const int i0 = vb + (v0 + u * kThreads) * V;
      int c = i0 / spatial;
      int s = i0 - c * spatial;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        while (s >= spatial) {
          s -= spatial;
          ++c;
        }
        const float ya = fmaf(va[u].v[j], scale[c], shift[c]);
        float yb = 0.f;
        if (kGluAct) yb = fmaf(vg[u].v[j], scale[c_out + c], shift[c_out + c]);
        va[u].v[j] = activate<ACT>(ya, yb, a, inv_a);
        ++s;
      }
      va[u].store_to(o + i0);
    }
  }
}

template <typename T, int ACT>
cudaError_t launch_apply(const void* x, const float* part, const float* gamma,
                         const float* beta, const float* snake_a, void* out,
                         int samples, int groups, int channels, int spatial,
                         int splits, int chunk, int chunks, int snake_rows,
                         float eps, int vec_ok, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (static_cast<size_t>(groups) + channels);
  if (smem > aero::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = gn_apply<T, ACT>;
  cudaError_t err = aero::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(static_cast<long long>(samples) * chunks),
           kThreads, smem, stream>>>(
      static_cast<const T*>(x), part, gamma, beta, snake_a, static_cast<T*>(out),
      groups, channels, spatial, splits, chunk, chunks, snake_rows, eps, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, float* part, const float* gamma,
                   const float* beta, const float* snake_a, void* out,
                   int samples, int groups, int channels, int spatial,
                   int splits, int chunk, int chunks, int out_chunk,
                   int snake_rows, float eps, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const int row_len = channels / groups * spatial;
  const long long rows = static_cast<long long>(samples) * groups;
  gn_stats<T><<<static_cast<unsigned>(rows * splits), kThreads, 0, stream>>>(
      static_cast<const T*>(x), part, row_len, splits, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec_ok = aligned && (act != kGlu || channels / 2 * spatial % V == 0);
  switch (act) {
#define AERO_ACT(A)                                                          \
  case A:                                                                    \
    return launch_apply<T, A>(x, part, gamma, beta, snake_a, out, samples,   \
                              groups, channels, spatial, splits, out_chunk,  \
                              chunks, snake_rows, eps, vec_ok, stream);
    AERO_ACT(kNone) AERO_ACT(kGelu) AERO_ACT(kGlu) AERO_ACT(kSnake)
#undef AERO_ACT
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: contiguous [samples, channels, spatial] and, with act 2 (GLU),
// out [samples, channels / 2, spatial], of dtype (0 = float32,
// 1 = bfloat16); gamma, beta: float32 [channels]; snake_a: float32
// [snake_rows], read by act 3 (Snake) alone; part: float32 scratch of
// samples * groups * splits * 3. act: 0 none, 1 GELU, 2 GLU, 3 Snake. Each
// (sample, group) row of channels / groups * spatial elements is reduced in
// `splits` slices of `chunk` elements, and each sample's output plane is
// written in `chunks` slices of `out_chunk` elements; both chunk sizes are
// multiples of 16 bytes' worth of elements. Launches the two kernels on
// `stream`, allocates nothing and does not synchronize. Returns the first
// launch's cudaError_t (0 on success).
extern "C" int aero_group_norm(const void* x, void* part, const void* gamma,
                               const void* beta, const void* snake_a, void* out,
                               int samples, int groups, int channels,
                               int spatial, int splits, int chunk, int chunks,
                               int out_chunk, int snake_rows, float eps,
                               int act, int dtype, void* stream) {
  if (samples <= 0 || groups <= 0 || channels <= 0 || spatial <= 0 ||
      splits <= 0 || chunk <= 0 || chunks <= 0 || out_chunk <= 0 ||
      channels % groups != 0 || (act == kGlu && channels % 2 != 0) ||
      (act == kSnake && (snake_a == nullptr || snake_rows <= 0)) ||
      static_cast<long long>(channels) * spatial > 0x7fffffffLL ||
      static_cast<long long>(splits) * chunk <
          static_cast<long long>(channels / groups) * spatial ||
      static_cast<long long>(samples) * groups * splits > 0x7fffffffLL ||
      static_cast<long long>(samples) * chunks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int c_out = act == kGlu ? channels / 2 : channels;
  if (static_cast<long long>(chunks) * out_chunk <
      static_cast<long long>(c_out) * spatial)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  const float* gf = static_cast<const float*>(gamma);
  const float* bf = static_cast<const float*>(beta);
  const float* af = static_cast<const float*>(snake_a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, p, gf, bf, af, out, samples, groups, channels,
                         spatial, splits, chunk, chunks, out_chunk, snake_rows,
                         eps, act, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, p, gf, bf, af, out, samples, groups,
                                 channels, spatial, splits, chunk, chunks,
                                 out_chunk, snake_rows, eps, act, st);
  return cudaErrorInvalidValue;
}
