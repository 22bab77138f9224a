// Fused FTB tail for Hopper (sm_90a): the entry point of the float32
// kernel. bfloat16 runs on the tensor cores (ftb_mma.cu); the float32 FMAs
// here hold the float32 check (1e-5 of max) that bfloat16 products cannot.
//
// Replaces the TPU kernel _kernel of aero_tpu/ops/ftb.py (line 48, called
// through ftb_tail): the end of the frequency transform block after the
// frequency mix y = W_freq x (a matmul outside), with the eval BatchNorm
// folded into Ka, Kb and b2:
//
//   out[b, o, f, t] = relu(sum_c a[b,c,f,t] Ka[c,o] + x[b,c,f,t] Kb[c,o] + b2[o])
//   a[b, c, f, t]   = h[b, c, t] * y[b, c, f, t]   (rounded to the storage dtype)
//
// in the port's layout: x, y, out [B, C, F, T], h [B, C, T], Ka and Kb
// [C, C'] in the storage dtype, b2 float32 [C'], sums in float32.
//
// What bounds it on this card: it reads x and y and writes out once, 3
// passes over [B, C, F, T] (0.88 ms at enc0's [16, 48, 256, 2501] in bf16
// at 3.35 TB/s), against 4 C C' FLOP per (b, f, t): 94 GFLOP at enc0, 0.095
// ms at the bf16 tensor-core rate. Bytes bound it, so the design reads each
// input element once per output-channel tile and keeps the products out of
// device memory. This first version does its FMAs on the CUDA cores
// (1.4 ms of float32 FMA at enc0 at the card's peak), which the tensor
// cores would lift.
//
// Design (simple and right first):
// - one block per (output-channel tile, tile of 256 time steps, f, b), one
//   thread per time step t. A thread reads x, y and h of its t for one
//   input channel at a time (neighbouring threads, neighbouring t:
//   coalesced) and adds both products into OT float32 accumulators;
// - the tile's slices of Ka and Kb, [C, OT] each, sit in shared memory as
//   float32 and are read as broadcast float4s. At C = 192 the whole of Ka
//   and Kb (295 KB in float32) would not fit a block, hence the
//   output-channel tiles of at most 64 (98 KB at C = 192);
// - the output-channel tile is the fastest-varying block index, so the
//   blocks that read the same x and y run together and share them in L2;
// - the epilogue adds b2, applies the ReLU and stores OT channels of t.

#include "common.cuh"

namespace {

using aero::round_to;
using aero::store;
using aero::to_f32;

constexpr int kThreadsT = 256;  // time steps per block, one per thread

template <typename T, int OT>
__global__ void __launch_bounds__(kThreadsT)
ftb_tail_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ h, const T* __restrict__ ka,
                const T* __restrict__ kb, const float* __restrict__ b2,
                T* __restrict__ out, int c_in, int c_out, int f_len, int t_len,
                int n_otiles, int n_ttiles) {
  extern __shared__ __align__(16) float wsm[];  // [c_in][2][OT]: Ka, Kb

  long long idx = blockIdx.x;
  const int ot = static_cast<int>(idx % n_otiles);
  idx /= n_otiles;
  const int tt = static_cast<int>(idx % n_ttiles);
  idx /= n_ttiles;
  const int f = static_cast<int>(idx % f_len);
  const int b = static_cast<int>(idx / f_len);
  const int o0 = ot * OT;

  for (int i = threadIdx.x; i < c_in * OT; i += kThreadsT) {
    const int c = i / OT;
    const int o = i - c * OT;
    const bool in = o0 + o < c_out;
    const size_t src = static_cast<size_t>(c) * c_out + o0 + o;
    wsm[(2 * c) * OT + o] = in ? to_f32(ka[src]) : 0.f;
    wsm[(2 * c + 1) * OT + o] = in ? to_f32(kb[src]) : 0.f;
  }
  __syncthreads();

  const int t = tt * kThreadsT + threadIdx.x;
  const bool live = t < t_len;
  float acc[OT];
#pragma unroll
  for (int o = 0; o < OT; ++o) acc[o] = (o0 + o < c_out) ? b2[o0 + o] : 0.f;

  const size_t plane = static_cast<size_t>(f_len) * t_len;  // one channel
  const size_t xoff = (static_cast<size_t>(b) * c_in * f_len + f) * t_len + t;
  const size_t hoff = static_cast<size_t>(b) * c_in * t_len + t;
  for (int c = 0; c < c_in; ++c) {
    float xv = 0.f;
    float av = 0.f;
    if (live) {
      xv = to_f32(x[xoff + c * plane]);
      av = round_to<T>(to_f32(h[hoff + static_cast<size_t>(c) * t_len]) *
                       to_f32(y[xoff + c * plane]));
    }
    const float4* wa = reinterpret_cast<const float4*>(wsm + (2 * c) * OT);
    const float4* wb = reinterpret_cast<const float4*>(wsm + (2 * c + 1) * OT);
#pragma unroll
    for (int q = 0; q < OT / 4; ++q) {
      const float4 a = wa[q];
      const float4 k = wb[q];
      acc[4 * q] = fmaf(av, a.x, fmaf(xv, k.x, acc[4 * q]));
      acc[4 * q + 1] = fmaf(av, a.y, fmaf(xv, k.y, acc[4 * q + 1]));
      acc[4 * q + 2] = fmaf(av, a.z, fmaf(xv, k.z, acc[4 * q + 2]));
      acc[4 * q + 3] = fmaf(av, a.w, fmaf(xv, k.w, acc[4 * q + 3]));
    }
  }

  if (live) {
    T* o_ptr = out + (static_cast<size_t>(b) * c_out * f_len + f) * t_len + t;
#pragma unroll
    for (int o = 0; o < OT; ++o)
      if (o0 + o < c_out)
        store(o_ptr + static_cast<size_t>(o0 + o) * plane, fmaxf(acc[o], 0.f));
  }
}

template <typename T, int OT>
cudaError_t launch_tile(const void* x, const void* y, const void* h,
                        const void* ka, const void* kb, const float* b2,
                        void* out, int batch, int c_in, int c_out, int f_len,
                        int t_len, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(c_in) * OT;
  if (smem > aero::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ftb_tail_kernel<T, OT>;
  cudaError_t err = aero::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_otiles = (c_out + OT - 1) / OT;
  const int n_ttiles = (t_len + kThreadsT - 1) / kThreadsT;
  const long long blocks = static_cast<long long>(n_otiles) * n_ttiles * f_len * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreadsT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(h), static_cast<const T*>(ka),
      static_cast<const T*>(kb), b2, static_cast<T*>(out), c_in, c_out, f_len,
      t_len, n_otiles, n_ttiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* h, const void* ka,
                   const void* kb, const float* b2, void* out, int batch,
                   int c_in, int c_out, int f_len, int t_len, int tile,
                   cudaStream_t stream) {
  switch (tile) {
#define AERO_TILE(OT)                                                       \
  case OT:                                                                  \
    return launch_tile<T, OT>(x, y, h, ka, kb, b2, out, batch, c_in, c_out, \
                              f_len, t_len, stream);
    AERO_TILE(16) AERO_TILE(32) AERO_TILE(48) AERO_TILE(64)
#undef AERO_TILE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y, out: contiguous [batch, c_in or c_out, f_len, t_len]; h: [batch,
// c_in, t_len]; ka, kb: [c_in, c_out], all of dtype 0 (float32; bfloat16
// takes aero_ftb_tail_mma); b2: float32 [c_out]. tile (16, 32, 48 or 64) is the
// output channels per block. Launches on `stream`, allocates nothing and
// does not synchronize. Returns the launch's cudaError_t (0 on success).
extern "C" int aero_ftb_tail(const void* x, const void* y, const void* h,
                             const void* ka, const void* kb, const void* b2,
                             void* out, int batch, int c_in, int c_out,
                             int f_len, int t_len, int tile, int dtype,
                             void* stream) {
  if (batch <= 0 || c_in <= 0 || c_out <= 0 || f_len <= 0 || t_len <= 0)
    return cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, h, ka, kb, bf, out, batch, c_in, c_out, f_len,
                         t_len, tile, st);
  return cudaErrorInvalidValue;
}
