// Bidirectional LSTM recurrence for Hopper (sm_90a): the entry point, and
// the float32 kernel (bfloat16 runs on the tensor cores, lstm_mma.cu; the
// float32 kernel's FMAs hold the float32 checks that bfloat16 products
// cannot).
//
// Replaces the TPU kernel _kernel of aero_tpu/ops/lstm.py (line 54, called
// through lstm_time_scan): the sequential part of one BLSTM layer, both
// directions, with the input projection xp = x W_ih^T computed outside by
// one GEMM. Per direction d, step and sequence, in torch's gate order
// i, f, g, o:
//
//   gates = xp_t + bias + W_hh[d] h          (float32)
//   c     = sigmoid(f) c + sigmoid(i) tanh(g) (float32)
//   h     = sigmoid(o) tanh(c)                (rounded to the storage dtype)
//
// Layouts (aero_tpu_torch/ops/lstm.py): xp [T, 8H, N], row d*4H + gate*H
// + j; out [T, 2H, N], row d*H + j; both at the input's time t, so the
// reverse direction walks t = T-1 .. 0 by indexing. W_hh comes packed as
// [2, H(k), 8(warp), 4(gate), H/8(unit)] in float32, holding values of
// the storage dtype.
//
// What bounds it on this card: per launch it reads xp and writes out once
// (at N = 3328, H = 48 in bf16, 0.51 GB + 0.13 GB), against 2*4H*H FLOP
// per sequence, direction and step (24.5 GFLOP). In bf16 the bytes bound
// it (0.19 ms at 3.35 TB/s), but the 200 steps depend on each other:
// every step is a product, a barrier and a cell update, so a latency
// floor of 200 steps sits under any design. The TPU kernel ran one grid
// step per time step with the state in VMEM; here the time loop runs
// inside the block.
//
// Design of the float32 kernel (simple and right):
// - one block per (tile of 32 sequences, direction); 8 warps. Lane = the
//   sequence, so every xp load and out store of a warp is 32 neighbouring
//   elements. Warp r owns hidden units r*H/8 .. (r+1)*H/8 - 1 and computes
//   all four gates of each, so the cell update needs no exchange of gates:
//   c stays in registers;
// - W_hh of the direction is staged once in dynamic shared memory
//   (147 KB at H = 96); where it does not fit (H >= 120) it is read from
//   global memory through L1/L2;
// - h of the tile lives in shared memory;
//   per step: issue this step's xp loads, the product W_hh h with one
//   broadcast vector load of 4 weights per 4 FMAs, a barrier, the cell
//   update, h written back, a barrier;
// - sigmoid and tanh with expf and tanhf (full precision, float32).

#include "common.cuh"

namespace aero {
// lstm_mma.cu: the bfloat16 recurrence, w packed by pack_w_hh_mma
cudaError_t lstm_recurrence_mma(const void* xp, const void* w, const float* bias,
                                void* out, int t_len, int hidden, int n, int seq_tile,
                                cudaStream_t stream);
}  // namespace aero

namespace {

using aero::round_to;
using aero::store;
using aero::to_f32;

constexpr int kSeqTile = 32;  // sequences per block, one per lane
constexpr int kWarps = 8;     // warp r owns hidden units r*U .. r*U + U - 1

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T, int U>
__global__ void __launch_bounds__(kSeqTile * kWarps)
lstm_recurrence_kernel(const T* __restrict__ xp, const float* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int t_len, int n, int w_in_smem) {
  constexpr int H = 8 * U;
  constexpr int G = 4 * U;  // gate rows of one thread: 4 gates x U units
  constexpr int kBlock = kSeqTile * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);     // h [H][kSeqTile]
  float* bs = hs + H * kSeqTile;                  // bias [4H] of the direction
  float* ws = bs + 4 * H;                         // W_hh [H][kWarps][G]

  const int dir = blockIdx.y;
  const int lane = threadIdx.x;
  const int r = threadIdx.y;
  const int tid = r * kSeqTile + lane;
  const int seq = blockIdx.x * kSeqTile + lane;
  const bool live = seq < n;
  const size_t ns = static_cast<size_t>(n);

  const float* wd = w + static_cast<size_t>(dir) * 4 * H * H;
  const float* wp = wd;
  if (w_in_smem) {
    const float4* src = reinterpret_cast<const float4*>(wd);
    float4* dst = reinterpret_cast<float4*>(ws);
    for (int i = tid; i < H * H; i += kBlock) dst[i] = src[i];
    wp = ws;
  }
  for (int i = tid; i < H * kSeqTile; i += kBlock) hs[i] = 0.f;
  for (int i = tid; i < 4 * H; i += kBlock)
    bs[i] = bias == nullptr ? 0.f : bias[dir * 4 * H + i];
  __syncthreads();

  float c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) c[u] = 0.f;

  for (int step = 0; step < t_len; ++step) {
    const int t = dir == 0 ? step : t_len - 1 - step;
    // this step's projections, loaded first and used after the product
    const T* x_t = xp + (static_cast<size_t>(t) * 8 * H + dir * 4 * H + r * U) * ns + seq;
    float xv[G];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u)
        xv[g * U + u] = live ? to_f32(x_t[static_cast<size_t>(g * H + u) * ns]) : 0.f;

    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float hk = hs[k * kSeqTile + lane];
      // the same address across the warp: one broadcast per 4 weights
      const float4* wk = reinterpret_cast<const float4*>(wp + (k * kWarps + r) * G);
#pragma unroll
      for (int j = 0; j < G; j += 4) {
        const float4 wv = wk[j / 4];
        acc[j] = fmaf(wv.x, hk, acc[j]);
        acc[j + 1] = fmaf(wv.y, hk, acc[j + 1]);
        acc[j + 2] = fmaf(wv.z, hk, acc[j + 2]);
        acc[j + 3] = fmaf(wv.w, hk, acc[j + 3]);
      }
    }
    __syncthreads();  // every warp has read h_{t-1}

    T* o_t = out + (static_cast<size_t>(t) * 2 * H + dir * H + r * U) * ns + seq;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = r * U + u;
      const float gi = xv[u] + bs[j] + acc[u];
      const float gf = xv[U + u] + bs[H + j] + acc[U + u];
      const float gg = xv[2 * U + u] + bs[2 * H + j] + acc[2 * U + u];
      const float go = xv[3 * U + u] + bs[3 * H + j] + acc[3 * U + u];
      c[u] = sigmoid(gf) * c[u] + sigmoid(gi) * tanhf(gg);
      const float hv = round_to<T>(sigmoid(go) * tanhf(c[u]));
      hs[j * kSeqTile + lane] = hv;
      if (live) store(o_t + static_cast<size_t>(u) * ns, hv);
    }
    __syncthreads();  // h_t is complete
  }
}

template <typename T, int U>
cudaError_t launch_width(const void* xp, const void* w, const float* bias,
                         void* out, int t_len, int n, cudaStream_t stream) {
  constexpr int H = 8 * U;
  const size_t base = sizeof(float) * (static_cast<size_t>(H) * kSeqTile + 4 * H);
  const size_t w_bytes = sizeof(float) * 4 * static_cast<size_t>(H) * H;
  const bool in_smem = base + w_bytes <= aero::kMaxSmem;
  const size_t smem = base + (in_smem ? w_bytes : 0);
  auto kernel = lstm_recurrence_kernel<T, U>;
  cudaError_t err = aero::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kSeqTile - 1) / kSeqTile, 2);
  kernel<<<grid, dim3(kSeqTile, kWarps), smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const float*>(w), bias,
      static_cast<T*>(out), t_len, n, in_smem ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xp, const void* w, const float* bias, void* out,
                   int t_len, int hidden, int n, cudaStream_t stream) {
  switch (hidden) {
#define AERO_HIDDEN(U) \
  case 8 * U:          \
    return launch_width<T, U>(xp, w, bias, out, t_len, n, stream);
    AERO_HIDDEN(1) AERO_HIDDEN(2) AERO_HIDDEN(3) AERO_HIDDEN(4)
    AERO_HIDDEN(5) AERO_HIDDEN(6) AERO_HIDDEN(7) AERO_HIDDEN(8)
    AERO_HIDDEN(9) AERO_HIDDEN(10) AERO_HIDDEN(11) AERO_HIDDEN(12)
    AERO_HIDDEN(13) AERO_HIDDEN(14) AERO_HIDDEN(15) AERO_HIDDEN(16)
#undef AERO_HIDDEN
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// xp: contiguous [t_len, 8*hidden, n], out: [t_len, 2*hidden, n], both of
// dtype (0 = float32, 1 = bfloat16); w: the packed W_hh, for float32
// pack_w_hh's [2, hidden, 8, 4, hidden/8] float32, for bfloat16
// pack_w_hh_mma's fragments (ops/lstm.py); bias: null or float32
// [8*hidden]; seq_tile: the bfloat16 kernel's sequences per block (8, 16
// or 32; 8 at hidden > 96), not read for float32. hidden is a
// multiple of 8 up to 128. Launches on `stream`, allocates nothing and does
// not synchronize. Returns the launch's cudaError_t (0 on success).
extern "C" int aero_lstm_recurrence(const void* xp, const void* w,
                                    const void* bias, void* out, int t_len,
                                    int hidden, int n, int dtype, int seq_tile,
                                    void* stream) {
  if (t_len <= 0 || n <= 0) return cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xp, w, bf, out, t_len, hidden, n, st);
  if (dtype == 1)
    return aero::lstm_recurrence_mma(xp, w, bf, out, t_len, hidden, n, seq_tile, st);
  return cudaErrorInvalidValue;
}
