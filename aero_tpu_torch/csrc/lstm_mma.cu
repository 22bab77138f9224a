// Bidirectional LSTM recurrence in bfloat16 on Hopper's tensor cores
// (sm_90a, mma.sync).
//
// Replaces, for bfloat16, the TPU kernel _kernel of aero_tpu/ops/lstm.py
// (line 54), as the float32 kernel of lstm.cu does for float32; the
// function, the layouts (xp [T, 8H, N], out [T, 2H, N], the reverse
// direction walked by indexing) and the roundings are lstm.cu's: gates
// and c in float32, h rounded to bfloat16 every step. W_hh holds bfloat16
// values and h is bfloat16, so W_hh h is exactly a bfloat16 x bfloat16 ->
// float32 product, the TPU kernel's dot with preferred_element_type=f32.
//
// What bounds it on this card: the bytes of xp and out (0.19 ms at the
// serving shapes) under a latency floor: the 200 steps depend on each
// other, and each is a product, the pointwise cell update (three
// sigmoids and two tanhs per unit and sequence, on the special-function
// unit and the CUDA cores) and a barrier.
//
// Design:
// - a block owns kSeq sequences of one direction, with H/8 warps. kSeq is
//   8, 16 or 32 (8 alone at H > 96, for registers), chosen by the caller
//   from N (seq_tile in ops/lstm.py): a step's latency grows with the
//   (unit, sequence) pairs a thread updates, 2 per 8 sequences, so where N
//   leaves SMs idle (a batch-1 forward: 14 blocks of 32 at N 208) smaller
//   tiles spread the same steps over more SMs; where N fills the card the
//   larger tile shares each W_hh fragment and barrier among more
//   sequences. Warp r owns hidden units 8r..8r+7 and the four gates of
//   each. Its W_hh rows are two m16 tiles, (i, f) and
//   (g, o) of those 8 units, held as mma.sync A fragments in registers
//   for the whole launch (pack_w_hh_mma in ops/lstm.py lays them out per
//   lane, K zero-padded to a multiple of 16), loaded once;
// - so each thread's accumulators hold all four gates of the same (unit,
//   sequence) pairs: c stays in registers, no gate passes through shared
//   memory;
// - h_{t-1} of the block's sequences sits in shared memory as bfloat16
//   [sequence][H] (exact: h is rounded every step), double-buffered, so a
//   step needs one barrier; B fragments are 32-bit reads of rows padded
//   to hit distinct banks;
// - xp streams through a ring of kStages shared-memory buffers with
//   cp.async, issued kStages - 1 steps ahead, and the accumulators start
//   from xp_t + bias (the bias in registers). Global loads into
//   registers one step ahead leave their latency in every step: the
//   step's shared-memory reads wait on them. cp.async copies 16 bytes
//   where N % 8 == 0 and 8 where N % 4 == 0, which every N of the model
//   has (B x F x frames with F a multiple of 4; at batch 1, N % 8 is 4
//   wherever F is 4 and the frames odd); another N copies with plain
//   loads and stores, which leave their latency in the step;
// - the pointwise update, on the special-function unit, is the largest
//   part of a step once the product is on the tensor cores, so sigmoid is
//   __fdividef(1, 1 + __expf(-x)) (ex2.approx and rcp.approx, a few ulp
//   in float32, against expf's and IEEE division's longer sequences) and
//   tanh(x) = 2 sigmoid(2x) - 1.

#include "mma.cuh"

namespace {

using aero::mma_bf16;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_sfu(float x) { return fmaf(2.f, sigmoid(2.f * x), -1.f); }

constexpr int kStages = 4;  // xp ring: steps in flight + 1

// shared memory of one block: h [2][kSeq][kHLd] and the xp ring
// [kStages][4H][kXLd], in bfloat16; row strides of 4 (mod 8) words, so
// a warp's fragment reads hit 32 distinct banks
template <int H>
constexpr int kHLd = 16 * ((H + 15) / 16) + 8;
template <int kSeq>
constexpr int kXLd = (kSeq < 16 ? 16 : kSeq) + 8;
template <int H, int kSeq>
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * (2 * kSeq * kHLd<H> + kStages * 4 * H * kXLd<kSeq>);

template <int H, int kSeq>
__global__ void __launch_bounds__(4 * H)
lstm_recurrence_mma_kernel(const bf16* __restrict__ xp, const uint4* __restrict__ w,
                           const float* __restrict__ bias, bf16* __restrict__ out,
                           int t_len, int n) {
  constexpr int kSteps = (H + 15) / 16;  // k16 steps, K zero-padded
  constexpr int kSeqTiles = kSeq / 8;    // n8 tiles
  constexpr int kLd = kHLd<H>;           // h row stride (bf16), distinct banks
  constexpr int kXld = kXLd<kSeq>;       // xp row stride (bf16), distinct banks
  constexpr int kStage = 4 * H * kXld;   // one step's xp of the block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);  // h [2][kSeq][kLd]
  bf16* xs = hs + 2 * kSeq * kLd;            // xp [kStages][4H][kXld]

  const int dir = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int unit = warp * 8 + g;  // accumulator rows g and g + 8
  const int seq0 = blockIdx.x * kSeq;
  const size_t ns = static_cast<size_t>(n);
  // rows of xp and out start 16-aligned (N % 8 == 0), 8-aligned (N % 4 ==
  // 0) or 4-aligned (N even: out's bfloat16 pairs)
  const int vec = n % 8 == 0 ? 8 : (n % 4 == 0 ? 4 : 1);  // xp copy, elements

  // A fragments [m-tile][k-step][register]: m-tile 0 rows (i, f), 1 (g, o)
  uint32_t wa[2][kSteps][4];
  const uint4* wt = w + ((static_cast<size_t>(dir) * (H / 8) + warp) * 32 + lane) * 2 * kSteps;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint4 x = wt[mt * kSteps + kk];
      wa[mt][kk][0] = x.x;
      wa[mt][kk][1] = x.y;
      wa[mt][kk][2] = x.z;
      wa[mt][kk][3] = x.w;
    }
  float b[4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt)
    b[gt] = bias == nullptr ? 0.f : bias[dir * 4 * H + gt * H + unit];
  for (int i = threadIdx.x; i < 2 * kSeq * kLd; i += 4 * H) hs[i] = __float2bfloat16(0.f);
  float c[kSeqTiles][2];
#pragma unroll
  for (int nt = 0; nt < kSeqTiles; ++nt) c[nt][0] = c[nt][1] = 0.f;

  // step's xp rows gate*H + unit, sequences seq0.. -> ring buffer
  // step % kStages (nothing past the last step); sequences >= n read 0
  auto stage_x = [&](int step) {
    if (step < t_len) {
      const int t = dir == 0 ? step : t_len - 1 - step;
      const bf16* src = xp + (static_cast<size_t>(t) * 8 * H + dir * 4 * H) * ns + seq0;
      bf16* dst = xs + (step % kStages) * kStage;
      if (vec == 8) {
        for (int i = threadIdx.x; i < 4 * H * (kSeq / 8); i += 4 * H) {
          const int r = i / (kSeq / 8), j = 8 * (i % (kSeq / 8));
          const bool in = seq0 + j < n;
          aero::cp_async<16>(dst + r * kXld + j, in ? src + r * ns + j : xp, in);
        }
      } else if (vec == 4) {
        for (int i = threadIdx.x; i < 4 * H * (kSeq / 4); i += 4 * H) {
          const int r = i / (kSeq / 4), j = 4 * (i % (kSeq / 4));
          const bool in = seq0 + j < n;
          aero::cp_async<8>(dst + r * kXld + j, in ? src + r * ns + j : xp, in);
        }
      } else {
        for (int i = threadIdx.x; i < 4 * H * kSeq; i += 4 * H) {
          const int r = i / kSeq, j = i % kSeq;
          dst[r * kXld + j] = seq0 + j < n ? src[r * ns + j] : __float2bfloat16(0.f);
        }
      }
    }
    aero::cp_async_commit();  // one group a step, empty or not
  };

  for (int i = 0; i < kStages - 1; ++i) stage_x(i);
  aero::cp_async_wait<kStages - 2>();  // step 0's xp has landed
  __syncthreads();                     // ... for all; h_0 = 0 is in place
  for (int step = 0; step < t_len; ++step) {
    const int t = dir == 0 ? step : t_len - 1 - step;
    stage_x(step + kStages - 1);  // into the buffer step - 1 read
    // accumulators [mt][nt]: rows g (gate 2mt) and g + 8 (gate 2mt + 1) of
    // unit, sequences nt*8 + 2qd, +1; they start from xp_t + bias
    const bf16* xb = xs + (step % kStages) * kStage + unit * kXld + 2 * qd;
    float acc[2][kSeqTiles][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kSeqTiles; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bf162 x = *reinterpret_cast<const bf162*>(xb + (2 * mt + hf) * H * kXld + nt * 8);
          acc[mt][nt][2 * hf] = __low2float(x) + b[2 * mt + hf];
          acc[mt][nt][2 * hf + 1] = __high2float(x) + b[2 * mt + hf];
        }

    const bf16* hb = hs + (step & 1) * kSeq * kLd;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int nt = 0; nt < kSeqTiles; ++nt) {
        const bf16* hr = hb + (nt * 8 + g) * kLd + kk * 16 + 2 * qd;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(hr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(hr + 8);
        mma_bf16(acc[0][nt], wa[0][kk], b0, b1);
        mma_bf16(acc[1][nt], wa[1][kk], b0, b1);
      }

    bf16* hn = hs + ((step + 1) & 1) * kSeq * kLd;
    bf16* ot = out + (static_cast<size_t>(t) * 2 * H + dir * H + unit) * ns;
#pragma unroll
    for (int nt = 0; nt < kSeqTiles; ++nt) {
      float hv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float gi = acc[0][nt][j], gf = acc[0][nt][2 + j];
        const float gg = acc[1][nt][j], go = acc[1][nt][2 + j];
        c[nt][j] = sigmoid(gf) * c[nt][j] + sigmoid(gi) * tanh_sfu(gg);
        hv[j] = sigmoid(go) * tanh_sfu(c[nt][j]);
      }
      const bf162 hp = __floats2bfloat162_rn(hv[0], hv[1]);
      const int sl = nt * 8 + 2 * qd;
      hn[sl * kLd + unit] = hp.x;
      hn[(sl + 1) * kLd + unit] = hp.y;
      const int s = seq0 + sl;
      if (n % 2 == 0 && s < n) {
        *reinterpret_cast<bf162*>(ot + s) = hp;
      } else {
        if (s < n) ot[s] = hp.x;
        if (s + 1 < n) ot[s + 1] = hp.y;
      }
    }
    aero::cp_async_wait<kStages - 2>();  // step + 1's xp has landed
    __syncthreads();  // ... for all; h_t is complete; h_{t-1} and xp_t are read
  }
}

template <int H, int kSeq>
cudaError_t launch_tile(const void* xp, const void* w, const float* bias, void* out,
                        int t_len, int n, cudaStream_t stream) {
  auto kernel = lstm_recurrence_mma_kernel<H, kSeq>;
  const cudaError_t err = aero::allow_smem(kernel, kSmemBytes<H, kSeq>);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kSeq - 1) / kSeq, 2);
  kernel<<<grid, 4 * H, kSmemBytes<H, kSeq>, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const uint4*>(w), bias,
      static_cast<bf16*>(out), t_len, n);
  return cudaGetLastError();
}

// the tiles seq_tile (ops/lstm.py) can pick: 8, 16 and 32 up to H 96, 8
// above
template <int H>
cudaError_t launch_hidden(const void* xp, const void* w, const float* bias, void* out,
                          int t_len, int n, int seq_tile, cudaStream_t stream) {
  if (seq_tile == 8) return launch_tile<H, 8>(xp, w, bias, out, t_len, n, stream);
  if constexpr (H <= 96) {
    if (seq_tile == 16) return launch_tile<H, 16>(xp, w, bias, out, t_len, n, stream);
    if (seq_tile == 32) return launch_tile<H, 32>(xp, w, bias, out, t_len, n, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

namespace aero {

// The bfloat16 recurrence (arguments of aero_lstm_recurrence, w the
// fragments of pack_w_hh_mma, seq_tile the sequences of a block).
cudaError_t lstm_recurrence_mma(const void* xp, const void* w, const float* bias,
                                void* out, int t_len, int hidden, int n, int seq_tile,
                                cudaStream_t stream) {
  switch (hidden) {
#define AERO_HIDDEN(U) \
  case 8 * U:          \
    return launch_hidden<8 * U>(xp, w, bias, out, t_len, n, seq_tile, stream);
    AERO_HIDDEN(1) AERO_HIDDEN(2) AERO_HIDDEN(3) AERO_HIDDEN(4)
    AERO_HIDDEN(5) AERO_HIDDEN(6) AERO_HIDDEN(7) AERO_HIDDEN(8)
    AERO_HIDDEN(9) AERO_HIDDEN(10) AERO_HIDDEN(11) AERO_HIDDEN(12)
    AERO_HIDDEN(13) AERO_HIDDEN(14) AERO_HIDDEN(15) AERO_HIDDEN(16)
#undef AERO_HIDDEN
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace aero
