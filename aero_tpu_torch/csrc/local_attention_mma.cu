// LocalState attention forward in bfloat16 on Hopper's tensor cores
// (sm_90a, mma.sync).
//
// Replaces, for bfloat16, the same three TPU kernels as the float32 kernel
// of local_attention.cu: _pallas_kernel_resident (aero_tpu/ops/
// attention.py:298), _pallas_kernel (:240) and, through the band argument,
// _pallas_kernel_banded (:180). It computes the function stated there
// (scores <k_t, q_s> - w_s |t - s|, -100 on the diagonal, -inf for t >= T
// and outside a band, softmax over t, out_s = sum_t p v_t, the log-sum-exp
// when asked) with the TPU resident kernel's roundings: the scores and
// their softmax in float32, the unnormalised p rounded to bfloat16 for
// p V with float32 sums (its p.astype(v.dtype), attention.py:331), then
// divided by the float32 sum of p.
//
// What bounds it on this card: the exponential. Each (query, key) pair
// needs one exp, and the special-function unit does 16 a clock per SM: at
// the serving shape [128, 2501, 4, 12] that is 3.2e9 exps, about 0.8 ms,
// where the bytes take 0.01 ms and the tensor products 0.16 ms. So the
// two C'-long dot products of a pair go to the tensor cores, and what is
// left per pair on the CUDA cores is the decay FMA, a max, the exp's
// argument and a sum.
//
// Design (FlashAttention-2's shape):
// - a block owns 64 queries of one row, 16 per warp; each warp keeps its
//   Q fragment in registers for the whole launch, the C' channels zero-
//   padded to the MMA depth, the next multiple of 16 (16, 32 or 48: at
//   C' = 48, three k16 steps of Q K^T and six n8 output tiles of P V);
// - K/V tiles of 64 keys stream through shared memory as bfloat16 with
//   cp.async (pieces of 16, 8 or 4 bytes: a row of C' = 12 is 24 bytes),
//   double-buffered, one barrier per tile; rows padded to depth + 8 so the
//   fragment reads hit 32 distinct banks (a row is 12, 20 or 28 words:
//   the 8 rows g of a fragment start 4 banks apart); the padding stays
//   zero;
// - S = Q K^T with mma.m16n8k16 (float32 sums), then per element the decay
//   and the log2(e) scale in one FMA: the softmax runs in the exp2 domain
//   on ex2.approx, the -100 sentinel scaled alike, the lse converted back
//   on store. Only tiles that touch the diagonal, T or a band edge take
//   the masks (a warp-uniform branch); a tile wholly outside a warp's band
//   is skipped;
// - row max by quad shuffles, one rescale of the sums per tile; when the
//   running max is still -inf (a band that has not started) the rescale
//   subtracts 0, so no NaN appears;
// - P is packed to bfloat16 straight from the S accumulators into A
//   fragments, V's B fragments come from ldmatrix.trans, P V with
//   mma.m16n8k16;
// - the band visits keys [q_lo - W, q_hi + W] only; W >= T - 1 does the
//   exact kernel's arithmetic on every stored value, bit for bit.

#include "local_attention.cuh"
#include "mma.cuh"

namespace {

using aero::cp_async;
using aero::cp_async_commit;
using aero::cp_async_wait;
using aero::ex2;
using aero::ldmatrix_x4_trans;
using aero::mma_bf16;
using aero::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kQueries = 16 * kWarps;  // per block, 16 per warp
constexpr int kKeys = 64;              // per shared-memory tile
constexpr int kKeyTiles = kKeys / 8;   // n8 tiles of S
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// S accumulators -> scores in the exp2 domain. dbase[r] = t - s of the
// thread's first key column for its row r (queries g and g + 8); lim[r] =
// T - s (t >= T where t - s >= lim); nws[r] = -w_s log2(e).
template <bool kMasked>
__device__ __forceinline__ void log2_scores(float (&sc)[kKeyTiles][4],
                                            const float (&dbase)[2],
                                            const float (&nws)[2],
                                            const float (&lim)[2], float bandf) {
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float d = dbase[r] + static_cast<float>(nt * 8 + (e & 1));
      float x = fmaf(sc[nt][e], kLog2e, nws[r] * fabsf(d));
      if (kMasked) {
        x = d == 0.f ? -100.f * kLog2e : x;
        x = (d >= lim[r] || fabsf(d) > bandf) ? -INFINITY : x;
      }
      sc[nt][e] = x;
    }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
local_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ w,
                               bf16* __restrict__ out, float* __restrict__ lse,
                               int t_len, int band) {
  constexpr int kDepth = (C + 15) / 16 * 16;  // MMA depth, channels zero-padded
  constexpr int kSteps = kDepth / 16;         // k16 steps of Q K^T
  constexpr int kChan = kDepth / 8;           // n8 channel tiles of P V
  constexpr int kLd = kDepth + 8;             // shared row stride (bf16)
  constexpr int kChunk = (2 * C) % 16 == 0 ? 16 : ((2 * C) % 8 == 0 ? 8 : 4);
  constexpr int kChunks = 2 * C / kChunk;    // cp.async pieces per key row
  constexpr int kPad = kLd - C;
  __shared__ __align__(16) bf16 ks[2][kKeys * kLd];
  __shared__ __align__(16) bf16 vs[2][kKeys * kLd];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int row = blockIdx.y;
  const int q_lo = blockIdx.x * kQueries;
  const int s_w = q_lo + warp * 16;  // the warp's first query
  const size_t base = static_cast<size_t>(row) * t_len * C;

  // cp.async writes channels 0..C-1 only; 0 * garbage could be NaN
  for (int i = threadIdx.x; i < 2 * kKeys * kPad; i += kWarps * 32) {
    const int r = i / kPad, c = C + i % kPad;
    (&ks[0][0])[r * kLd + c] = __float2bfloat16(0.f);
    (&vs[0][0])[r * kLd + c] = __float2bfloat16(0.f);
  }

  // rows r = 0, 1 of the thread: queries s_w + g and s_w + g + 8
  int s_r[2];
  float sf[2], nws[2], lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s_r[r] = s_w + g + 8 * r;
    sf[r] = static_cast<float>(s_r[r]);
    lim[r] = static_cast<float>(t_len - s_r[r]);
    nws[r] = s_r[r] < t_len ? -w[static_cast<size_t>(row) * t_len + s_r[r]] * kLog2e : 0.f;
  }
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s_r[j & 1], c = kk * 16 + 2 * qd + 8 * (j >> 1);
      qa[kk][j] = (s < t_len && c < C)
                      ? *reinterpret_cast<const uint32_t*>(q + base + static_cast<size_t>(s) * C + c)
                      : 0u;
    }

  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's part of sum 2^(x - m)
  float o[kChan][4];
#pragma unroll
  for (int c = 0; c < kChan; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;

  // the keys any query of this block sees: [q_lo - band, q_hi + band]
  const int k_lo = max(0, q_lo - band);
  const int k_end = min(t_len, min(q_lo + kQueries, t_len) + band);
  const int n_tiles = (k_end - k_lo + kKeys - 1) / kKeys;
  const float bandf = static_cast<float>(band);

  // keys past k_end are zero-filled; their scores are masked to -inf
  auto load = [&](int buf, int t0) {
    for (int i = threadIdx.x; i < kKeys * kChunks; i += kWarps * 32) {
      const int key = i / kChunks, part = i % kChunks;
      const int t = t0 + key;
      const bool in = t < k_end;
      const size_t src = base + static_cast<size_t>(in ? t : 0) * C + part * (kChunk / 2);
      const int dst = key * kLd + part * (kChunk / 2);
      cp_async<kChunk>(&ks[buf][dst], k + src, in);
      cp_async<kChunk>(&vs[buf][dst], v + src, in);
    }
    cp_async_commit();
  };

  load(0, k_lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kKeys;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed for all; tile it - 1 is consumed
    if (it + 1 < n_tiles) load((it + 1) & 1, t0 + kKeys);
    if (t0 + kKeys - 1 < s_w - band || t0 > s_w + 15 + band) continue;
    const bf16* kt = ks[it & 1];
    const bf16* vt = vs[it & 1];

    float sc[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const bf16* kr = kt + (nt * 8 + g) * kLd + kk * 16 + 2 * qd;
        mma_bf16(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    float dbase[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dbase[r] = static_cast<float>(t0 + 2 * qd) - sf[r];
    const bool masked = t0 + kKeys > t_len || (t0 <= s_w + 15 && t0 + kKeys > s_w) ||
                        s_w + 15 - t0 > band || t0 + kKeys - 1 - s_w > band;
    if (masked)
      log2_scores<true>(sc, dbase, nws, lim, bandf);
    else
      log2_scores<false>(sc, dbase, nws, lim, bandf);

    float mref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      mref[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m[r] - mref[r]);
      l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < kChan; ++c) {
        o[c][2 * r] *= alpha;
        o[c][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }

#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* x = sc[2 * kc + h];
        const float p0 = ex2(x[0] - mref[0]), p1 = ex2(x[1] - mref[0]);
        const float p2 = ex2(x[2] - mref[1]), p3 = ex2(x[3] - mref[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * h] = pack_bf16(p0, p1);
        pa[2 * h + 1] = pack_bf16(p2, p3);
      }
      const int mtx = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int cp = 0; cp < kChan / 2; ++cp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kc * 16 + (mtx & 1) * 8 + rr) * kLd + (2 * cp + (mtx >> 1)) * 8);
        mma_bf16(o[2 * cp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * cp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s_r[r];
    if (s >= t_len) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* os = out + base + static_cast<size_t>(s) * C;
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const int ch = c * 8 + 2 * qd;
      if (ch < C)
        *reinterpret_cast<uint32_t*>(os + ch) = pack_bf16(o[c][2 * r] * inv, o[c][2 * r + 1] * inv);
    }
    if (lse != nullptr && qd == 0)
      lse[static_cast<size_t>(row) * t_len + s] = (m[r] + log2f(l[r])) * kLn2;
  }
}

}  // namespace

namespace aero {

cudaError_t local_attention_fwd_mma(const void* q, const void* k, const void* v,
                                    const float* w, void* out, float* lse, int rows,
                                    int t_len, int c, int band, cudaStream_t stream) {
  const dim3 grid((t_len + kQueries - 1) / kQueries, rows);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  switch (c) {
#define AERO_WIDTH(C)                                                  \
  case C:                                                              \
    local_attention_fwd_mma_kernel<C><<<grid, kWarps * 32, 0, stream>>>( \
        qb, kb, vb, w, ob, lse, t_len, band);                          \
    break;
    AERO_FOR_EACH_WIDTH(AERO_WIDTH)
#undef AERO_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace aero
