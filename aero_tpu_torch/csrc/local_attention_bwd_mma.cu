// LocalState attention backward in bfloat16 on Hopper's tensor cores
// (sm_90a, mma.sync).
//
// Replaces, for bfloat16, the TPU kernel _pallas_bwd_kernel of
// aero_tpu/ops/attention.py (line 422) and, with a band, the banded
// operator's VJP (line 618), as the float32 kernels of
// local_attention_bwd.cu do for float32; the function is stated there:
// p recomputed from the forward's log-sum-exp, D_s = <out_s, g_s>,
// dv_t = sum_s p g_s (the diagonal's tiny p included), ds = p (<v_t, g_s>
// - D_s) with 0 on the diagonal, dq = ds k, dk = ds^T q, dw_s = -sum_t ds
// |t - s|, p = 0 outside a band.
//
// Roundings: scores, p, ds, D and every sum in float32, as the TPU
// kernel's. The products ds K, ds^T Q and p^T G take ds and p rounded to
// bfloat16, mma.sync's inputs, where the TPU kernel keeps them in float32
// (attention.py:477-487): the one rounding the TPU kernel does not make,
// as the forward already rounds p for P V. dw sums the float32 ds.
//
// What bounds it on this card: the exponentials. Each (query, key) pair
// needs p, and each of the two kernels recomputes it, so 2 ex2 per pair:
// twice the forward's exp floor. Every C'-long product of a pair (S and
// dP in both kernels, dQ, dK, dV) runs on the tensor cores; what is left
// per pair on the CUDA cores is the decay FMA, the exp's argument, ds and
// dw's FMA.
//
// Design: the two deterministic kernels of local_attention_bwd.cu, each in
// the shape of the forward (local_attention_mma.cu), no atomics:
// (a) query-major: a block owns 64 queries of one row, 16 per warp, with
//     Q and G as A fragments in registers; it writes D for (b). K/V tiles
//     of 64 keys stream through shared memory by cp.async, double-
//     buffered. Per tile S = Q K^T and dP = G V^T (mma.sync), ds in the
//     exp2 domain, dw as row sums of ds |t - s| by quad shuffles, then
//     dQ += dS K with dS packed to bfloat16 A fragments straight from the
//     accumulators and K's B fragments by ldmatrix.trans;
// (b) key-major: a block owns 64 keys, 16 per warp, with K and V as A
//     fragments; Q/G tiles of 64 queries stream in with their w, lse and
//     D. Per tile S^T = K Q^T and dP^T = V G^T, then dV += P^T G and
//     dK += dS^T Q, G and Q by ldmatrix.trans. Each accumulator column is
//     a query, so w_s, lse_s and D_s come from the tile's arrays in shared
//     memory.
// Only tiles on the diagonal, T or a band edge run the masks (a warp-
// uniform branch); tiles wholly outside a warp's band are skipped. Rows
// are padded to the MMA depth + 8 against bank conflicts, channels zero-
// padded to the depth (the next multiple of 16: 16, 32 or 48), as in the
// forward. At C' = 48 each of the dq, dk and dv accumulators is 6 n8 tiles
// (24 floats a thread), 1.5x width 32's.

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
constexpr int kRows = 16 * kWarps;  // queries (a) or keys (b) per block
constexpr int kTile = 64;           // keys (a) or queries (b) per tile
constexpr int kNTiles = kTile / 8;  // n8 tiles of S
constexpr float kLog2e = 1.4426950408889634f;

// Widths of one head: MMA depth, row stride and cp.async pieces.
template <int C>
struct Width {
  static constexpr int kDepth = (C + 15) / 16 * 16;  // channels zero-padded
  static constexpr int kSteps = kDepth / 16;         // k16 steps over C'
  static constexpr int kChan = kDepth / 8;           // n8 channel tiles
  static constexpr int kLd = kDepth + 8;             // shared row stride (bf16)
  static constexpr int kChunk = (2 * C) % 16 == 0 ? 16 : ((2 * C) % 8 == 0 ? 8 : 4);
  static constexpr int kChunks = 2 * C / kChunk;  // cp.async pieces per row
  static constexpr int kPad = kLd - C;
};

// Rows s0.. (rows >= end zero-filled) of two [T, C] tensors into [kTile][kLd]
// tiles; one group is committed by the caller.
template <int C>
__device__ __forceinline__ void load_rows(bf16* a_s, bf16* b_s, const bf16* a, const bf16* b,
                                          int s0, int end) {
  using W = Width<C>;
  for (int i = threadIdx.x; i < kTile * W::kChunks; i += kWarps * 32) {
    const int r = i / W::kChunks, part = i % W::kChunks;
    const int s = s0 + r;
    const bool in = s < end;
    const size_t src = static_cast<size_t>(in ? s : 0) * C + part * (W::kChunk / 2);
    const int dst = r * W::kLd + part * (W::kChunk / 2);
    cp_async<W::kChunk>(a_s + dst, a + src, in);
    cp_async<W::kChunk>(b_s + dst, b + src, in);
  }
}

// cp.async writes channels 0..C-1 only; 0 * garbage could be NaN
template <int C>
__device__ __forceinline__ void zero_padding(bf16* a_s, bf16* b_s) {
  using W = Width<C>;
  for (int i = threadIdx.x; i < 2 * kTile * W::kPad; i += kWarps * 32) {
    const int r = i / W::kPad, c = C + i % W::kPad;
    a_s[r * W::kLd + c] = __float2bfloat16(0.f);
    b_s[r * W::kLd + c] = __float2bfloat16(0.f);
  }
}

// A fragments of rows r0 + g, r0 + g + 8 of a [T, C] tensor (0 past T and C)
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&fa)[Width<C>::kSteps][4], const bf16* a,
                                       const int (&s_r)[2], int t_len, int qd) {
#pragma unroll
  for (int kk = 0; kk < Width<C>::kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s_r[j & 1], c = kk * 16 + 2 * qd + 8 * (j >> 1);
      fa[kk][j] = (s < t_len && c < C)
                      ? *reinterpret_cast<const uint32_t*>(a + static_cast<size_t>(s) * C + c)
                      : 0u;
    }
}

// acc[nt] += A (16 x depth) . B^T where B's rows are the tile's rows nt*8..
template <int C>
__device__ __forceinline__ void scores(float (&acc)[kNTiles][4],
                                       const uint32_t (&fa)[Width<C>::kSteps][4],
                                       const bf16* tile, int g, int qd) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Width<C>::kSteps; ++kk) {
      const bf16* r = tile + (nt * 8 + g) * Width<C>::kLd + kk * 16 + 2 * qd;
      mma_bf16(acc[nt], fa[kk], *reinterpret_cast<const uint32_t*>(r),
               *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

// acc += X . tile, X (16 x kTile) the accumulators x packed to bfloat16 A
// fragments, the tile [kTile][kLd] read as B by ldmatrix.trans
template <int C>
__device__ __forceinline__ void accumulate(float (&acc)[Width<C>::kChan][4],
                                           const float (&x)[kNTiles][4], const bf16* tile,
                                           int lane) {
  const int mtx = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t xa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xa[2 * h] = pack_bf16(x[2 * kc + h][0], x[2 * kc + h][1]);
      xa[2 * h + 1] = pack_bf16(x[2 * kc + h][2], x[2 * kc + h][3]);
    }
#pragma unroll
    for (int cp = 0; cp < Width<C>::kChan / 2; ++cp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kc * 16 + (mtx & 1) * 8 + rr) * Width<C>::kLd +
                               (2 * cp + (mtx >> 1)) * 8);
      mma_bf16(acc[2 * cp], xa, b[0], b[1]);
      mma_bf16(acc[2 * cp + 1], xa, b[2], b[3]);
    }
  }
}

// rows s_r of acc (channels < C) as bfloat16 pairs into a [T, C] tensor
template <int C>
__device__ __forceinline__ void store_rows(bf16* a, const float (&acc)[Width<C>::kChan][4],
                                           const int (&s_r)[2], int t_len, int qd) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (s_r[r] >= t_len) continue;
    bf16* row = a + static_cast<size_t>(s_r[r]) * C;
#pragma unroll
    for (int c = 0; c < Width<C>::kChan; ++c) {
      const int ch = c * 8 + 2 * qd;
      if (ch < C)
        *reinterpret_cast<uint32_t*>(row + ch) = pack_bf16(acc[c][2 * r], acc[c][2 * r + 1]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
local_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const float* __restrict__ w,
                                  const bf16* __restrict__ out, const bf16* __restrict__ g,
                                  const float* __restrict__ lse, float* __restrict__ delta,
                                  bf16* __restrict__ dq, float* __restrict__ dw, int t_len,
                                  int band) {
  using W = Width<C>;
  __shared__ __align__(16) bf16 ks[2][kTile * W::kLd];
  __shared__ __align__(16) bf16 vs[2][kTile * W::kLd];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int row = blockIdx.y;
  const int q_lo = blockIdx.x * kRows;
  const int s_w = q_lo + warp * 16;  // the warp's first query
  const size_t base = static_cast<size_t>(row) * t_len * C;
  const size_t rbase = static_cast<size_t>(row) * t_len;
  zero_padding<C>(&ks[0][0], &vs[0][0]);

  // rows r = 0, 1 of the thread: queries s_w + g and s_w + g + 8
  int s_r[2];
  float nws[2], lim[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s_r[r] = s_w + gr + 8 * r;
    const bool live = s_r[r] < t_len;
    lim[r] = static_cast<float>(t_len - s_r[r]);
    nws[r] = live ? -w[rbase + s_r[r]] * kLog2e : 0.f;
    lse2[r] = live ? lse[rbase + s_r[r]] * kLog2e : INFINITY;  // p = 0 past T
  }
  uint32_t qa[W::kSteps][4], ga[W::kSteps][4], oa[W::kSteps][4];
  load_a<C>(qa, q + base, s_r, t_len, qd);
  load_a<C>(ga, g + base, s_r, t_len, qd);
  load_a<C>(oa, out + base, s_r, t_len, qd);
  // D_s = <out_s, g_s> in float32: the thread's channels, then the quad's
  float d_s[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < W::kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 o2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[kk][j]));
      const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ga[kk][j]));
      d_s[j & 1] = fmaf(o2.x, g2.x, fmaf(o2.y, g2.y, d_s[j & 1]));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_s[r] += __shfl_xor_sync(0xffffffffu, d_s[r], 1);
    d_s[r] += __shfl_xor_sync(0xffffffffu, d_s[r], 2);
    if (qd == 0 && s_r[r] < t_len) delta[rbase + s_r[r]] = d_s[r];
  }

  float acc[W::kChan][4];
#pragma unroll
  for (int c = 0; c < W::kChan; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float dws[2] = {0.f, 0.f};

  // the keys any query of this block sees: [q_lo - band, q_hi + band]
  const int k_lo = max(0, q_lo - band);
  const int k_end = min(t_len, min(q_lo + kRows, t_len) + band);
  const int n_tiles = (k_end - k_lo + kTile - 1) / kTile;
  const float bandf = static_cast<float>(band);

  load_rows<C>(ks[0], vs[0], k + base, v + base, k_lo, k_end);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_lo + it * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed for all; tile it - 1 is consumed
    if (it + 1 < n_tiles) {
      load_rows<C>(ks[(it + 1) & 1], vs[(it + 1) & 1], k + base, v + base, t0 + kTile, k_end);
      cp_async_commit();
    }
    if (t0 + kTile - 1 < s_w - band || t0 > s_w + 15 + band) continue;
    const bf16* kt = ks[it & 1];
    const bf16* vt = vs[it & 1];

    float sc[kNTiles][4], dp[kNTiles][4];
    scores<C>(sc, qa, kt, gr, qd);
    scores<C>(dp, ga, vt, gr, qd);
    // keys past k_end are zero-filled and masked here, as t >= T or
    // outside every query's band
    const bool masked = t0 + kTile > t_len || (t0 <= s_w + 15 && t0 + kTile > s_w) ||
                        s_w + 15 - t0 > band || t0 + kTile - 1 - s_w > band;
    float dbase[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dbase[r] = static_cast<float>(t0 + 2 * qd - s_r[r]);
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float d = dbase[r] + static_cast<float>(nt * 8 + (e & 1));  // t - s
        const float ad = fabsf(d);
        float x = fmaf(sc[nt][e], kLog2e, nws[r] * ad);
        if (masked) x = (d >= lim[r] || ad > bandf) ? -INFINITY : x;
        float ds = ex2(x - lse2[r]) * (dp[nt][e] - d_s[r]);
        if (masked) ds = d == 0.f ? 0.f : ds;
        dws[r] = fmaf(-ds, ad, dws[r]);
        sc[nt][e] = ds;
      }
    accumulate<C>(acc, sc, kt, lane);
  }

  store_rows<C>(dq + base, acc, s_r, t_len, qd);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dws[r] += __shfl_xor_sync(0xffffffffu, dws[r], 1);
    dws[r] += __shfl_xor_sync(0xffffffffu, dws[r], 2);
    if (qd == 0 && s_r[r] < t_len) dw[rbase + s_r[r]] = dws[r];
  }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
local_attention_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const float* __restrict__ w,
                                   const bf16* __restrict__ g, const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int t_len, int band) {
  using W = Width<C>;
  __shared__ __align__(16) bf16 qs[2][kTile * W::kLd];
  __shared__ __align__(16) bf16 gs[2][kTile * W::kLd];
  // the tile's queries: w, lse and D (zeros past the range: there Q and G
  // are zero-filled, so p multiplies zeros)
  __shared__ __align__(16) float wsh[2][kTile];
  __shared__ __align__(16) float lsh[2][kTile];
  __shared__ __align__(16) float dsh[2][kTile];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int row = blockIdx.y;
  const int k_lo = blockIdx.x * kRows;
  const int t_w = k_lo + warp * 16;  // the warp's first key
  const size_t base = static_cast<size_t>(row) * t_len * C;
  const size_t rbase = static_cast<size_t>(row) * t_len;
  zero_padding<C>(&qs[0][0], &gs[0][0]);

  int t_r[2];  // rows r = 0, 1 of the thread: keys t_w + g and t_w + g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) t_r[r] = t_w + gr + 8 * r;
  uint32_t ka[W::kSteps][4], va[W::kSteps][4];
  load_a<C>(ka, k + base, t_r, t_len, qd);
  load_a<C>(va, v + base, t_r, t_len, qd);

  float acc_dk[W::kChan][4], acc_dv[W::kChan][4];
#pragma unroll
  for (int c = 0; c < W::kChan; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[c][e] = acc_dv[c][e] = 0.f;

  // the queries any key of this block is seen by: [k_lo - band, k_hi + band]
  const int s_lo = max(0, k_lo - band);
  const int s_end = min(t_len, min(k_lo + kRows, t_len) + band);
  const int n_tiles = (s_end - s_lo + kTile - 1) / kTile;
  const float bandf = static_cast<float>(band);

  auto load = [&](int buf, int s0) {
    load_rows<C>(qs[buf], gs[buf], q + base, g + base, s0, s_end);
    for (int i = threadIdx.x; i < 3 * kTile; i += kWarps * 32) {
      const int which = i / kTile, j = i % kTile;
      const int s = s0 + j;
      const bool in = s < s_end;
      const float* src = (which == 0 ? w : which == 1 ? lse : delta) + rbase + (in ? s : 0);
      float* dst = (which == 0 ? wsh[buf] : which == 1 ? lsh[buf] : dsh[buf]) + j;
      cp_async<4>(dst, src, in);
    }
    cp_async_commit();
  };

  load(0, s_lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int s0 = s_lo + it * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed for all; tile it - 1 is consumed
    if (it + 1 < n_tiles) load((it + 1) & 1, s0 + kTile);
    if (s0 + kTile - 1 < t_w - band || s0 > t_w + 15 + band) continue;
    const int buf = it & 1;
    const bf16* qt = qs[buf];
    const bf16* gt = gs[buf];

    float sc[kNTiles][4], dp[kNTiles][4];
    scores<C>(sc, ka, qt, gr, qd);  // S^T: rows keys, columns queries
    scores<C>(dp, va, gt, gr, qd);  // dP^T
    const bool masked = (s0 <= t_w + 15 && s0 + kTile > t_w) || t_w + 15 - s0 > band ||
                        s0 + kTile - 1 - t_w > band;
    float dbase[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dbase[r] = static_cast<float>(t_r[r] - s0 - 2 * qd);
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      // columns s0 + nt*8 + 2qd and + 1: their queries' w, lse and D
      const int j = nt * 8 + 2 * qd;
      const float2 w2 = *reinterpret_cast<const float2*>(&wsh[buf][j]);
      const float2 l2 = *reinterpret_cast<const float2*>(&lsh[buf][j]);
      const float2 d2 = *reinterpret_cast<const float2*>(&dsh[buf][j]);
      const float nws[2] = {-w2.x * kLog2e, -w2.y * kLog2e};
      const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = e & 1;
        const float d = dbase[r] - static_cast<float>(nt * 8 + col);  // t - s
        const float ad = fabsf(d);
        float x = fmaf(sc[nt][e], kLog2e, nws[col] * ad);
        if (masked) {
          x = d == 0.f ? -100.f * kLog2e : x;
          x = ad > bandf ? -INFINITY : x;
        }
        const float p = ex2(x - lse2[col]);
        float ds = p * (dp[nt][e] - dd[col]);
        if (masked) ds = d == 0.f ? 0.f : ds;
        sc[nt][e] = p;
        dp[nt][e] = ds;
      }
    }
    accumulate<C>(acc_dv, sc, gt, lane);  // dV += P^T G
    accumulate<C>(acc_dk, dp, qt, lane);  // dK += dS^T Q
  }

  store_rows<C>(dk + base, acc_dk, t_r, t_len, qd);
  store_rows<C>(dv + base, acc_dv, t_r, t_len, qd);
}

}  // namespace

namespace aero {

cudaError_t local_attention_bwd_mma(const void* q, const void* k, const void* v, const float* w,
                                    const void* out, const void* g, const float* lse,
                                    float* delta, void* dq, void* dk, void* dv, float* dw,
                                    int rows, int t_len, int c, int band, cudaStream_t stream) {
  const dim3 grid((t_len + kRows - 1) / kRows, rows);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(out);
  const bf16* gb = static_cast<const bf16*>(g);
  cudaError_t err;
  switch (c) {
#define AERO_WIDTH(C)                                                                     \
  case C:                                                                                 \
    local_attention_bwd_dq_mma_kernel<C><<<grid, kWarps * 32, 0, stream>>>(               \
        qb, kb, vb, w, ob, gb, lse, delta, static_cast<bf16*>(dq), dw, t_len, band);      \
    err = cudaGetLastError();                                                             \
    if (err != cudaSuccess) return err;                                                   \
    local_attention_bwd_dkv_mma_kernel<C><<<grid, kWarps * 32, 0, stream>>>(              \
        qb, kb, vb, w, gb, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
        t_len, band);                                                                     \
    break;
    AERO_FOR_EACH_WIDTH(AERO_WIDTH)
#undef AERO_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace aero
