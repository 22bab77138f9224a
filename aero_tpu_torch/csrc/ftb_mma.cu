// Fused FTB tail in bfloat16 on Hopper's tensor cores (sm_90a, mma.sync).
//
// Replaces, for bfloat16, the TPU kernel _kernel of aero_tpu/ops/ftb.py
// (line 48, called through ftb_tail), as the float32 kernel of ftb.cu does
// for float32. The function and its roundings are ftb.cu's: for each
// (b, f),
//
//   out[o, t] = relu(sum_c Ka[c, o] a[c, t] + Kb[c, o] x[c, t] + b2[o])
//   a[c, t]   = bf16(h[c, t] * y[c, t])
//
// with bfloat16 x, y, h, Ka and Kb, float32 sums and b2, and the output
// rounded to bfloat16. Per (b, f) it is one GEMM [C' x 2C] . [2C x T].
//
// What bounds it on this card: bytes. It reads x and y and writes out
// once, 3 passes over [B, C, F, T] (0.88 ms at enc0's [16, 48, 256, 2501]
// at 3.35 TB/s), against 4 C C' FLOP per (b, f, t): 94 GFLOP at enc0,
// about 0.1 ms at the tensor-core rate, and within reach of mma.sync. So
// no wgmma: the design moves each byte once, keeps the products out of
// device memory, and takes the FMAs off the CUDA cores (ftb.cu's limit at
// enc2 and enc3).
//
// Design:
// - kSplit blocks per (b, f), one warp per 16 output channels (C' <= 192,
//   12 warps). A warp holds its 16 rows of [Ka; Kb]^T as mma.sync A
//   fragments in registers for the whole launch (ops/ftb.py pack_ftb_mma
//   lays them out per lane, C and C' zero-padded to multiples of 16);
// - block s of a (b, f) takes its time tiles s, s + kSplit, ...: the
//   kSplit blocks run side by side, so each channel row is read in runs of
//   kSplit tiles at a time, not in scattered tile-wide pieces; the blocks
//   of one b are neighbours, so their h tiles meet in L2;
// - tiles of kTime steps of y and x come into shared memory as [c][t] rows
//   by cp.async, in a ring of kStages, rows padded so that ldmatrix hits
//   32 distinct banks. T is odd at the model's shapes, so a channel row
//   starts at any 2-byte phase; all C rows of one (b, f) share it when the
//   channel stride F T 2 is a multiple of the piece, so the tiles start at
//   that phase, pieces are the largest of 16, 8, 4 or 2 bytes that F T 2
//   and the distance of x from y allow, and a piece that crosses t = 0 or
//   T copies element by element. Each thread walks its pieces without a
//   division per piece: at enc0 the loads' index arithmetic, not the
//   products, is the larger part of the instructions;
// - h comes as [B, T, C] (the wrapper transposes it, 1/F of x's bytes):
//   its [t][c] rows are contiguous in c, so its tiles come by cp.async too,
//   and ldmatrix (not .trans) on them gives the fragments that
//   ldmatrix.trans gives on y's [c][t] rows. The two multiply in registers
//   as bfloat16 pairs, each product rounded once: the TPU's y * h in bf16;
// - the epilogue adds b2, applies the ReLU and stores bfloat16 pairs along
//   t, unchecked inside T when the rows' pairs are 4-byte aligned, else
//   element by element.

#include <stdint.h>

#include "mma.cuh"

namespace {

using aero::cp_async;
using aero::cp_async_commit;
using aero::cp_async_wait;
using aero::ldmatrix_x4;
using aero::ldmatrix_x4_trans;
using aero::mma_bf16;
using aero::mul_bf16x2;
using aero::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 12;  // output channels <= 16 kMaxWarps
constexpr int kStages = 2;     // tiles in shared memory: in flight + 1

// Tile shape by the k-steps KS of the input channels (C = 48, 96, 192 at
// enc0-1, enc2, enc3: KS = 3, 6, 12), from tools/kernel_variants.py on the
// card: time steps per tile, and blocks per (b, f). At enc0-1 many small
// blocks keep more bytes in flight; at enc2-3 each extra block would load
// its warps' A fragments (up to 147 KB) once more, and at enc3 12 k-steps
// of them leave registers for 32 steps only.
template <int KS>
constexpr int kTime = KS > 4 && KS <= 8 ? 64 : 32;
template <int KS>
constexpr int kSplit = KS <= 4 ? 16 : 1;
template <int KS>
constexpr int kTLd = kTime<KS> + 8;  // y, x row stride (bf16): distinct banks
template <int KS>
constexpr int kHLd = 16 * KS + 8;    // h^T row stride (bf16): distinct banks
// one stage: y and x [16 KS][kTLd], h^T [kTime][kHLd]
template <int KS>
constexpr int kStageElems = 2 * 16 * KS * kTLd<KS> + kTime<KS> * kHLd<KS>;
template <int KS>
constexpr size_t kSmemBytes = sizeof(bf16) * kStages * kStageElems<KS>;

// `bytes` (16, 8, 4 or 2) from src to shared dst; zeros where !valid
__device__ __forceinline__ void copy_piece(bf16* dst, const bf16* src, int bytes,
                                           bool valid) {
  switch (bytes) {
    case 16:
      cp_async<16>(dst, src, valid);
      break;
    case 8:
      cp_async<8>(dst, src, valid);
      break;
    case 4:
      cp_async<4>(dst, src, valid);
      break;
    default:
      *dst = valid ? *src : __float2bfloat16(0.f);
  }
}

// A thread's share of a [rows][per_row] grid of pieces, walked as i =
// tid, tid + n, ... with no division per piece.
struct Walk {
  int r, p, dr, dp, per_row;
  __device__ Walk(int per_row_, int n) : per_row(per_row_) {
    r = threadIdx.x / per_row;
    p = threadIdx.x % per_row;
    dr = n / per_row;
    dp = n % per_row;
  }
  __device__ void next() {
    r += dr;
    p += dp;
    if (p >= per_row) {
      p -= per_row;
      ++r;
    }
  }
};

template <int KS>
__global__ void __launch_bounds__(kMaxWarps * 32)
ftb_tail_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                    const bf16* __restrict__ ht, const uint4* __restrict__ w,
                    const float* __restrict__ b2, bf16* __restrict__ out, int c_in,
                    int c_out, int f_len, int t_len, int piece, int h_piece) {
  constexpr int kCp = 16 * KS;  // input channels, zero-padded
  constexpr int kT = kTime<KS>;
  constexpr int kLd = kTLd<KS>;
  constexpr int kLdh = kHLd<KS>;
  constexpr int kBlocks = kSplit<KS>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [kStages][y | x | h^T]

  const int n_threads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int split = blockIdx.x % kBlocks;
  const int f = (blockIdx.x / kBlocks) % f_len, b = blockIdx.x / kBlocks / f_len;
  const size_t plane = static_cast<size_t>(f_len) * t_len;  // channel stride
  const size_t row0 = (static_cast<size_t>(b) * c_in * f_len + f) * t_len;
  const bf16* xr = x + row0;  // channel 0 of (b, f) at t = 0
  const bf16* yr = y + row0;
  const bf16* hr = ht + static_cast<size_t>(b) * t_len * c_in;

  // the padding channels c_in..kCp-1 stay zero: cp.async never writes them
  const int n_pad = kCp - c_in;
  for (int i = threadIdx.x; i < kStages * 3 * kT * n_pad; i += n_threads) {
    const int stage = i / (3 * kT * n_pad);
    const int rem = i - stage * 3 * kT * n_pad;
    bf16* st = tiles + stage * kStageElems<KS>;
    if (rem < 2 * kT * n_pad) {  // rows c_in.. of y (0) and x (1)
      const int m = rem / (kT * n_pad), j = rem % (kT * n_pad);
      st[m * kCp * kLd + (c_in + j / kT) * kLd + j % kT] = __float2bfloat16(0.f);
    } else {  // columns c_in.. of h^T
      const int j = rem - 2 * kT * n_pad;
      st[2 * kCp * kLd + (j / n_pad) * kLdh + c_in + j % n_pad] = __float2bfloat16(0.f);
    }
  }

  // Tiles start where every row of y and x is piece-aligned: t_first in
  // (-pe, 0], then every kT steps; columns outside [0, T) are zeros. The
  // block takes tiles split, split + kBlocks, ...: the kBlocks blocks of
  // one (b, f) run side by side, so each row is read in runs of kBlocks
  // tiles.
  const int pe = piece / 2;  // elements per piece
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(xr) % piece) / 2);
  const int t_first = -phase;
  const int n_tiles = (t_len - t_first + kT - 1) / kT;
  const int n_mine = (n_tiles - split + kBlocks - 1) / kBlocks;
  const int h_pe = h_piece / 2;

  auto load = [&](int k) {  // the block's k-th tile into stage k % kStages
    if (k < n_mine) {
      const int t0 = t_first + (split + k * kBlocks) * kT;
      bf16* ys = tiles + (k % kStages) * kStageElems<KS>;
      bf16* hs = ys + 2 * kCp * kLd;
      // [2 c_in rows][pieces]: y, then x
      for (Walk it(kT / pe, n_threads); it.r < 2 * c_in; it.next()) {
        const int m = it.r >= c_in, c = it.r - m * c_in;
        const int t = t0 + it.p * pe;
        const bf16* src = (m ? xr : yr) + c * plane + t;
        bf16* dst = ys + (m * kCp + c) * kLd + it.p * pe;
        if (t >= 0 && t + pe <= t_len) {
          copy_piece(dst, src, piece, true);
        } else {
          for (int e = 0; e < pe; ++e)
            dst[e] = (t + e >= 0 && t + e < t_len) ? src[e] : __float2bfloat16(0.f);
        }
      }
      for (Walk it(c_in / h_pe, n_threads); it.r < kT; it.next()) {  // h^T
        const int t = t0 + it.r;
        const bool in = t >= 0 && t < t_len;
        copy_piece(hs + it.r * kLdh + it.p * h_pe,
                   in ? hr + static_cast<size_t>(t) * c_in + it.p * h_pe : hr, h_piece, in);
      }
    }
    cp_async_commit();  // one group a tile, empty or not
  };
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // A fragments [k-step][register]: k-steps 0..KS-1 Ka^T, KS..2KS-1 Kb^T
  uint32_t wa[2 * KS][4];
  const uint4* wt = w + (static_cast<size_t>(warp) * 32 + lane) * 2 * KS;
#pragma unroll
  for (int kk = 0; kk < 2 * KS; ++kk) {
    const uint4 v = wt[kk];
    wa[kk][0] = v.x;
    wa[kk][1] = v.y;
    wa[kk][2] = v.z;
    wa[kk][3] = v.w;
  }
  // accumulator rows g and g + 8: output channels o, their rows of (b, f)
  float bias[2];
  bf16* orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = warp * 16 + g + 8 * r;
    bias[r] = o < c_out ? b2[o] : 0.f;
    orow[r] = o < c_out ? out + (static_cast<size_t>(b) * c_out + o) * plane + f * static_cast<size_t>(t_len)
                        : nullptr;
  }
  // output pairs (t, t + 1) of every row are 4-byte aligned at even t - t_first
  const uintptr_t out0 = reinterpret_cast<uintptr_t>(out) +
                         2 * ((static_cast<size_t>(b) * c_out * f_len + f) * t_len) - 2 * phase;
  const bool pairs = plane % 2 == 0 && (out0 & 3) == 0;

  const int mtx = lane >> 3, rr = lane & 7;
  for (int k = 0; k < n_mine; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k has landed for all; tile k - 1 is consumed
    load(k + kStages - 1);
    const bf16* ys = tiles + (k % kStages) * kStageElems<KS>;
    const bf16* xs = ys + kCp * kLd;
    const bf16* hs = xs + kCp * kLd;

    float acc[kT / 8][4];
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    // Ka^T (h * y): B fragments of y by ldmatrix.trans on [c][t], of h by
    // ldmatrix on [t][c], multiplied pairwise
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t yb[4], hb[4];
        ldmatrix_x4_trans(yb, ys + (kk * 16 + (mtx & 1) * 8 + rr) * kLd + (2 * np + (mtx >> 1)) * 8);
        ldmatrix_x4(hb, hs + (np * 16 + (mtx >> 1) * 8 + rr) * kLdh + kk * 16 + (mtx & 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) yb[j] = mul_bf16x2(yb[j], hb[j]);
        mma_bf16(acc[2 * np], wa[kk], yb[0], yb[1]);
        mma_bf16(acc[2 * np + 1], wa[kk], yb[2], yb[3]);
      }
    // Kb^T x
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t xb[4];
        ldmatrix_x4_trans(xb, xs + (kk * 16 + (mtx & 1) * 8 + rr) * kLd + (2 * np + (mtx >> 1)) * 8);
        mma_bf16(acc[2 * np], wa[KS + kk], xb[0], xb[1]);
        mma_bf16(acc[2 * np + 1], wa[KS + kk], xb[2], xb[3]);
      }

    const int t0 = t_first + (split + k * kBlocks) * kT;
    const bool inner = pairs && t0 >= 0 && t0 + kT <= t_len;  // block-uniform
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (orow[r] == nullptr) continue;
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) {
        const int t = t0 + nt * 8 + 2 * qd;
        const float v0 = fmaxf(acc[nt][2 * r] + bias[r], 0.f);
        const float v1 = fmaxf(acc[nt][2 * r + 1] + bias[r], 0.f);
        bf16* p = orow[r] + t;
        if (inner) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
        } else {
          if (t >= 0 && t < t_len) p[0] = __float2bfloat16(v0);
          if (t + 1 >= 0 && t + 1 < t_len) p[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// the largest of 16, 8, 4, 2 that divides n
inline int piece_of(uintptr_t n) {
  int p = 16;
  while (p > 2 && n % p != 0) p /= 2;
  return p;
}

template <int KS>
cudaError_t launch_ks(const void* x, const void* y, const void* ht, const void* w,
                      const float* b2, void* out, int batch, int c_in, int c_out,
                      int f_len, int t_len, cudaStream_t stream) {
  auto kernel = ftb_tail_mma_kernel<KS>;
  const cudaError_t err = aero::allow_smem(kernel, kSmemBytes<KS>);
  if (err != cudaSuccess) return err;
  // y and x rows share one phase: the channel stride and x - y in bytes
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  const int piece = piece_of((2 * static_cast<uintptr_t>(f_len) * t_len) | (xa - ya));
  const int h_piece = piece_of((2 * static_cast<uintptr_t>(c_in)) | reinterpret_cast<uintptr_t>(ht));
  const long long blocks = static_cast<long long>(batch) * f_len * kSplit<KS>;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), 32 * ((c_out + 15) / 16), kSmemBytes<KS>, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const bf16*>(ht),
      static_cast<const uint4*>(w), b2, static_cast<bf16*>(out), c_in, c_out, f_len, t_len, piece,
      h_piece);
  return cudaGetLastError();
}

}  // namespace

// x, y, out: contiguous bfloat16 [batch, c_in or c_out, f_len, t_len]; ht:
// contiguous bfloat16 [batch, t_len, c_in] (h transposed); w: the A
// fragments of pack_ftb_mma (ops/ftb.py), bfloat16 [ceil(c_out / 16), 32,
// 2 ceil(c_in / 16), 4, 2]; b2: float32 [c_out]. c_in and c_out at most
// 192. Launches on `stream`, allocates nothing and does not synchronize.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aero_ftb_tail_mma(const void* x, const void* y, const void* ht,
                                 const void* w, const void* b2, void* out, int batch,
                                 int c_in, int c_out, int f_len, int t_len, void* stream) {
  if (batch <= 0 || c_in <= 0 || c_out <= 0 || c_out > 16 * kMaxWarps || f_len <= 0 ||
      t_len <= 0)
    return cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((c_in + 15) / 16) {
#define AERO_KSTEPS(KS) \
  case KS:              \
    return launch_ks<KS>(x, y, ht, w, bf, out, batch, c_in, c_out, f_len, t_len, st);
    AERO_KSTEPS(1) AERO_KSTEPS(2) AERO_KSTEPS(3) AERO_KSTEPS(4) AERO_KSTEPS(5) AERO_KSTEPS(6)
    AERO_KSTEPS(7) AERO_KSTEPS(8) AERO_KSTEPS(9) AERO_KSTEPS(10) AERO_KSTEPS(11) AERO_KSTEPS(12)
#undef AERO_KSTEPS
    default:
      return cudaErrorInvalidValue;
  }
}
