// Fused resnet(+modulation) item for Hopper (sm_90a), channels-last [B, L, C].
//
// Replaces the TPU kernel `fused_resnet_item` (pl.pallas_call at
// audio_diffusion_tpu/ops/kernels/resnet.py:172, body `_item_kernel`). It
// computes, per item:
//
//   h = conv3(SiLU(GN1(x))) + b1              rounded to the activation type
//   y = x + conv3(SiLU(GN2(h))) + b2          rounded to the activation type
//   y = y + GNm(y) * (1 + scale_b) + shift_b  (modulated items only)
//
// GroupNorm statistics are the one-pass f32 moments E[x^2] - E[x]^2 with the
// variance clamped at 0, eps inside the rsqrt. Rounding points follow the
// Pallas body: the normalised, activated conv input is rounded to the
// activation type, conv sums and epilogues stay in f32.
//
// What bounds it on an H100: the two k=3 convolutions are 12*C^2*L FLOPs per
// batch row, and the item moves 2*L*C activations plus 6*C^2 weights. By that
// count (chip_smoke.py computes it per level) the shallow levels (C <= 64,
// L up to 2^18) and, at batch 1, the deepest ones (C = 1024, L <= 256, where
// the weights dominate) are bound by bytes, the middle levels by operations;
// either bound is a few microseconds per item. In practice the first limit is
// latency: few row tiles at the deep levels leave SMs idle, and each K chunk
// waits on its loads.
//
// What the design does about it. The TPU kernel keeps the whole [L, C] row in
// VMEM (grid = (B,)); no CTA can hold a 2^18-row level, so the item is a chain
// of launches:
//   gn_partial   per-(L tile, group) sums and sums of squares (stage 1),
//   gn_finalize  per-(batch, group) mean and rstd, in a fixed order (stage 2),
//   conv3        bf16: conv3_sm90_kernel (conv3_sm90.cuh), wgmma with A from
//                registers, a cp.async ring of K chunks, a tile per level and
//                deterministic split-K (then conv3_splitk_reduce), as
//                conv_plan() in ops/kernels/resnet.py picks them;
//                f32: conv3_kernel (resnet_common.cuh, shared with the
//                backward's data gradient), a 32 x 64 tile on CUDA-core FMAs.
//                Either normalises and activates its input tile in shared
//                memory, so the activated tensor never reaches device memory,
//   modulate     the elementwise modulation epilogue (in place unless the
//                caller keeps the unmodulated item for the backward).
// All reductions run in a fixed order, so the result is deterministic.
#include "conv3_sm90.cuh"
#include "resnet_common.cuh"

namespace {

constexpr int STATS_THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage 1: grid (n_tiles, B). Warp w sums groups w, w + 8, ... over the rows
// [tile * rows_per_tile, ...). partial: [B, n_tiles, G, 2] f32.
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                                  int L, int C, int G, int rows_per_tile) {
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int r0 = tile * rows_per_tile;
  const int rows = min(L, r0 + rows_per_tile) - r0;
  const int cpg = C / G;
  const T* xb = x + ((size_t)b * L + r0) * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += STATS_THREADS / 32) {
    float s = 0.f, q = 0.f;
    const int n = rows * cpg;
    for (int i = lane; i < n; i += 32) {
      const float v = to_f32(xb[(size_t)(i / cpg) * C + g * cpg + i % cpg]);
      s += v;
      q += v * v;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      float* p = partial + (((size_t)b * n_tiles + tile) * G + g) * 2;
      p[0] = s;
      p[1] = q;
    }
  }
}

// Stage 2: grid (B), one thread per group; tiles summed in order, in double.
__global__ void gn_finalize_kernel(const float* __restrict__ partial, float2* __restrict__ stats,
                                   int n_tiles, int G, float count, float eps) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    double s = 0.0, q = 0.0;
    for (int t = 0; t < n_tiles; ++t) {
      const float* p = partial + (((size_t)b * n_tiles + t) * G + g) * 2;
      s += p[0];
      q += p[1];
    }
    const float mean = (float)(s / count);
    const float var = fmaxf((float)(q / count) - mean * mean, 0.f);
    stats[(size_t)b * G + g] = make_float2(mean, rsqrtf(var + eps));
  }
}

// out <- y + ((y - mean) * rstd * gamma + beta) * (1 + scale[b, c]) + shift[b, c];
// out may be y itself.
template <typename T>
__global__ void modulate_kernel(const T* y, T* out, const float2* __restrict__ stats,
                                const T* __restrict__ gamma, const T* __restrict__ beta,
                                const T* __restrict__ scale, const T* __restrict__ shift,
                                int L, int C, int G, size_t total) {
  const int cpg = C / G;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    const size_t b = idx / ((size_t)L * C);
    const float2 ms = stats[b * G + c / cpg];
    const float v = to_f32(y[idx]);
    const float hm = (v - ms.x) * ms.y * to_f32(gamma[c]) + to_f32(beta[c]);
    out[idx] = from_f32<T>(v + hm * (1.f + to_f32(scale[b * C + c])) + to_f32(shift[b * C + c]));
  }
}

template <typename T>
int gn_stats(const T* x, float* partial, float2* stats, int B, int L, int C, int G,
             int rows_per_tile, float eps, cudaStream_t stream) {
  const int n_tiles = (L + rows_per_tile - 1) / rows_per_tile;
  gn_partial_kernel<T><<<dim3(n_tiles, B), STATS_THREADS, 0, stream>>>(x, partial, L, C, G,
                                                                        rows_per_tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<B, 32, 0, stream>>>(partial, stats, n_tiles, G, (float)L * (C / G), eps);
  return (int)cudaGetLastError();
}

// stats holds the three stages' statistics, [3, B, G] float2: of x, of h and
// of y. The backward reads them (and h and y) again.
template <typename T>
int item_forward(const T* x, const T* gn1s, const T* gn1b, const T* k1, const T* c1b,
                 const T* gn2s, const T* gn2b, const T* k2, const T* c2b, const T* mods,
                 const T* modb, const T* mgs, const T* mgb, T* h, T* y, T* out, float* partial,
                 float2* stats, int B, int L, int C, int G, int rows_per_tile, float eps,
                 int use_modulation, const int* plan, float* ws, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  const dim3 grid((L + BM - 1) / BM, (C + BN - 1) / BN, B);
  float2* stats1 = stats;
  float2* stats2 = stats + (size_t)B * G;
  float2* stats3 = stats + (size_t)2 * B * G;
  int err = gn_stats<T>(x, partial, stats1, B, L, C, G, rows_per_tile, eps, stream);
  if (err) return err;
  if constexpr (kBf16)
    err = (int)conv3_sm90<kForward>(plan[0], plan[1], plan[2], x, stats1, gn1s, gn1b, k1, c1b,
                                    nullptr, h, ws, B, L, C, G, plan[3], plan[4], stream);
  else
    conv3_kernel<T, kForward><<<grid, THREADS, 0, stream>>>(x, stats1, gn1s, gn1b, k1, c1b,
                                                            nullptr, h, L, C, G);
  if (err || (err = (int)cudaGetLastError())) return err;
  if ((err = gn_stats<T>(h, partial, stats2, B, L, C, G, rows_per_tile, eps, stream)))
    return err;
  if constexpr (kBf16)
    err = (int)conv3_sm90<kForwardResidual>(plan[0], plan[1], plan[2], h, stats2, gn2s, gn2b, k2,
                                            c2b, x, y, ws, B, L, C, G, plan[3], plan[4], stream);
  else
    conv3_kernel<T, kForwardResidual><<<grid, THREADS, 0, stream>>>(h, stats2, gn2s, gn2b, k2,
                                                                    c2b, x, y, L, C, G);
  if (err || (err = (int)cudaGetLastError())) return err;
  if (!use_modulation) return 0;
  if ((err = gn_stats<T>(y, partial, stats3, B, L, C, G, rows_per_tile, eps, stream)))
    return err;
  const size_t total = (size_t)B * L * C;
  const size_t want = (total + 255) / 256;
  const int blocks = want < 132 * 16 ? (int)want : 132 * 16;
  modulate_kernel<T><<<blocks, 256, 0, stream>>>(y, out, stats3, mgs, mgb, mods, modb, L, C, G,
                                                 total);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x, h, y, out: [B, L, C]; k1, k2: [3, C, C] (tap, in, out); vectors: [C];
// mods, modb: [B, C] (ignored unless use_modulation); partial: f32
// [B, ceil(L / rows_per_tile), G, 2]; stats: f32 [3, B, G, 2]. y receives the
// item before its modulation and out the item; without modulation only y is
// written; with it, y and out may be one buffer (the caller that keeps
// nothing for a backward passes the same pointer). bfloat16 only: conv_bn,
// conv_mt, conv_bk, conv_splits and conv_cps are the conv's tile and split
// (conv_plan() in ops/kernels/resnet.py), ws its f32 workspace of
// conv_splits * B * L * C values when conv_splits > 1. Returns the first
// CUDA error code seen after a launch, 0 on success. Launches on `stream`.
extern "C" int resnet_item_forward(int dtype, const void* x, const void* gn1s, const void* gn1b,
                                   const void* k1, const void* c1b, const void* gn2s,
                                   const void* gn2b, const void* k2, const void* c2b,
                                   const void* mods, const void* modb, const void* mgs,
                                   const void* mgb, void* h, void* y, void* out, void* partial,
                                   void* stats, int B, int L, int C, int G, int rows_per_tile,
                                   float eps, int use_modulation, int conv_bn, int conv_mt,
                                   int conv_bk, int conv_splits, int conv_cps, void* ws,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int plan[5] = {conv_bn, conv_mt, conv_bk, conv_splits, conv_cps};
  auto w = static_cast<float*>(ws);
  auto f2 = static_cast<float2*>(stats);
  auto p = static_cast<float*>(partial);
  if (dtype == 0) {
    using T = float;
    return item_forward<T>(
        (const T*)x, (const T*)gn1s, (const T*)gn1b, (const T*)k1, (const T*)c1b, (const T*)gn2s,
        (const T*)gn2b, (const T*)k2, (const T*)c2b, (const T*)mods, (const T*)modb,
        (const T*)mgs, (const T*)mgb, (T*)h, (T*)y, (T*)out, p, f2, B, L, C, G, rows_per_tile,
        eps, use_modulation, plan, w, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return item_forward<T>(
        (const T*)x, (const T*)gn1s, (const T*)gn1b, (const T*)k1, (const T*)c1b, (const T*)gn2s,
        (const T*)gn2b, (const T*)k2, (const T*)c2b, (const T*)mods, (const T*)modb,
        (const T*)mgs, (const T*)mgb, (T*)h, (T*)y, (T*)out, p, f2, B, L, C, G, rows_per_tile,
        eps, use_modulation, plan, w, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 conv's plan (tile bn x 64*mt rows, K chunks of bk, cps chunks per
// split) against the card: its dynamic shared memory and the CTAs that fit
// on one SM at once, for the record of how full the card is at each level.
// Returns the CUDA error code.
extern "C" int resnet_conv_plan_occupancy(int bn, int mt, int bk, int cps, int* smem,
                                          int* blocks_per_sm) {
  return (int)conv3_sm90<kForward>(bn, mt, bk, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 1, 1, cps, nullptr,
                                   smem, blocks_per_sm);
}
