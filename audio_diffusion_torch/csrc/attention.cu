// The attention core of the attention item's inference forward for Hopper
// (sm_90a): jax.nn.dot_product_attention as the sampler and the service run
// it (bf16 activations, no gradient).
//
// The JAX package wrote no Pallas kernel here: audio_diffusion_tpu/ops/
// attention.py leaves LayerNorm and jax.nn.dot_product_attention to XLA,
// which fuses each into a few TPU kernels. Eager PyTorch does not fuse: one
// attention item's LayerNorms, logits, softmax, casts and head transposes
// are about 36 launches, and on the H100 the host's time to launch them, not
// the card, sets the pace of a sampling step at batch 1. With each LayerNorm
// one library launch (F.layer_norm), this kernel makes them three launches
// (ops/kernels/attention.py, PERF.md).
//
// attention_core_kernel: out[b, s, h*D + d] = sum_n p[s, n] v[b, n, h*D + d],
//   logits = (q . k) * D^-1/2   bf16 products summed in f32 (the JAX
//                               package's BF16_BF16_F32 preset), the scale
//                               applied in f32,
//   p = bf16(exp(logits - max) / sum exp(logits - max))   rounded once,
//   the output summed in f32 and rounded once to bf16.
// What bounds it: at the README's shapes (S = N <= 1024 keys, or S <= 4096
// queries over N = 64 keys, D = 64, 8 heads) 4*S*N*D FLOPs per head, a few
// microseconds on the tensor cores, against a read of q, k, v and a write of
// the output, about as long; the f32 logits of the plain form never exist
// here. In practice its time is latency: few CTAs and a chain of small tiles.
// What the design does about it:
//  - one warpgroup (128 threads) per 64 query rows x head x batch; the q tile
//    is read once into shared memory and held as wgmma A fragments;
//  - K and V arrive in 64-key tiles through a two-stage cp.async ring, so the
//    next tile is in flight while one is multiplied;
//  - S = Q K^T on wgmma (bf16 in, f32 accumulate), K-major B from K rows;
//  - two passes over the keys: the first finds each row's max m and sum l
//    (l rescaled in f32 as m grows), the second forms p = exp(s - m) / l,
//    rounds it to bf16 once and feeds it from registers as the A operand of
//    the P V wgmma (MN-major B from V rows). No rounded value is rescaled
//    afterwards; at these lengths the second read of K comes from L2;
//  - q, k and v are read through their strides straight from the
//    projections' outputs (the packed to_qkv [B, S, 3 H D], or to_q and
//    to_k/to_v), and the output is written as [B, S, H D] for to_out: no head
//    transposes and no f32 copies.
// No atomics: every sum runs in a fixed order, so reruns give the same bits.
#include <cmath>

#include "conv3_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ attention core

constexpr int ATT_THREADS = 128;  // one warpgroup
constexpr int ATT_BM = 64;        // query rows per CTA
constexpr int ATT_BN = 64;        // keys per tile
constexpr int ATT_STAGES = 2;     // ring stages of [K tile | V tile]

template <int D>
__host__ __device__ constexpr int att_q_pitch() {
  return D + 8;  // the pad spreads ldmatrix's rows over the banks
}
template <int D>
__host__ __device__ constexpr int att_smem_bytes() {
  return ATT_BM * att_q_pitch<D>() * 2 + ATT_STAGES * 2 * ATT_BN * D * 2;
}

// O[64 x D] += P[64 x 16] V[16 x D], V's [16, D] rows through `vs` as
// MN-major core matrices; D is covered by wgmma widths 128, 64, 32 and 16.
template <int D, int N0 = 0>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], const bf16* vs) {
  constexpr int REST = D - N0;
  constexpr int N = REST >= 128 ? 128 : REST >= 64 ? 64 : REST >= 32 ? 32 : 16;
  wgmma_rs<N, 1>(*reinterpret_cast<float(*)[N / 2]>(&o[N0 / 2]), a,
                 sm90_desc(vs + (N0 / 8) * 64, D * 16, 128));
  if constexpr (N0 + N < D) wgmma_pv<D, N0 + N>(o, a, vs);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// grid (ceil(S / 64), H, B), ATT_THREADS threads, att_smem_bytes<D>() bytes
// of dynamic shared memory. q rows of [B, S, *] at q + b * sqb + s * sqr,
// head h's D values from column h * D; k, v likewise over N keys; out
// [B, S, H * D] contiguous. Strides and pointers 16-byte aligned, D % 16 == 0.
template <int D>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int S, int N,
                      long long sqb, long long sqr, long long skb, long long skr, long long svb,
                      long long svr, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head width");
  constexpr int LDQ = att_q_pitch<D>();
  constexpr int KS = D / 16;  // k-steps of S = Q K^T
  constexpr int PS = ATT_BN / 16;  // k-steps of O = P V
  constexpr int TILE = ATT_BN * D;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + ATT_BM * LDQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s0 = blockIdx.x * ATT_BM, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const bf16* qb = q + b * sqb + h * D;
  const bf16* kb = k + b * skb + h * D;
  const bf16* vb = v + b * svb + h * D;
  const int tiles = (N + ATT_BN - 1) / ATT_BN;
  const int steps = 2 * tiles;  // pass 1 reads K tiles, pass 2 K and V tiles

  // K tile: core matrix (d / 8, key / 8) holds 8 keys' 8 d-values (K-major
  // B of S = Q K^T). V tile: core matrix (key / 8, d / 8) holds 8 keys' 8
  // d-values (MN-major B of O = P V). Eight neighbouring threads fill one
  // core matrix, 128 contiguous bytes. Keys past N are zero.
  auto load = [&](int i) {
    const bool second = i >= tiles;
    const int n0 = (second ? i - tiles : i) * ATT_BN;
    bf16* Ks = ring + (i % ATT_STAGES) * 2 * TILE;
    bf16* Vs = Ks + TILE;
    for (int e = tid; e < TILE / 8; e += ATT_THREADS) {
      const int r8 = e % 8, dc = (e / 8) % (D / 8), kb8 = e / D;
      const int key = n0 + kb8 * 8 + r8;
      const bool ok = key < N;
      cp_async16(Ks + ((dc * (ATT_BN / 8) + kb8) * 64 + r8 * 8),
                 ok ? kb + key * skr + dc * 8 : kb, ok);
      if (second)
        cp_async16(Vs + ((kb8 * (D / 8) + dc) * 64 + r8 * 8),
                   ok ? vb + key * svr + dc * 8 : vb, ok);
    }
  };

  // The q tile, rows past S zero, in the same group as step 0.
  for (int e = tid; e < ATT_BM * (D / 8); e += ATT_THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool ok = s0 + r < S;
    cp_async16(Qs + r * LDQ + c, ok ? qb + (s0 + r) * sqr + c : qb, ok);
  }
  load(0);
  cp_async_commit();

  // Makes step i's tiles readable and starts loading step i + 1's.
  auto arrive = [&](int i) {
    if (i + 1 < steps) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
  };

  // Thread (warp, lane) holds rows r = 16 warp + lane / 4 (+ 8) of the tile
  // and, of each 8-column block j, columns 8 j + 2 (lane % 4) (+ 1):
  // accumulator entries 4 j + 2 half + {0, 1}. The scaled logits of step i,
  // keys past N at -inf. The q fragments are read from shared memory anew
  // for each product, so no register is live across another wgmma.
  auto logits = [&](int i, float (&sc)[ATT_BN / 2]) {
    const int n0 = (i % tiles) * ATT_BN;
    const bf16* Ks = ring + (i % ATT_STAGES) * 2 * TILE;
    uint32_t qa[KS][4];
    const int row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qa[ks], Qs + row * LDQ + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < ATT_BN / 2; ++j) sc[j] = 0.f;
#pragma unroll
    for (int j = 0; j < ATT_BN / 2; ++j) hold(sc[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_rs<ATT_BN, 0>(sc, qa[ks], sm90_desc(Ks + 2 * ks * (ATT_BN / 8) * 64, ATT_BN * 16, 128));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int t = 0; t < 4; ++t) hold(qa[ks][t]);
#pragma unroll
    for (int j = 0; j < ATT_BN / 2; ++j) hold(sc[j]);
#pragma unroll
    for (int j = 0; j < ATT_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * (lane % 4) + (e % 2);
        sc[4 * j + e] = key < N ? __fmul_rn(sc[4 * j + e], scale) : -INFINITY;
      }
  };

  // Pass 1: each row's running max over the four threads that hold it, and
  // each thread's share of the sum, rescaled to the new max.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    arrive(i);
    float sc[ATT_BN / 2];
    logits(i, sc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int j = 0; j < ATT_BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * half], sc[4 * j + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = __fmul_rn(l[half], expf(__fsub_rn(m[half], mx)));
#pragma unroll
      for (int j = 0; j < ATT_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(sc[4 * j + 2 * half + e], mx)));
      m[half] = mx;
      l[half] = sum;
    }
    __syncthreads();  // buffer i % ATT_STAGES is refilled next
  }
  // The four shares of each row, summed the same way on all four.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = __fadd_rn(l[half], __shfl_xor_sync(0xffffffffu, l[half], 1));
    l[half] = __fadd_rn(l[half], __shfl_xor_sync(0xffffffffu, l[half], 2));
  }

  // Pass 2: p rounded once to bf16, as the A fragments of O += P V.
  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  for (int i = tiles; i < steps; ++i) {
    arrive(i);
    float sc[ATT_BN / 2];
    logits(i, sc);
    uint32_t pa[PS][4];
#pragma unroll
    for (int ks = 0; ks < PS; ++ks)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 2 * ks + t / 2, half = t % 2;
        const float p0 = __fdiv_rn(expf(__fsub_rn(sc[4 * j + 2 * half], m[half])), l[half]);
        const float p1 = __fdiv_rn(expf(__fsub_rn(sc[4 * j + 2 * half + 1], m[half])), l[half]);
        pa[ks][t] = pack_bf16(p0, p1);
      }
    const bf16* Vs = ring + (i % ATT_STAGES) * 2 * TILE + TILE;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) hold(o[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PS; ++ks) wgmma_pv<D>(o, pa[ks], Vs + 2 * ks * (D / 8) * 64);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < PS; ++ks)
#pragma unroll
      for (int t = 0; t < 4; ++t) hold(pa[ks][t]);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) hold(o[j]);
    __syncthreads();  // buffer i % ATT_STAGES is refilled next
  }

  // The output rows, rounded once to bf16.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = s0 + warp * 16 + lane / 4 + 8 * half;
    if (s < S) {
      bf16* orow = out + ((size_t)b * S + s) * H * D + h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
            __floats2bfloat162_rn(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
  }
}

template <int D>
cudaError_t attention_core_typed(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int N, int H, long long sqb, long long sqr, long long skb,
                                 long long skr, long long svb, long long svr, float scale,
                                 cudaStream_t stream) {
  auto kernel = attention_core_kernel<D>;
  constexpr int SMEM = att_smem_bytes<D>();
  // More than 48 KB needs the kernel's attribute raised, once per device.
  static std::atomic<unsigned long long> raised{0};  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (SMEM > 48 * 1024 && (dev >= 64 || !(raised.load() >> dev & 1))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised.fetch_or(1ull << dev);
  }
  const dim3 grid((S + ATT_BM - 1) / ATT_BM, H, B);
  kernel<<<grid, ATT_THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, N, sqb, sqr, skb, skr, svb, svr, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and out; strides in elements. Returns a cudaError_t (0 on
// success); a head width D that is not a multiple of 16 in [16, 128] is
// cudaErrorInvalidValue.
extern "C" int attention_core_forward(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int N, int H, int D, long long sqb,
                                      long long sqr, long long skb, long long skr, long long svb,
                                      long long svr, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (N < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define ATTENTION_CORE_D(D_)                                                                  \
  if (D == D_)                                                                                \
    return (int)attention_core_typed<D_>(q, k, v, out, B, S, N, H, sqb, sqr, skb, skr, svb,   \
                                         svr, scale, s);
  ATTENTION_CORE_D(16)
  ATTENTION_CORE_D(32)
  ATTENTION_CORE_D(48)
  ATTENTION_CORE_D(64)
  ATTENTION_CORE_D(80)
  ATTENTION_CORE_D(96)
  ATTENTION_CORE_D(112)
  ATTENTION_CORE_D(128)
#undef ATTENTION_CORE_D
  return (int)cudaErrorInvalidValue;
}
