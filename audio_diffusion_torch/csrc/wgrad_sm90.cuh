// The bf16 weight gradient of the fused resnet item's two convolutions for
// Hopper (sm_90a). Replaces, with the rest of resnet_item_bwd.cu, the custom
// VJP of the TPU kernel `fused_resnet_item` (`_fwd`/`_bwd`,
// audio_diffusion_tpu/ops/kernels/resnet.py:193-219):
//
//   dK[t, ci, co] = sum_{b,l} act(u[b, l - 1 + t, ci]) * dv[b, l, co],
//   act(v) = bf16(SiLU((v - mean) * rstd * gamma + beta)), zero outside [0, L),
//
// a product per tap with M = ci, N = co and K = the B*L positions. The
// activation is recomputed from the stage input u exactly as the forward
// conv computes it (conv3_sm90.cuh), so it never reaches device memory.
//
// What bounds it on an H100 (6*C^2*B*L operations at 989 TFLOP/s against
// 2*B*L*C bf16 inputs and 3*C^2 outputs at 3.35 TB/s): levels 0-2 (C <= 64,
// 2^18..2^14 positions a batch row) by bytes, the two activation-sized
// inputs, 1-2.5 us at batch 1; levels 3-6 by operations at batch 8 and
// roughly even at batch 1; levels 7-8 (C = 1024) by the 6 MB of dK at
// batch 1. Every bound is a few microseconds, so in practice it is bound by
// filling the card: a 3 x C x C output from millions of positions (level 0)
// needs the positions split over many CTAs, and at C = 1024 the 48 output
// tiles x 3 taps are few but each walks every position.
//
// What the design does about it:
//  - Positions are split into chunks of one batch row (256 positions at
//    C = 8, 128 for the 64 x 128 wgmma tile, else 64), and the chunks into
//    slabs; wgrad_plan() in ops/kernels/resnet.py picks the slab count
//    that takes the fewest chunk-times (a CTA's chunks times the waves of
//    resident CTAs the grid needs) while the f32 partials [slabs, 3, C, C]
//    stay within a cap.
//    A slab's CTA walks its chunks through a ring of WG_STAGES cp.async
//    stages; wgrad_finalize (resnet_item_bwd.cu) sums the partials in slab
//    order. With one slab the CTA rounds and writes dK itself.
//  - The three taps are position shifts of one staged u chunk: all three
//    accumulate from one load of u and dv.
//  - C >= 64: wgrad_sm90_kernel, wgmma m64nNk16 with two warpgroups, a CTA
//    tile of 64 ci x 2N co (N = 32 at C <= 64, else 64), eight or four
//    k16 steps a chunk. A = act(u)^T comes
//    from registers: ldmatrix.x4.trans from the u chunk [positions, ci] at
//    row offset t (each lane names its own row, so any shift works). B = the
//    dv chunk [positions, co], co contiguous, is staged as MN-major core
//    matrices and read with wgmma's transpose flag, as the forward's B.
//  - C <= 32 (levels 0, 1): wgrad_narrow_kernel, a tile exactly 3C x C
//    (taps stacked along M) on mma.sync m16n8k16, so no channel is
//    zero-filled; the chunk's rows are 16 or 64 contiguous bytes, loaded 16
//    bytes a thread. Its four warps take different positions and are summed
//    in a fixed order through shared memory at the end.
//  - Each prologue normalises and activates the staged u chunk in place. A
//    thread's channels stay the same from chunk to chunk, so it loads their
//    gamma and beta once, and their mean and rstd once per batch row.
// No atomics: every sum runs in a fixed order, so dK is deterministic.
#pragma once

#include "conv3_sm90.cuh"

namespace {

constexpr int WG_STAGES = 3;         // ring stages of position chunks per CTA
constexpr int WG_SM90_THREADS = 256;  // two warpgroups
constexpr int WG_NARROW_THREADS = 128;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
// Waits until at most N committed wgmma groups are still in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// GroupNorm parameters of eight consecutive channels c0 .. c0 + 8; all zero
// past C, so that the activation of a zero-filled channel stays zero.
struct Gn8 {
  float mean[8], rstd[8], g[8], e[8];
};
__device__ __forceinline__ void gn8_affine(Gn8& q, const __nv_bfloat16* gamma,
                                           const __nv_bfloat16* beta, int c0, int C) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool ok = c0 + k < C;
    q.g[k] = ok ? to_f32(gamma[c0 + k]) : 0.f;
    q.e[k] = ok ? to_f32(beta[c0 + k]) : 0.f;
  }
}
__device__ __forceinline__ void gn8_stats(Gn8& q, const float2* st, int c0, int C, int cpg) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float2 ms = c0 + k < C ? st[(c0 + k) / cpg] : make_float2(0.f, 0.f);
    q.mean[k] = ms.x;
    q.rstd[k] = ms.y;
  }
}
// act() of a 16-byte vector of eight channels, as the forward conv's prologue.
__device__ __forceinline__ uint4 act8(uint4 raw, const Gn8& q) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 v = __bfloat1622float2(h2[u]);
    const int k0 = 2 * u, k1 = 2 * u + 1;
    h2[u] = __floats2bfloat162_rn(silu_fast(gn_affine(v.x, q.mean[k0], q.rstd[k0], q.g[k0], q.e[k0])),
                                  silu_fast(gn_affine(v.y, q.mean[k1], q.rstd[k1], q.g[k1], q.e[k1])));
  }
  return raw;
}

// Each ring stage of both kernels holds the u rows (P + 2 at pitch LDU) and
// then the dv rows, each part starting on 128 bytes.
__host__ __device__ constexpr int wg_round128(int bytes) { return (bytes + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// C >= 64: wgmma. CTA tile 64 ci x TN = 2 * NW co, warpgroup w takes co
// [n0 + w * NW, + NW) of every tap (3 * NW / 2 accumulators a thread);
// chunks of P_ positions.
template <int NW, int P_>
struct WgradSm90 {
  static constexpr int TM = 64, TN = 2 * NW, P = P_, KS = P / 16;
  static constexpr int LDU = TM + 8;  // 144-byte rows: ldmatrix's 8 rows hit 8 bank groups
  static constexpr int U_BYTES = wg_round128((P + 2) * LDU * 2);
  static constexpr int STAGE = U_BYTES + P * TN * 2;
  static constexpr int RESIDENT = NW == 32 ? 2 : 1;
  static constexpr int smem(int stages) { return stages * STAGE; }
};

// grid (ceil(C / 64) * co_tiles, slabs), WG_SM90_THREADS threads,
// WgradSm90<NW, P>::smem(min(WG_STAGES, cps)) bytes of dynamic shared memory.
// Chunk q is positions [l0, l0 + P) of batch row b = q / chunks_per_row,
// l0 = (q % chunks_per_row) * P; slab z takes chunks [z * cps, (z + 1) * cps).
// With one slab it writes dk (bf16), else its f32 partial [z, 3, C, C].
// Needs C % 8 == 0 and 16-byte aligned u, dv.
template <int NW, int P_>
__global__ void __launch_bounds__(WG_SM90_THREADS, WgradSm90<NW, P_>::RESIDENT)
wgrad_sm90_kernel(const __nv_bfloat16* __restrict__ u, const float2* __restrict__ stats,
                  const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
                  const __nv_bfloat16* __restrict__ dv, float* __restrict__ partial,
                  __nv_bfloat16* __restrict__ dk, int L, int C, int G, int chunks_per_row,
                  int total_chunks, int cps, int co_tiles) {
  using K = WgradSm90<NW, P_>;
  using bf16 = __nv_bfloat16;
  constexpr int TM = K::TM, TN = K::TN, P = K::P, KS = K::KS, LDU = K::LDU;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int m0 = (blockIdx.x / co_tiles) * TM, n0 = (blockIdx.x % co_tiles) * TN;
  const int slab = blockIdx.y, q0 = slab * cps;
  const int nchunks = min(cps, total_chunks - q0);
  const int stages = min(WG_STAGES, cps);
  const int cpg = C / G;

  auto u_tile = [&](int i) { return reinterpret_cast<bf16*>(smem + (i % stages) * K::STAGE); };
  auto d_tile = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (i % stages) * K::STAGE + K::U_BYTES);
  };

  // Stage chunk i: u rows l0 - 1 .. l0 + P (zero outside [0, L) and past C)
  // as [row, ci]; dv rows l0 .. l0 + P - 1 (zero past L and C) as MN-major core
  // matrices, (kb, nb) at (kb * TN/8 + nb) * 64 elements holding positions
  // l0 + 8kb .. +8 by co n0 + 8nb .. +8.
  auto stage = [&](int i) {
    const int q = q0 + i, b = q / chunks_per_row, l0 = (q % chunks_per_row) * P;
    const bf16* ub = u + (size_t)b * L * C;
    const bf16* db = dv + (size_t)b * L * C;
    bf16* Us = u_tile(i);
    bf16* Ds = d_tile(i);
    for (int v = tid; v < (P + 2) * (TM / 8); v += WG_SM90_THREADS) {
      const int r = v / (TM / 8), kk = (v % (TM / 8)) * 8;
      const int l = l0 - 1 + r, c = m0 + kk;
      const bool ok = l >= 0 && l < L && c < C;
      cp_async16(Us + r * LDU + kk, ok ? ub + (size_t)l * C + c : ub, ok);
    }
#pragma unroll 4
    for (int v = tid; v < P * TN / 8; v += WG_SM90_THREADS) {
      const int r8 = v % 8, nb = (v / 8) % (TN / 8), kb = v / TN;
      const int l = l0 + kb * 8 + r8, co = n0 + nb * 8;
      const bool ok = l < L && co < C;
      cp_async16(Ds + (kb * (TN / 8) + nb) * 64 + r8 * 8, ok ? db + (size_t)l * C + co : db, ok);
    }
  };

  float acc[3][NW / 2];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[t][j] = 0.f;

  // The prologue's layout: thread tid activates channels m0 + 8 * (tid % 8)
  // .. + 8 of rows tid / 8, + 32, ... of every chunk.
  constexpr int RSTEP = WG_SM90_THREADS / (TM / 8);
  constexpr int PASSES = (P + 2 + RSTEP - 1) / RSTEP;
  const int c8 = m0 + 8 * (tid % (TM / 8)), r0 = tid / (TM / 8);
  Gn8 gn;
  gn8_affine(gn, gamma, beta, c8, C);
  int gn_b = -1;

  for (int i = 0; i < stages - 1; ++i) {
    if (i < nchunks) stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < nchunks; ++i) {
    // The buffer refilled here held chunk i - 1, finished last iteration.
    if (i + stages - 1 < nchunks) stage(i + stages - 1);
    cp_async_commit();
    cp_async_wait_upto(stages - 1);
    __syncthreads();

    // Normalise and activate the u rows in place (rows outside [0, L) stay
    // zero); all of a thread's rows are read before any is written back.
    const int q = q0 + i, b = q / chunks_per_row, l0 = (q % chunks_per_row) * P;
    if (b != gn_b) {
      gn8_stats(gn, stats + (size_t)b * G, c8, C, cpg);
      gn_b = b;
    }
    bf16* Us = u_tile(i);
    {
      uint4 raw[PASSES];
      bool in[PASSES];
#pragma unroll
      for (int k = 0; k < PASSES; ++k) {
        const int r = r0 + k * RSTEP, l = l0 - 1 + r;
        in[k] = r < P + 2 && l >= 0 && l < L;
        raw[k] = in[k] ? *reinterpret_cast<const uint4*>(Us + r * LDU + c8 - m0) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < PASSES; ++k)
        if (in[k]) *reinterpret_cast<uint4*>(Us + (r0 + k * RSTEP) * LDU + c8 - m0) = act8(raw[k], gn);
    }
    fence_proxy_async();
    __syncthreads();

    // A[m = ci, k = position] of tap t is the activated chunk at row offset
    // t: warp w's ci 16w .. 16w + 15, positions 16ks .. 16ks + 15. The
    // fragments of two k16 steps are in registers at once: step ks loads
    // into buffer ks % 2 once step ks - 2's products, which read it, are done.
    const bf16* Ds = d_tile(i) + (wg * NW / 8) * 64;
    uint32_t a[2][3][4];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) hold(acc[t][j]);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t(&ak)[3][4] = a[ks % 2];
      if (ks >= 2) {
        wgmma_wait<1>();
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) hold(ak[t][e]);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t)
        ldmatrix_x4_trans(ak[t], Us + (ks * 16 + t + (lane % 8) + (lane / 16) * 8) * LDU +
                                     warp * 16 + ((lane / 8) % 2) * 8);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
        wgmma_rs<NW, 1>(acc[t], ak[t], sm90_desc(Ds + 2 * ks * (TN / 8) * 64, TN * 16, 128));
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b2 = 0; b2 < 2; ++b2)
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) hold(a[b2][t][e]);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) hold(acc[t][j]);
    __syncthreads();  // buffer i % stages is refilled next iteration
  }

  // Thread (warp, lane) of warpgroup wg holds ci 16w + lane/4 (+ 8) and co
  // pairs 8j + 2(lane % 4) of the warpgroup's channels, for every tap.
  const bool direct = gridDim.y == 1;
  float* pz = partial + (size_t)slab * 3 * C * C;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = m0 + warp * 16 + lane / 4 + 8 * h;
        const int co = n0 + wg * NW + 8 * j + 2 * (lane % 4);
        if (ci < C && co < C) {
          const size_t idx = ((size_t)t * C + ci) * C + co;
          const float v0 = acc[t][4 * j + 2 * h], v1 = acc[t][4 * j + 2 * h + 1];
          if (direct)
            *reinterpret_cast<__nv_bfloat162*>(dk + idx) = __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(pz + idx) = make_float2(v0, v1);
        }
      }
}

// ---------------------------------------------------------------------------
// C <= 32: the whole 3C x C output on mma.sync. M stacks the taps: row
// m = t * CT + ci of MI = ceil(3 CT / 16) m16 tiles (at CT = 8 the second
// tile's last 8 rows repeat tap 2 and are dropped); N = co in CT / 8 n8
// tiles; K = positions, P a chunk, 16 of them per warp per k16 step.
template <int CT>
struct WgradNarrow {
  static constexpr int P = CT == 8 ? 256 : 64;
  static constexpr int KW = P / 64;  // k16 steps per warp per chunk
  static constexpr int LD = CT == 8 ? 8 : CT + 8;  // 16-byte rows, or 80-byte ones
  static constexpr int MI = (3 * CT + 15) / 16, NI = CT / 8;
  static constexpr int U_BYTES = wg_round128((P + 2) * LD * 2);
  static constexpr int STAGE = U_BYTES + wg_round128(P * LD * 2);
  static constexpr int SLOT = MI * NI * 4 * 32;  // floats: one warp's accumulators
  static constexpr int RESIDENT = CT == 8 ? 4 : 2;
  static constexpr int smem(int stages) {
    return stages * STAGE > 2 * SLOT * 4 ? stages * STAGE : 2 * SLOT * 4;
  }
};

// grid (slabs), WG_NARROW_THREADS threads, WgradNarrow<CT>::smem(min(WG_STAGES,
// cps)) bytes of dynamic shared memory; chunks and slabs as in
// wgrad_sm90_kernel with P positions a chunk. Needs C <= CT, C % 8 == 0.
template <int CT>
__global__ void __launch_bounds__(WG_NARROW_THREADS, WgradNarrow<CT>::RESIDENT)
wgrad_narrow_kernel(const __nv_bfloat16* __restrict__ u, const float2* __restrict__ stats,
                    const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
                    const __nv_bfloat16* __restrict__ dv, float* __restrict__ partial,
                    __nv_bfloat16* __restrict__ dk, int L, int C, int G, int chunks_per_row,
                    int total_chunks, int cps) {
  using K = WgradNarrow<CT>;
  using bf16 = __nv_bfloat16;
  constexpr int P = K::P, LD = K::LD, MI = K::MI, NI = K::NI, VR = CT / 8;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slab = blockIdx.x, q0 = slab * cps;
  const int nchunks = min(cps, total_chunks - q0);
  const int stages = min(WG_STAGES, cps);
  const int cpg = C / G;

  auto u_tile = [&](int i) { return reinterpret_cast<bf16*>(smem + (i % stages) * K::STAGE); };
  auto d_tile = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (i % stages) * K::STAGE + K::U_BYTES);
  };
  auto stage = [&](int i) {
    const int q = q0 + i, b = q / chunks_per_row, l0 = (q % chunks_per_row) * P;
    const bf16* ub = u + (size_t)b * L * C;
    const bf16* db = dv + (size_t)b * L * C;
    bf16* Us = u_tile(i);
    bf16* Ds = d_tile(i);
    for (int v = tid; v < (P + 2) * VR; v += WG_NARROW_THREADS) {
      const int r = v / VR, c = (v % VR) * 8, l = l0 - 1 + r;
      const bool ok = l >= 0 && l < L && c < C;
      cp_async16(Us + r * LD + c, ok ? ub + (size_t)l * C + c : ub, ok);
    }
    for (int v = tid; v < P * VR; v += WG_NARROW_THREADS) {
      const int r = v / VR, c = (v % VR) * 8, l = l0 + r;
      const bool ok = l < L && c < C;
      cp_async16(Ds + r * LD + c, ok ? db + (size_t)l * C + c : db, ok);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  constexpr int RSTEP = WG_NARROW_THREADS / VR;
  constexpr int PASSES = (P + 2 + RSTEP - 1) / RSTEP;
  const int c8 = 8 * (tid % VR), r0 = tid / VR;
  Gn8 gn;
  gn8_affine(gn, gamma, beta, c8, C);
  int gn_b = -1;

  // ldmatrix.x4.trans lane addresses. A of m16 tile mi: lane's 8 x 8 block
  // j = lane / 8 covers stacked rows 16mi + 8(j % 2) .. + 8, i.e. tap
  // (16mi + 8(j % 2)) / CT from channel (16mi + 8(j % 2)) % CT, positions
  // + 8(j / 2); its row address is t rows further down the u chunk.
  int a_row[MI], a_col[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m = 16 * mi + 8 * ((lane / 8) % 2);
    const int t = m < 3 * CT ? m / CT : 2;
    a_row[mi] = (lane % 8) + (lane / 16) * 8 + t;
    a_col[mi] = m < 3 * CT ? m % CT : 0;
  }

  for (int i = 0; i < stages - 1; ++i) {
    if (i < nchunks) stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < nchunks; ++i) {
    if (i + stages - 1 < nchunks) stage(i + stages - 1);
    cp_async_commit();
    cp_async_wait_upto(stages - 1);
    __syncthreads();

    const int q = q0 + i, b = q / chunks_per_row, l0 = (q % chunks_per_row) * P;
    if (b != gn_b) {
      gn8_stats(gn, stats + (size_t)b * G, c8, C, cpg);
      gn_b = b;
    }
    bf16* Us = u_tile(i);
    {
      uint4 raw[PASSES];
      bool in[PASSES];
#pragma unroll
      for (int k = 0; k < PASSES; ++k) {
        const int r = r0 + k * RSTEP, l = l0 - 1 + r;
        in[k] = r < P + 2 && l >= 0 && l < L;
        raw[k] = in[k] ? *reinterpret_cast<const uint4*>(Us + r * LD + c8) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < PASSES; ++k)
        if (in[k]) *reinterpret_cast<uint4*>(Us + (r0 + k * RSTEP) * LD + c8) = act8(raw[k], gn);
    }
    __syncthreads();

    const bf16* Ds = d_tile(i);
#pragma unroll
    for (int kw = 0; kw < K::KW; ++kw) {
      const int kp = (warp * K::KW + kw) * 16;  // the warp's 16 positions
      // B[k = position, n = co]: dv rows, co contiguous; .trans gives the
      // col-major fragment. Block j = lane / 8: positions + 8(j % 2), co + 8(j / 2).
      uint32_t bf[NI][2];
      const bf16* drow = Ds + (kp + (lane % 8) + ((lane / 8) % 2) * 8) * LD;
      if constexpr (NI == 1) {
        ldmatrix_x2_trans(bf[0], drow);
      } else {
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, drow + np * 16 + (lane / 16) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, Us + (kp + a_row[mi]) * LD + a_col[mi]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_16816(acc[mi][ni], af, bf[ni]);
      }
    }
    __syncthreads();  // buffer i % stages is refilled next iteration
  }

  // Sum the four warps in a fixed order, (w0 + w2) + (w1 + w3), through two
  // slots of shared memory laid out [register][lane].
  cp_async_wait<0>();
  __syncthreads();
  float* slot = reinterpret_cast<float*>(smem);
  for (int half = 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
      float* s = slot + (warp - half) * K::SLOT;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[((mi * NI + ni) * 4 + e) * 32 + lane] = acc[mi][ni][e];
    }
    __syncthreads();
    if (warp < half) {
      const float* s = slot + warp * K::SLOT;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += s[((mi * NI + ni) * 4 + e) * 32 + lane];
    }
    __syncthreads();
  }
  if (warp != 0) return;

  // Accumulator e of tile (mi, ni): stacked row 16mi + lane/4 + 8(e / 2), co
  // 8ni + 2(lane % 4) + e % 2.
  const bool direct = gridDim.x == 1;
  float* pz = partial + (size_t)slab * 3 * C * C;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mi + lane / 4 + 8 * h;
      const int t = m / CT, ci = m % CT;
      if (m >= 3 * CT || ci >= C) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int co = 8 * ni + 2 * (lane % 4);
        if (co >= C) continue;
        const size_t idx = ((size_t)t * C + ci) * C + co;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (direct)
          *reinterpret_cast<__nv_bfloat162*>(dk + idx) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(pz + idx) = make_float2(v0, v1);
      }
    }
}

// Launches Kernel (P positions a chunk) or, with blocks_per_sm set, reports
// its dynamic shared memory and resident CTAs per SM. More than 48 KB of
// shared memory needs the kernel's attribute raised, once per device.
template <auto Kernel, int P, typename... Extra>
cudaError_t wgrad_launch(int threads, int smem, int most, dim3 grid, const __nv_bfloat16* u,
                         const float2* stats, const __nv_bfloat16* gamma,
                         const __nv_bfloat16* beta, const __nv_bfloat16* dv, float* partial,
                         __nv_bfloat16* dk, int B, int L, int C, int G, int cps,
                         cudaStream_t stream, int* smem_out, int* blocks_per_sm, Extra... extra) {
  static std::atomic<unsigned long long> raised{0};  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (most > 48 * 1024 && (dev >= 64 || !(raised.load() >> dev & 1))) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised.fetch_or(1ull << dev);
  }
  if (blocks_per_sm) {
    *smem_out = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, Kernel, threads, smem);
  }
  const int chunks_per_row = (L + P - 1) / P;
  Kernel<<<grid, threads, smem, stream>>>(u, stats, gamma, beta, dv, partial, dk, L, C, G,
                                          chunks_per_row, B * chunks_per_row, cps, extra...);
  return cudaGetLastError();
}

// The bf16 weight gradient with wgrad_plan()'s tile (the CTA's output
// channels: 8 or 32 for the narrow kernel, 64 or 128 for wgmma), chunk (P
// positions) and split of the B * ceil(L / P) chunks into slabs of cps. With
// blocks_per_sm set it launches nothing and reports the plan's dynamic shared
// memory and resident CTAs per SM. An unknown tile or chunk is
// cudaErrorInvalidValue.
inline cudaError_t wgrad_sm90(int tile, int chunk, const __nv_bfloat16* u, const float2* stats,
                              const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                              const __nv_bfloat16* dv, float* partial, __nv_bfloat16* dk, int B,
                              int L, int C, int G, int cps, int slabs, cudaStream_t stream,
                              int* smem_out = nullptr, int* blocks_per_sm = nullptr) {
  const int stages = cps < WG_STAGES ? cps : WG_STAGES;
#define WGRAD_ARGS u, stats, gamma, beta, dv, partial, dk, B, L, C, G, cps, stream, smem_out, blocks_per_sm
  if (tile == 8 && chunk == WgradNarrow<8>::P)
    return wgrad_launch<wgrad_narrow_kernel<8>, WgradNarrow<8>::P>(
        WG_NARROW_THREADS, WgradNarrow<8>::smem(stages), WgradNarrow<8>::smem(WG_STAGES),
        dim3(slabs), WGRAD_ARGS);
  if (tile == 32 && chunk == WgradNarrow<32>::P)
    return wgrad_launch<wgrad_narrow_kernel<32>, WgradNarrow<32>::P>(
        WG_NARROW_THREADS, WgradNarrow<32>::smem(stages), WgradNarrow<32>::smem(WG_STAGES),
        dim3(slabs), WGRAD_ARGS);
#define WGRAD_SM90_TILE(TILE_, P_)                                                         \
  if (tile == TILE_ && chunk == P_)                                                        \
    return wgrad_launch<wgrad_sm90_kernel<TILE_ / 2, P_>, P_>(                             \
        WG_SM90_THREADS, WgradSm90<TILE_ / 2, P_>::smem(stages),                           \
        WgradSm90<TILE_ / 2, P_>::smem(WG_STAGES),                                         \
        dim3(((C + 63) / 64) * ((C + TILE_ - 1) / TILE_), slabs), WGRAD_ARGS,              \
        (C + TILE_ - 1) / TILE_);
  WGRAD_SM90_TILE(64, 64)
  WGRAD_SM90_TILE(128, 128)
#undef WGRAD_SM90_TILE
  return cudaErrorInvalidValue;
#undef WGRAD_ARGS
}

}  // namespace
