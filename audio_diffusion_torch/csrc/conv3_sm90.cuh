// The bf16 convolution of the fused resnet item for Hopper (sm_90a), around
// wgmma: the forward's two convolutions (kForward, kForwardResidual) and the
// backward's two data gradients (kDataGrad). Replaces, with the rest of the
// chain in resnet_item.cu, the TPU kernel `fused_resnet_item` (pl.pallas_call
// at audio_diffusion_tpu/ops/kernels/resnet.py:172, body `_item_kernel`),
// whose two GN->SiLU->conv3 stages these are, and with resnet_item_bwd.cu
// its custom VJP (`_fwd`/`_bwd`, resnet.py:193-219).
//
//   out[b, l, co] = sum_t sum_ci act(x[b, l - 1 + t, ci]) * w[t, ci, co] + bias[co]
//                   (+ res[b, l, co] for kForwardResidual),
//   act(v) = bf16(SiLU((v - mean) * rstd * gamma + beta)), zero outside [0, L).
//
// The data gradient has the same shapes (M = L rows, N = C, K = 3 C) and the
// same loop; conv3_sm90_kernel's note below says where it differs. Its
// bounds are the forward's, with f32 out: its output rows weigh twice as much.
//
// What bounds each level on an H100 (batch 1, one conv: 6*C^2*L operations
// at 989 TFLOP/s against 2*L*C + 3*C^2 bf16 values at 3.35 TB/s): levels
// 0-3 (C <= 128, L 2^18..2^12) are bound by bytes, the input and output
// rows; levels 4-6 by operations, barely; levels 7-8 (C = 1024, L <= 256)
// by bytes again, the 6 MB of weights. Every bound is 0.1-2.5 us, so what
// limits the conv in practice is filling the card and keeping loads in
// flight: at the deep levels there are few row tiles, and a CTA that walks
// all of K waits on each chunk in turn.
//
// What the design does about it:
//  - MMA: wgmma.mma_async m64nNk16, bf16 in, f32 accumulate. Two warpgroups
//    (256 threads) share a CTA's tile, by rows where it has several 64-row
//    sub-tiles, else by channels. The three taps are row shifts of one input
//    tile (output row i of tap t reads tile row i + t), which no
//    shared-memory descriptor can express (core matrices are 8 rows of 16
//    bytes), so A comes from registers: ldmatrix.x4 from the activated tile
//    at row offset t. B, the weight taps, is read through a descriptor from
//    MN-major core matrices (8 K-rows x 8 N-values, 128 contiguous bytes)
//    filled straight from w[t, ci, co], co contiguous, with wgmma's
//    transpose flag set for B.
//  - A ring of up to SM90_STAGES stages of [input rows | 3 weight taps] K
//    chunks arrives by cp.async, so the next chunks are in flight while one
//    is normalised, activated in place (the activated tensor never reaches
//    device memory; the GroupNorm parameters of the next chunk are loaded
//    meanwhile) and multiplied. Three stages (four measured slower) keep
//    two CTAs on an SM for every tile but the 128 x 128 one.
//  - A tile per level, chosen by conv_plan() in ops/kernels/resnet.py: N = 8
//    with the K chunk zero-padded to 16 at C = 8, N = 32 at C = 32, 64 or
//    128 from C = 64 on; 64 * MT rows per CTA, MT up to 8 where the rows are
//    narrow, so that each CTA moves whole kilobytes, and 128 rows by 128
//    channels from C = 128 on, so that fewer row tiles read each weight.
//  - Deterministic split-K where row tiles x channel tiles fill less than a
//    wave (at batch 1, levels 3-8): split s sums its own K chunks and writes
//    an f32 partial tile to a workspace; conv3_splitk_reduce sums the
//    splits in order, adds the bias (and the residual) in f32 and rounds
//    once to bf16. Without a split the epilogue does that from registers.
// No atomics anywhere: every sum runs in a fixed order.
#pragma once

#include <atomic>

#include "resnet_common.cuh"

namespace {

constexpr int SM90_THREADS = 256;  // two warpgroups
constexpr int SM90_STAGES = 3;     // ring buffers of K chunks per CTA

// One ring stage: the input tile, (64 * MT + 2) rows of BK + 8 bf16 (the pad
// spreads ldmatrix's rows over the banks), then the weights, 3 * BK * BN bf16
// as MN-major core matrices.
__host__ __device__ constexpr int sm90_a_bytes(int mt, int bk) {
  return ((64 * mt + 2) * (bk + 8) * 2 + 127) / 128 * 128;
}
__host__ __device__ constexpr int sm90_stage_bytes(int bn, int mt, int bk) {
  return sm90_a_bytes(mt, bk) + 3 * bk * bn * 2;
}

// A shared-memory matrix descriptor without swizzle. For an MN-major
// operand the leading byte offset is the stride between core matrices along
// K and the stride byte offset the stride between them along N.
__device__ __forceinline__ uint64_t sm90_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes the generic proxy's writes to shared memory (cp.async) visible to
// wgmma's reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps a register live and unmoved across an asynchronous wgmma: the
// compiler must not reuse an A fragment or an accumulator before the wait.
__device__ __forceinline__ void hold(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// cp.async.wait_group takes an immediate: leave at most n groups pending.
static_assert(SM90_STAGES <= 3, "cp_async_wait_upto covers n < 3");
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// D[64 x N] += A[64 x 16] * B[16 x N]: A from registers (the mma.m16n8k16 A
// fragment of each warp's 16 rows), B through `desc`: MN-major with TB = 1
// (wgmma's transpose flag for B), K-major with TB = 0.
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  static_assert(TB == 0 || TB == 1, "transpose flag");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  } else {
    static_assert(N == 128, "wgmma width");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
}

// SiLU with the fast exponential and division: its result is rounded to bf16
// at once, far coarser than their few-ulp f32 error.
__device__ __forceinline__ float silu_fast(float n) { return __fdividef(n, 1.f + __expf(-n)); }

// The data gradient (MODE == kDataGrad; x is dv, the gradient of the conv's
// output, res the stage input u, out f32):
//
//   dn[b, l, ci] = (sum_t' sum_co dv[b, l - 1 + t', co] * w[2 - t', ci, co])
//                  * SiLU'((u[b, l, ci] - mean) * rstd * gamma + beta),
//
// the forward's loop over tap t' = 2 - t with the roles of ci and co
// swapped: K runs over co and N over ci. Its input tile is dv itself, so
// there is no prologue. Its B[k = co, n = ci] = w[2 - t', ci, co] has K
// contiguous in memory: each 16-byte vector w[t, ci, co0 .. co0 + 8] is one
// row of a K-major core matrix (8 N-rows of 8 K-values), staged by cp.async
// into the same arrangement of core matrices as the forward's B and read
// with the transpose flag off. The epilogue multiplies by SiLU' with the
// precise exponential (dn stays f32, so nothing would hide a coarser one).
//
// grid (row tiles * B, ceil(C / BN), splits), SM90_THREADS threads (two
// warpgroups; two CTAs to an SM, one for the 128 x 128 tile, whose
// accumulators take 64 registers a thread), min(SM90_STAGES, cps) * sm90_stage_bytes(BN, MT, BK) bytes of
// dynamic shared memory. The warpgroups split the CTA's tile: by rows where
// MT >= 2 (MT / 2 sub-tiles of 64 rows each), else by channels (BN / 2 each).
// Split s takes K chunks [s * cps, (s + 1) * cps) of BK input channels (all
// three taps of each); with one split it writes out (bf16, f32 for the data
// gradient), else its f32 partial to ws[s, b, l, co], the raw sums. Needs
// C % 8 == 0 and 16-byte aligned x, w.
template <int BN, int MT, int BK, int MODE>
__global__ void __launch_bounds__(SM90_THREADS, BN * MT > 128 ? 1 : 2)
conv3_sm90_kernel(const __nv_bfloat16* __restrict__ x, const float2* __restrict__ stats,
                  const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
                  const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ res, void* __restrict__ out,
                  float* __restrict__ ws, int L, int C, int G, int row_tiles, int cps) {
  constexpr bool DGRAD = MODE == kDataGrad;
  constexpr bool SPLIT_M = MT >= 2;
  constexpr int MW = SPLIT_M ? MT / 2 : MT;  // 64-row sub-tiles per warpgroup
  constexpr int NW = SPLIT_M ? BN : BN / 2;  // channels per warpgroup
  static_assert(BK % 16 == 0 && NW % 8 == 0 && NW <= 256 && (!SPLIT_M || MT % 2 == 0),
                "wgmma tile");
  constexpr int BM = 64 * MT;
  constexpr int LDA = BK + 8;
  constexpr int A_BYTES = sm90_a_bytes(MT, BK);
  constexpr int STAGE = sm90_stage_bytes(BN, MT, BK);
  constexpr int KS = BK / 16;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int m0 = SPLIT_M ? wg * MW : 0, nw0 = SPLIT_M ? 0 : wg * NW;
  const int b = blockIdx.x / row_tiles, l0 = (blockIdx.x % row_tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int chunk0 = split * cps;
  const int nchunks = min(cps, (C + BK - 1) / BK - chunk0);
  const int stages = min(SM90_STAGES, cps);
  const int cpg = C / G;
  const bf16* xb = x + (size_t)b * L * C;
  const float2* st = stats + (size_t)b * G;

  auto a_tile = [&](int i) { return reinterpret_cast<bf16*>(smem + (i % stages) * STAGE); };
  auto b_tile = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (i % stages) * STAGE + A_BYTES);
  };

  // Stage K chunk i: raw input rows l0-1 .. l0+BM (zero outside [0, L) and
  // past C) and the three taps' [BK, BN] blocks (zero past C). Weight core
  // matrix (t, kb, nb) sits at ((t * BK/8 + kb) * BN/8 + nb) * 64 elements.
  // Forward: it holds w[t, k0 + 8kb .. +8, n0 + 8nb .. +8], one row per input
  // channel, and eight neighbouring threads fill it, one 16-byte row each.
  // Data gradient: it holds w[2 - t, n0 + 8nb .. +8, k0 + 8kb .. +8], one row
  // per output channel ci, and neighbouring threads take neighbouring
  // 16-byte vectors of one row of w.
  auto stage = [&](int i) {
    bf16* As = a_tile(i);
    bf16* Bs = b_tile(i);
    const int k0 = (chunk0 + i) * BK;
    for (int v = tid; v < (BM + 2) * (BK / 8); v += SM90_THREADS) {
      const int r = v / (BK / 8), kk = (v % (BK / 8)) * 8;
      const int l = l0 - 1 + r, c = k0 + kk;
      const bool ok = l >= 0 && l < L && c < C;
      cp_async16(As + r * LDA + kk, ok ? xb + (size_t)l * C + c : xb, ok);
    }
#pragma unroll 4
    for (int v = tid; v < 3 * BK * BN / 8; v += SM90_THREADS) {
      if constexpr (DGRAD) {
        const int kb = v % (BK / 8), r8 = (v / (BK / 8)) % 8, nb = (v / BK) % (BN / 8);
        const int t = v / (BK * BN / 8), co = k0 + kb * 8, ci = n0 + nb * 8 + r8;
        const bool ok = co < C && ci < C;
        cp_async16(Bs + ((t * (BK / 8) + kb) * (BN / 8) + nb) * 64 + r8 * 8,
                   ok ? w + ((size_t)(2 - t) * C + ci) * C + co : w, ok);
      } else {
        const int r8 = v % 8, nb = (v / 8) % (BN / 8), tkb = v / BN;
        const int t = tkb / (BK / 8), c = k0 + (tkb % (BK / 8)) * 8 + r8, co = n0 + nb * 8;
        const bool ok = c < C && co < C;
        cp_async16(Bs + (tkb * (BN / 8) + nb) * 64 + r8 * 8,
                   ok ? w + ((size_t)t * C + c) * C + co : w, ok);
      }
    }
  };

  float acc[MW][NW / 2];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[m][j] = 0.f;

  // The prologue's layout: each thread normalises four channels of rows
  // r0, r0 + RSTEP, ... of a chunk's input tile. Their GroupNorm parameters
  // (mean, rstd, gamma, beta) for chunk i + 1 are loaded while chunk i is
  // multiplied, so their latency is off the chunk's critical path.
  constexpr int TPR = BK / 4;                   // threads per row
  constexpr int RSTEP = SM90_THREADS / TPR;     // rows per pass
  constexpr int PASSES = (BM + 2 + RSTEP - 1) / RSTEP;
  const int q4 = tid % TPR, r0 = tid / TPR;
  struct Gn {
    float mean[4], rstd[4], g[4], e[4];
    bool ok;
  };
  auto load_gn = [&](int i) {
    Gn q{};
    const int c = (chunk0 + i) * BK + 4 * q4;
    q.ok = !DGRAD && i < nchunks && c < C;  // C % 8 == 0, so c + 3 < C too
    if (q.ok) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 ms = st[(c + k) / cpg];
        q.mean[k] = ms.x;
        q.rstd[k] = ms.y;
        q.g[k] = to_f32(gamma[c + k]);
        q.e[k] = to_f32(beta[c + k]);
      }
    }
    return q;
  };
  Gn gn = load_gn(0);

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

    // Normalise and activate the input tile in place; rows outside [0, L)
    // and channels past C stay zero. All of a thread's rows are read before
    // any is written back, so their latencies overlap. The data gradient
    // multiplies its input tile as it arrived.
    bf16* As = a_tile(i);
    if (!DGRAD && gn.ok) {
      uint2 raw[PASSES];
      bool in[PASSES];
#pragma unroll
      for (int k = 0; k < PASSES; ++k) {
        const int r = r0 + k * RSTEP, l = l0 - 1 + r;
        in[k] = r < BM + 2 && l >= 0 && l < L;
        raw[k] = in[k] ? *reinterpret_cast<const uint2*>(As + r * LDA + 4 * q4) : make_uint2(0, 0);
      }
#pragma unroll
      for (int k = 0; k < PASSES; ++k) {
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw[k]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 v = __bfloat1622float2(h2[u]);
          const int k0 = 2 * u, k1 = 2 * u + 1;
          h2[u] = __floats2bfloat162_rn(
              silu_fast(gn_affine(v.x, gn.mean[k0], gn.rstd[k0], gn.g[k0], gn.e[k0])),
              silu_fast(gn_affine(v.y, gn.mean[k1], gn.rstd[k1], gn.g[k1], gn.e[k1])));
        }
      }
#pragma unroll
      for (int k = 0; k < PASSES; ++k)
        if (in[k]) *reinterpret_cast<uint2*>(As + (r0 + k * RSTEP) * LDA + 4 * q4) = raw[k];
    }
    const Gn gn_next = load_gn(i + 1);
    fence_proxy_async();
    __syncthreads();

    const bf16* Bs = b_tile(i) + (nw0 / 8) * 64;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      // Warp w's rows 16w .. 16w+15 of sub-tile m; tap t reads them t rows on.
      uint32_t a[3][KS][4];
      const int row = (m0 + m) * 64 + warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldmatrix_x4(a[t][ks], As + (row + t) * LDA + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) hold(acc[m][j]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_rs<NW, DGRAD ? 0 : 1>(
              acc[m], a[t][ks], sm90_desc(Bs + (t * (BK / 8) + 2 * ks) * (BN / 8) * 64, BN * 16, 128));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) hold(a[t][ks][q]);
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) hold(acc[m][j]);
    }
    __syncthreads();  // buffer i % stages is refilled next iteration
    gn = gn_next;
  }

  // Epilogue. Thread (warp, lane) of a warpgroup holds rows 16w + lane/4
  // (+ 8) of each of its sub-tiles and channel pairs 8j + 2(lane % 4) of its
  // channels.
  const size_t total = (size_t)(gridDim.x / row_tiles) * L * C;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + (m0 + m) * 64 + warp * 16 + lane / 4 + 8 * h;
        const int co = n0 + nw0 + 8 * j + 2 * (lane % 4);
        if (l < L && co < C) {
          float v0 = acc[m][4 * j + 2 * h], v1 = acc[m][4 * j + 2 * h + 1];
          const size_t idx = ((size_t)b * L + l) * C + co;
          if (splits > 1) {
            *reinterpret_cast<float2*>(ws + split * total + idx) = make_float2(v0, v1);
          } else if constexpr (DGRAD) {
            const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + idx));
            const float2 s0 = st[co / cpg], s1 = st[(co + 1) / cpg];
            v0 *= silu_grad(gn_affine(u.x, s0.x, s0.y, to_f32(gamma[co]), to_f32(beta[co])));
            v1 *= silu_grad(gn_affine(u.y, s1.x, s1.y, to_f32(gamma[co + 1]), to_f32(beta[co + 1])));
            *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(v0, v1);
          } else {
            v0 += to_f32(bias[co]);
            v1 += to_f32(bias[co + 1]);
            if constexpr (MODE == kForwardResidual) {
              const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + idx));
              v0 = r.x + v0;
              v1 = r.y + v1;
            }
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
}

// out = bf16(sum_s ws[s] + bias (+ res)), the splits summed in order s = 0, 1, ..;
// the data gradient: out = f32(sum_s ws[s] * SiLU'(n)) with n the stage
// input res normalised as in conv3_sm90_kernel's epilogue.
// total = B * L * C, a multiple of 4.
template <int MODE>
__global__ void conv3_splitk_reduce(const float* __restrict__ ws, const float2* __restrict__ stats,
                                    const __nv_bfloat16* __restrict__ gamma,
                                    const __nv_bfloat16* __restrict__ beta,
                                    const __nv_bfloat16* __restrict__ bias,
                                    const __nv_bfloat16* __restrict__ res, void* __restrict__ out,
                                    int L, int C, int G, int splits, size_t total) {
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < total / 4;
       q += (size_t)gridDim.x * blockDim.x) {
    float4 v = w4[q];
    for (int s = 1; s < splits; ++s) {
      const float4 u = w4[s * (total / 4) + q];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int c = (int)(q * 4 % C);
    if constexpr (MODE == kDataGrad) {
      const float2* st = stats + q * 4 / ((size_t)L * C) * G;
      const int cpg = C / G;
      float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 ms = st[(c + e) / cpg];
        o[e] *= silu_grad(
            gn_affine(to_f32(res[q * 4 + e]), ms.x, ms.y, to_f32(gamma[c + e]), to_f32(beta[c + e])));
      }
      reinterpret_cast<float4*>(out)[q] = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      float o[4] = {v.x + to_f32(bias[c]), v.y + to_f32(bias[c + 1]), v.z + to_f32(bias[c + 2]),
                    v.w + to_f32(bias[c + 3])};
      if constexpr (MODE == kForwardResidual) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = to_f32(res[q * 4 + e]) + o[e];
      }
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + q * 4);
      o2[0] = __floats2bfloat162_rn(o[0], o[1]);
      o2[1] = __floats2bfloat162_rn(o[2], o[3]);
    }
  }
}

template <int BN, int MT, int BK, int MODE>
cudaError_t conv3_sm90_tile(const __nv_bfloat16* x, const float2* stats, const __nv_bfloat16* gamma,
                            const __nv_bfloat16* beta, const __nv_bfloat16* w,
                            const __nv_bfloat16* bias, const __nv_bfloat16* res,
                            void* out, float* ws, int B, int L, int C, int G, int splits,
                            int cps, int* smem_out, int* blocks_per_sm, cudaStream_t stream) {
  auto kernel = conv3_sm90_kernel<BN, MT, BK, MODE>;
  constexpr int MOST = SM90_STAGES * sm90_stage_bytes(BN, MT, BK);
  const int smem = (cps < SM90_STAGES ? cps : SM90_STAGES) * sm90_stage_bytes(BN, MT, BK);
  // More than 48 KB needs the kernel's attribute raised, once per device.
  static std::atomic<unsigned long long> raised{0};  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (MOST > 48 * 1024 && (dev >= 64 || !(raised.load() >> dev & 1))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MOST);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised.fetch_or(1ull << dev);
  }
  if (blocks_per_sm) {  // a query of the plan's occupancy, no launch
    *smem_out = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, SM90_THREADS, smem);
  }
  const int row_tiles = (L + 64 * MT - 1) / (64 * MT);
  const dim3 grid(row_tiles * B, (C + BN - 1) / BN, splits);
  kernel<<<grid, SM90_THREADS, smem, stream>>>(x, stats, gamma, beta, w, bias, res, out, ws, L, C,
                                                G, row_tiles, cps);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)B * L * C;
  const size_t want = (total / 4 + 255) / 256;
  const int blocks = want < 132 * 8 ? (int)want : 132 * 8;
  conv3_splitk_reduce<MODE><<<blocks, 256, 0, stream>>>(ws, stats, gamma, beta, bias, res, out, L,
                                                         C, G, splits, total);
  return cudaGetLastError();
}

// The bf16 conv (forward, or the data gradient into f32 out) with the tile
// (bn, mt, bk) and split (splits, cps) of conv_plan(). With blocks_per_sm set
// it launches nothing and reports the plan's dynamic shared memory and
// resident CTAs per SM. An unknown tile is cudaErrorInvalidValue.
template <int MODE>
cudaError_t conv3_sm90(int bn, int mt, int bk, const __nv_bfloat16* x, const float2* stats,
                       const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                       const __nv_bfloat16* w, const __nv_bfloat16* bias,
                       const __nv_bfloat16* res, void* out, float* ws, int B, int L,
                       int C, int G, int splits, int cps, cudaStream_t stream,
                       int* smem_out = nullptr, int* blocks_per_sm = nullptr) {
#define CONV3_SM90_TILE(BN_, MT_, BK_)                                                         \
  if (bn == BN_ && mt == MT_ && bk == BK_)                                                     \
    return conv3_sm90_tile<BN_, MT_, BK_, MODE>(x, stats, gamma, beta, w, bias, res, out, ws, B, \
                                                 L, C, G, splits, cps, smem_out, blocks_per_sm, \
                                                 stream);
  CONV3_SM90_TILE(8, 8, 16)
  CONV3_SM90_TILE(8, 2, 16)
  CONV3_SM90_TILE(32, 4, 32)
  CONV3_SM90_TILE(32, 1, 32)
  CONV3_SM90_TILE(64, 2, 32)
  CONV3_SM90_TILE(64, 1, 32)
  CONV3_SM90_TILE(128, 2, 32)
#undef CONV3_SM90_TILE
  return cudaErrorInvalidValue;
}

}  // namespace
