// Shared by resnet_item.cu (forward) and resnet_item_bwd.cu (backward): the
// element conversions, the cp.async helpers and the k=3 convolution kernel,
// which runs the forward's two convolutions and, with the weight taps flipped
// and transposed on the way into shared memory, the backward's data gradient.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 32;        // output positions per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int THREADS = 128;  // 4 warps
constexpr int LDB = BN + 8;   // smem row pitch of a weight tap (elements)
constexpr int LDC = BN + 4;   // smem row pitch of the f32 output tile

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The GroupNorm output n = (v - mean) * rstd * gamma + beta, SiLU(n) and SiLU'(n).
__device__ __forceinline__ float gn_affine(float v, float mean, float rstd, float g, float be) {
  return (v - mean) * rstd * g + be;
}
__device__ __forceinline__ float silu(float n) { return n / (1.f + expf(-n)); }
__device__ __forceinline__ float silu_grad(float n) {
  const float s = 1.f / (1.f + expf(-n));
  return s * (1.f + n * (1.f - s));
}

enum ConvMode { kForward = 0, kForwardResidual = 1, kDataGrad = 2 };

// kForward / kForwardResidual:
//   out[b, l, co] = sum_t sum_ci act(x[b, l - 1 + t, ci]) * w[t, ci, co] + bias[co]
//                   (+ res[b, l, co] when kForwardResidual),
//   act(v) = SiLU((v - mean) * rstd * gamma + beta), zero outside [0, L).
// kDataGrad (x is the gradient dv of the conv's output, res the stage input u):
//   out[b, l, ci] = (sum_t sum_co x[b, l + 1 - t, co] * w[t, ci, co]) * SiLU'(n[b, l, ci]),
//   n = (u - mean) * rstd * gamma + beta: the same loop over position l - 1 + t'
//   with tap t' = 2 - t and each tap transposed, an identity prologue, and the
//   activation's derivative folded into the epilogue. TO is the output's
//   type: the activation type in the forward, f32 for the data gradient.
// grid (ceil(L / BM), ceil(C / BN), B), THREADS threads. Needs C % 8 == 0 and
// 16-byte aligned x and w (checked by the wrapper).
template <typename T, int MODE, typename TO = T>
__global__ void __launch_bounds__(THREADS)
conv3_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
             const T* __restrict__ gamma, const T* __restrict__ beta,
             const T* __restrict__ w, const T* __restrict__ bias,
             const T* __restrict__ res, TO* __restrict__ out, int L, int C, int G) {
  constexpr bool TC = sizeof(T) == 2;     // bf16 runs on the tensor cores
  constexpr bool DGRAD = MODE == kDataGrad;
  constexpr int BK = TC ? 32 : 16;        // input channels per K chunk
  constexpr int LDA = BK + 16;            // smem row pitch of the input tile (elements)
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte copy
  // Weight tile: forward [3 * BK, BN] (tap, in, out) as in memory; data
  // gradient [3 * BN, BK] (tap, in, out) too, where "in" is now the output
  // channel of this kernel and "out" its K axis, read as a column-major B.
  constexpr int LDW = DGRAD ? (TC ? BK + 8 : BK + 4) : LDB;
  constexpr int A_ELEMS = (BM + 2) * LDA;
  constexpr int W_ELEMS = (DGRAD ? 3 * BN : 3 * BK) * LDW;
  constexpr int A_VECS = (BM + 2) * BK / VEC;
  constexpr int W_VECS = 3 * BK * BN / VEC;
  constexpr int C_BYTES = TC ? BM * LDC * 4 : 0;
  // Two stages of [input tile | weight tile], then the f32 output tile (bf16).
  __shared__ __align__(128) unsigned char smem[2 * (A_ELEMS + W_ELEMS) * sizeof(T) + C_BYTES];
  T* As[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + A_ELEMS + W_ELEMS};
  T* Ws[2] = {As[0] + A_ELEMS, As[1] + A_ELEMS};

  const int l0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cpg = C / G;
  const T* xb = x + (size_t)b * L * C;
  const float2* st = stats + (size_t)b * G;

  // Stage K chunk k0 into buffer s with cp.async: raw input rows l0-1 .. l0+BM
  // (zero outside [0, L) and past C) and the three weight taps' blocks (zero
  // past C). The copies are in flight while the previous chunk is multiplied.
  auto stage = [&](int k0, int s) {
    for (int v = tid; v < A_VECS; v += THREADS) {
      const int r = v / (BK / VEC), kk = (v % (BK / VEC)) * VEC;
      const int l = l0 - 1 + r, c = k0 + kk;
      const bool ok = l >= 0 && l < L && c < C;
      cp_async16(As[s] + r * LDA + kk, ok ? xb + (size_t)l * C + c : xb, ok);
    }
    for (int v = tid; v < W_VECS; v += THREADS) {
      if constexpr (DGRAD) {
        const int row = v / (BK / VEC), kk = (v % (BK / VEC)) * VEC;
        const int t = row / BN, nn = row % BN;
        const int ci = n0 + nn, co = k0 + kk;
        const bool ok = ci < C && co < C;
        cp_async16(Ws[s] + row * LDW + kk, ok ? w + ((size_t)(2 - t) * C + ci) * C + co : w, ok);
      } else {
        const int row = v / (BN / VEC), nn = (v % (BN / VEC)) * VEC;
        const int t = row / BK, kk = row % BK;
        const int c = k0 + kk, co = n0 + nn;
        const bool ok = c < C && co < C;
        cp_async16(Ws[s] + row * LDW + nn, ok ? w + ((size_t)t * C + c) * C + co : w, ok);
      }
    }
    cp_async_commit();
  };

  // bf16: warp (wm, wn) owns rows wm*16.., cols wn*32.. as two 16x16 fragments.
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_tc[2];
  // f32: thread (tr, tc) owns rows tr*4.. in registers, and cols tc*4.. (the
  // data gradient: cols tc, tc+16, .., which spreads its transposed weight
  // reads over the shared-memory banks).
  const int tr = tid / 16, tcol = tid % 16;
  auto col = [&](int j) { return DGRAD ? tcol + 16 * j : tcol * 4 + j; };
  float acc[4][4];
  if constexpr (TC) {
    nvcuda::wmma::fill_fragment(acc_tc[0], 0.f);
    nvcuda::wmma::fill_fragment(acc_tc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  stage(0, 0);
  for (int k0 = 0, s = 0; k0 < C; k0 += BK, s ^= 1) {
    if (k0 + BK < C) {
      stage(k0 + BK, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Forward: normalise and activate the input tile in place. THREADS is a
    // multiple of BK, so each thread sees one channel and loads its vectors
    // once. The data gradient multiplies the raw tile (zero-filled edges).
    if constexpr (!DGRAD) {
      const int kk = tid % BK, c = k0 + kk;
      float mean = 0.f, rstd = 0.f, g = 0.f, be = 0.f;
      if (c < C) {
        const float2 ms = st[c / cpg];
        mean = ms.x;
        rstd = ms.y;
        g = to_f32(gamma[c]);
        be = to_f32(beta[c]);
      }
      for (int r = tid / BK; r < BM + 2; r += THREADS / BK) {
        const int l = l0 - 1 + r;
        float v = 0.f;
        if (l >= 0 && l < L && c < C)
          v = silu(gn_affine(to_f32(As[s][r * LDA + kk]), mean, rstd, g, be));
        As[s][r * LDA + kk] = from_f32<T>(v);
      }
      __syncthreads();
    }

    if constexpr (TC) {
      using BLayout = std::conditional_t<DGRAD, nvcuda::wmma::col_major, nvcuda::wmma::row_major>;
      const __nv_bfloat16* A = reinterpret_cast<const __nv_bfloat16*>(As[s]);
      const __nv_bfloat16* W = reinterpret_cast<const __nv_bfloat16*>(Ws[s]);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                 nvcuda::wmma::row_major> a;
          // Output row i reads input row i + t (position l - 1 + t).
          nvcuda::wmma::load_matrix_sync(a, A + (wm * 16 + t) * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
            const int n = wn * 32 + j * 16;
            nvcuda::wmma::load_matrix_sync(
                bf, DGRAD ? W + (t * BN + n) * LDW + kk : W + (t * BK + kk) * LDW + n, LDW);
            nvcuda::wmma::mma_sync(acc_tc[j], a, bf, acc_tc[j]);
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_f32(As[s][(tr * 4 + i + t) * LDA + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = to_f32(DGRAD ? Ws[s][(t * BN + col(j)) * LDW + kk]
                                 : Ws[s][(t * BK + kk) * LDW + col(j)]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // buffer s is refilled by the next iteration's stage()
  }

  // Epilogue in f32, one rounding to the activation type. Forward: + bias
  // (+ residual). Data gradient: times SiLU'(n) at the stage input.
  TO* ob = out + (size_t)b * L * C;
  const T* rb = MODE != kForward ? res + (size_t)b * L * C : nullptr;
  auto store = [&](int i, int j, float v) {
    const int l = l0 + i, co = n0 + j;
    if (l < L && co < C) {
      if constexpr (DGRAD) {
        const float2 ms = st[co / cpg];
        v *= silu_grad(gn_affine(to_f32(rb[(size_t)l * C + co]), ms.x, ms.y, to_f32(gamma[co]),
                                 to_f32(beta[co])));
      } else {
        v += to_f32(bias[co]);
        if constexpr (MODE == kForwardResidual) v = to_f32(rb[(size_t)l * C + co]) + v;
      }
      ob[(size_t)l * C + co] = from_f32<TO>(v);
    }
  };
  if constexpr (TC) {
    float* Cs = reinterpret_cast<float*>(smem + 2 * (A_ELEMS + W_ELEMS) * sizeof(T));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + (wm * 16) * LDC + wn * 32 + j * 16, acc_tc[j], LDC,
                                      nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int i = idx / BN, j = idx % BN;
      store(i, j, Cs[i * LDC + j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) store(tr * 4 + i, col(j), acc[i][j]);
  }
}

}  // namespace
