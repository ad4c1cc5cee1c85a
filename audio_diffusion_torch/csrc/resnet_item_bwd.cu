// Backward of the fused resnet(+modulation) item for Hopper (sm_90a),
// channels-last [B, L, C].
//
// Replaces the custom VJP of the TPU kernel (`_fwd`/`_bwd`,
// audio_diffusion_tpu/ops/kernels/resnet.py:193-219), which recomputes the
// gradient through the lax reference under XLA. Here the gradient of the same
// function is written out. Per conv stage, with u the stage input,
// xh = (u - mean) * rstd, n = xh * gamma + beta, a = SiLU(n) rounded to the
// activation type, v = conv3(a, K) + b and dv the gradient of v:
//
//   db[co]        = sum_{b,l} dv[b, l, co]
//   dK[t, ci, co] = sum_{b,l} a[b, l - 1 + t, ci] * dv[b, l, co]
//   dn[l, ci]     = (sum_t sum_co dv[l + 1 - t, co] * K[t, ci, co]) * SiLU'(n)
//   dgamma[c]     = sum_{b,l} dn * xh,   dbeta[c] = sum_{b,l} dn
//   du            = rstd * (gamma * dn - mean_g(gamma * dn) - xh * mean_g(gamma * dn * xh))
//
// (mean_g over the group's L * C / G elements; where the forward's clamp of
// the variance at 0 binds, the last term is dropped). The modulation epilogue
// out = y + (xh * gamma_m + beta_m) * (1 + scale) + shift is the same
// GroupNorm backward with the per-(batch, channel) factor gamma_m * (1 + scale)
// and the incoming gradient g in place of dn, plus dy = g + ..., and
// dscale = sum_l g * hm, dshift = sum_l g. The residual adds dy to dx.
//
// What the forward keeps for it: x, conv 1's output h, the unmodulated item y
// and the three stages' statistics. The activated tensors a are never in
// device memory; the weight gradient recomputes them in its prologue exactly
// as the forward conv does.
//
// What bounds it on an H100: per batch row the four products (two data
// gradients, two weight gradients) are 24*C^2*L FLOPs, and the passes move
// about twenty activation-sized tensors and 12*C^2 weights and weight
// gradients; like the forward, the shallow levels and (at batch 1) the
// deepest are bound by bytes, the middle by operations. In practice the first
// limits are launch latency (18 launches per item) and, at level 0, tiles that
// are 64 channels wide for 8 channels.
//
// The kernels, in launch order per stage:
//   conv3_wgrad      dK as a product whose inner dimension is B*L: one
//                    64 (in) x 64 (out) tile of all three taps per CTA, over a
//                    slab of 32-row chunks of (batch, position); chunks arrive
//                    by cp.async, double-buffered; the input chunk is
//                    normalised and activated in shared memory. bf16 on the
//                    tensor cores (WMMA, A column-major), f32 on FMAs. Each
//                    slab writes an f32 partial [3, C, C];
//   wgrad_finalize   sums the slabs in order and rounds once. The caller picks
//                    the slab count: many slabs where C is small and B*L long
//                    (level 0: a reduction over millions of rows into 3x8x8),
//                    one or two where C = 1024 (a partial is 12.6 MB);
//   conv3 (kDataGrad, resnet_common.cuh) dn, the forward's loop reused;
//   gn_bwd_partial   per-(L tile, channel) sums of dn, dn * xh and dv (stage 1),
//   gn_bwd_finalize  per-(batch, channel) sums in a fixed order, and the two
//                    group means (stage 2),
//   gn_bwd_params    dgamma, dbeta and db (or dgamma_m, dbeta_m, dscale, dshift),
//   gn_bwd_apply     du, elementwise.
// All reductions run in a fixed order, so the gradients are deterministic.
// Sums are f32; each returned gradient is rounded once to its input's type.
// The gradients passed between stages, dy and dh, are stored in the
// activation type (they are the tensor cores' operands), dn in f32: rounded
// to bf16 it would sit on a grid that the GroupNorm backward's small mean
// terms cannot move, and the sums over 2^18 positions drift.
#include "resnet_common.cuh"

namespace {

constexpr int RED_THREADS = 256;
constexpr int WG_TM = 64;  // input channels (rows of dK) per CTA
constexpr int WG_TN = 64;  // output channels (cols of dK) per CTA
constexpr int WG_BL = 32;  // positions per chunk of the inner dimension

// Sums over the rows of a [rows, C] slice, 256 threads: thread (ry, cx) takes
// channel c0 + cx and rows ry, ry + rpb, ..; the rpb row lanes are then
// summed in order through shared memory by lane 0. `load(r, c, v)` adds row
// r's terms to v[0..2]; `done(c, v)` receives the sums.
template <typename Load, typename Done>
__device__ __forceinline__ void column_sums(int rows, int C, Load load, Done done) {
  __shared__ float red[3][RED_THREADS];
  const int tid = threadIdx.x;
  const int cw = C < RED_THREADS ? C : RED_THREADS;
  const int rpb = RED_THREADS / cw;
  const int ry = tid / cw, cx = tid % cw;
  for (int c0 = 0; c0 < C; c0 += cw) {
    const int c = c0 + cx;
    const bool live = ry < rpb && c < C;
    float v[3] = {0.f, 0.f, 0.f};
    if (live)
      for (int r = ry; r < rows; r += rpb) load(r, c, v);
    if (rpb > 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) red[k][tid] = v[k];
      __syncthreads();
      if (live && ry == 0)
        for (int j = 1; j < rpb; ++j)
#pragma unroll
          for (int k = 0; k < 3; ++k) v[k] += red[k][j * cw + cx];
      __syncthreads();
    }
    if (live && ry == 0) done(c, v);
  }
}

// Stage 1: grid (n_tiles, B). partial [B, n_tiles, C, 3] f32 holds, per
// channel over the tile's rows, sum d, sum d * xh and sum e (e may be null).
template <typename T, typename TD>
__global__ void __launch_bounds__(RED_THREADS)
gn_bwd_partial_kernel(const TD* __restrict__ d, const T* __restrict__ u, const T* __restrict__ e,
                      const float2* __restrict__ stats, float* __restrict__ partial, int L, int C,
                      int G, int rows_per_tile) {
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int r0 = tile * rows_per_tile;
  const int rows = min(L, r0 + rows_per_tile) - r0;
  const int cpg = C / G;
  const size_t base = ((size_t)b * L + r0) * C;
  column_sums(
      rows, C,
      [&](int r, int c, float* v) {
        const size_t idx = base + (size_t)r * C + c;
        const float2 ms = stats[(size_t)b * G + c / cpg];
        const float dd = to_f32<TD>(d[idx]);
        v[0] += dd;
        v[1] += dd * ((to_f32(u[idx]) - ms.x) * ms.y);
        if (e != nullptr) v[2] += to_f32(e[idx]);
      },
      [&](int c, const float* v) {
        float* p = partial + (((size_t)b * n_tiles + tile) * C + c) * 3;
        p[0] = v[0];
        p[1] = v[1];
        p[2] = v[2];
      });
}

// Stage 2: grid (B). col [B, C, 3] f32 = the tiles summed in order; means
// [B, G] float2 = (mean_g(f * d), mean_g(f * d * xh)) with the factor
// f = gamma[c] * (1 + scale[b, c]) (scale may be null). Where the forward
// clamped the variance to 0, the second mean is 0.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
gn_bwd_finalize_kernel(const float* __restrict__ partial, const float2* __restrict__ stats,
                       const T* __restrict__ gamma, const T* __restrict__ scale,
                       float* __restrict__ col, float2* __restrict__ means, int n_tiles, int C,
                       int G, float count, float eps) {
  const int b = blockIdx.x;
  const float* pb = partial + (size_t)b * n_tiles * C * 3;
  float* cb = col + (size_t)b * C * 3;
  column_sums(
      n_tiles, C,
      [&](int r, int c, float* v) {
        const float* p = pb + ((size_t)r * C + c) * 3;
        v[0] += p[0];
        v[1] += p[1];
        v[2] += p[2];
      },
      [&](int c, const float* v) {
        cb[c * 3 + 0] = v[0];
        cb[c * 3 + 1] = v[1];
        cb[c * 3 + 2] = v[2];
      });
  __syncthreads();
  const int cpg = C / G;
  for (int g = threadIdx.x; g < G; g += RED_THREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      float f = to_f32(gamma[c]);
      if (scale != nullptr) f *= 1.f + to_f32(scale[(size_t)b * C + c]);
      s1 += f * cb[c * 3 + 0];
      s2 += f * cb[c * 3 + 1];
    }
    if (stats[(size_t)b * G + g].y == rsqrtf(eps)) s2 = 0.f;
    means[(size_t)b * G + g] = make_float2(s1 / count, s2 / count);
  }
}

// Parameter gradients from col, one thread per channel, batch rows in order.
// A conv stage (scale null): dgamma, dbeta, dbias [C]. The modulation stage:
// dgamma, dbeta [C] weighted by (1 + scale), dscale and dshift [B, C].
template <typename T>
__global__ void gn_bwd_params_kernel(const float* __restrict__ col, const T* __restrict__ gamma,
                                     const T* __restrict__ beta, const T* __restrict__ scale,
                                     T* __restrict__ dgamma, T* __restrict__ dbeta,
                                     T* __restrict__ dbias, T* __restrict__ dscale,
                                     T* __restrict__ dshift, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f, de = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = col + ((size_t)b * C + c) * 3;
    if (scale != nullptr) {
      const float f = 1.f + to_f32(scale[(size_t)b * C + c]);
      dg += f * p[1];
      db += f * p[0];
      dscale[(size_t)b * C + c] = from_f32<T>(to_f32(gamma[c]) * p[1] + to_f32(beta[c]) * p[0]);
      dshift[(size_t)b * C + c] = from_f32<T>(p[0]);
    } else {
      dg += p[1];
      db += p[0];
      de += p[2];
    }
  }
  dgamma[c] = from_f32<T>(dg);
  dbeta[c] = from_f32<T>(db);
  if (scale == nullptr) dbias[c] = from_f32<T>(de);
}

// out <- (extra or 0) + rstd * (f * d - m1 - xh * m2), f as above, (m1, m2)
// the group's means. out may be extra (or d, where the types agree).
template <typename T, typename TD>
__global__ void gn_bwd_apply_kernel(const TD* d, const T* __restrict__ u, const T* extra, T* out,
                                    const float2* __restrict__ stats,
                                    const float2* __restrict__ means,
                                    const T* __restrict__ gamma, const T* __restrict__ scale,
                                    int L, int C, int G, size_t total) {
  const int cpg = C / G;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    const size_t b = idx / ((size_t)L * C);
    const float2 ms = stats[b * G + c / cpg];
    const float2 mm = means[b * G + c / cpg];
    float f = to_f32(gamma[c]);
    if (scale != nullptr) f *= 1.f + to_f32(scale[b * C + c]);
    const float xh = (to_f32(u[idx]) - ms.x) * ms.y;
    float v = ms.y * (f * to_f32<TD>(d[idx]) - mm.x - xh * mm.y);
    if (extra != nullptr) v += to_f32(extra[idx]);
    out[idx] = from_f32<T>(v);
  }
}

// partial[slab, t, ci, co] = sum over the slab's chunks of
//   act(u[b, l - 1 + t, ci]) * dv[b, l, co],
// act as in the forward conv (zero outside [0, L)). A chunk q is WG_BL
// positions of one batch row: b = q / chunks_per_row, l0 = (q % chunks_per_row)
// * WG_BL; slab z takes chunks [z * chunks_per_slab, (z + 1) * chunks_per_slab).
// grid (ceil(C / WG_TM) * ceil(C / WG_TN), n_slabs), THREADS threads.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3_wgrad_kernel(const T* __restrict__ u, const float2* __restrict__ stats,
                   const T* __restrict__ gamma, const T* __restrict__ beta,
                   const T* __restrict__ dv, float* __restrict__ partial, int L, int C, int G,
                   int chunks_per_row, int total_chunks, int chunks_per_slab) {
  constexpr bool TC = sizeof(T) == 2;
  constexpr int LDA = WG_TM + 16;  // pitch of the input chunk [WG_BL + 2, WG_TM]
  constexpr int LDD = WG_TN + 8;   // pitch of the gradient chunk [WG_BL, WG_TN]
  constexpr int VEC = 16 / sizeof(T);
  constexpr int A_ELEMS = (WG_BL + 2) * LDA;
  constexpr int D_ELEMS = WG_BL * LDD;
  constexpr int A_VECS = (WG_BL + 2) * WG_TM / VEC;
  constexpr int D_VECS = WG_BL * WG_TN / VEC;
  // Two stages of [input chunk | gradient chunk]; the bf16 epilogue reuses
  // them as one f32 [WG_TM, LDC] tile.
  static_assert(!TC || 2 * (A_ELEMS + D_ELEMS) * sizeof(T) >= WG_TM * LDC * 4, "epilogue tile");
  __shared__ __align__(128) unsigned char smem[2 * (A_ELEMS + D_ELEMS) * sizeof(T)];
  T* As[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + A_ELEMS + D_ELEMS};
  T* Ds[2] = {As[0] + A_ELEMS, As[1] + A_ELEMS};

  const int tiles_n = (C + WG_TN - 1) / WG_TN;
  const int m0 = (blockIdx.x / tiles_n) * WG_TM, n0 = (blockIdx.x % tiles_n) * WG_TN;
  const int slab = blockIdx.y;
  const int q_begin = slab * chunks_per_slab;
  const int q_end = min(total_chunks, q_begin + chunks_per_slab);
  const int tid = threadIdx.x;
  const int cpg = C / G;

  auto stage = [&](int q, int s) {
    const int b = q / chunks_per_row, l0 = (q % chunks_per_row) * WG_BL;
    const T* ub = u + (size_t)b * L * C;
    const T* db = dv + (size_t)b * L * C;
    for (int v = tid; v < A_VECS; v += THREADS) {
      const int r = v / (WG_TM / VEC), mm = (v % (WG_TM / VEC)) * VEC;
      const int l = l0 - 1 + r, c = m0 + mm;
      const bool ok = l >= 0 && l < L && c < C;
      cp_async16(As[s] + r * LDA + mm, ok ? ub + (size_t)l * C + c : ub, ok);
    }
    for (int v = tid; v < D_VECS; v += THREADS) {
      const int r = v / (WG_TN / VEC), nn = (v % (WG_TN / VEC)) * VEC;
      const int l = l0 + r, c = n0 + nn;
      const bool ok = l < L && c < C;
      cp_async16(Ds[s] + r * LDD + nn, ok ? db + (size_t)l * C + c : db, ok);
    }
    cp_async_commit();
  };

  // bf16: warp (wm, wn) owns rows wm*32.., cols wn*32.. of every tap: 3 x 2 x 2
  // fragments. f32: thread (tr, tc) owns rows tr*8.., cols tc*4.. of every tap.
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_tc[3][2][2];
  const int tr = tid / 16, tcol = tid % 16;
  float acc[3][8][4];
  if constexpr (TC) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc_tc[t][i][j], 0.f);
  } else {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
  }

  // Each thread normalises one channel of the input chunk (THREADS is a
  // multiple of WG_TM); its scale and bias do not change between chunks.
  const int nm = tid % WG_TM, nc = m0 + nm;
  const float ng = nc < C ? to_f32(gamma[nc]) : 0.f;
  const float nb = nc < C ? to_f32(beta[nc]) : 0.f;

  if (q_begin < q_end) stage(q_begin, 0);
  for (int q = q_begin, s = 0; q < q_end; ++q, s ^= 1) {
    if (q + 1 < q_end) {
      stage(q + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {
      const int b = q / chunks_per_row, l0 = (q % chunks_per_row) * WG_BL;
      float2 ms = make_float2(0.f, 0.f);
      if (nc < C) ms = stats[(size_t)b * G + nc / cpg];
      for (int r = tid / WG_TM; r < WG_BL + 2; r += THREADS / WG_TM) {
        const int l = l0 - 1 + r;
        float v = 0.f;
        if (l >= 0 && l < L && nc < C)
          v = silu(gn_affine(to_f32(As[s][r * LDA + nm]), ms.x, ms.y, ng, nb));
        As[s][r * LDA + nm] = from_f32<T>(v);
      }
    }
    __syncthreads();

    if constexpr (TC) {
      const __nv_bfloat16* A = reinterpret_cast<const __nv_bfloat16*>(As[s]);
      const __nv_bfloat16* D = reinterpret_cast<const __nv_bfloat16*>(Ds[s]);
#pragma unroll
      for (int kk = 0; kk < WG_BL; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::row_major> bf[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::load_matrix_sync(bf[j], D + kk * LDD + wn * 32 + j * 16, LDD);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // A[m = ci, k = position]: activated row k + t of the chunk
            // (position l - 1 + t), channels contiguous: column-major.
            nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                   nvcuda::wmma::col_major> a;
            nvcuda::wmma::load_matrix_sync(a, A + (kk + t) * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              nvcuda::wmma::mma_sync(acc_tc[t][i][j], a, bf[j], acc_tc[t][i][j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < WG_BL; ++k) {
        float dvv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) dvv[j] = to_f32(Ds[s][k * LDD + tcol * 4 + j]);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          float av[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) av[i] = to_f32(As[s][(k + t) * LDA + tr * 8 + i]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[t][i][j] = fmaf(av[i], dvv[j], acc[t][i][j]);
        }
      }
    }
    __syncthreads();  // buffer s is refilled by the next iteration's stage()
  }

  float* pz = partial + (size_t)slab * 3 * C * C;
  if constexpr (TC) {
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                          acc_tc[t][i][j], LDC, nvcuda::wmma::mem_row_major);
      __syncthreads();
      for (int idx = tid; idx < WG_TM * WG_TN; idx += THREADS) {
        const int i = idx / WG_TN, j = idx % WG_TN;
        const int ci = m0 + i, co = n0 + j;
        if (ci < C && co < C) pz[((size_t)t * C + ci) * C + co] = Cs[i * LDC + j];
      }
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = m0 + tr * 8 + i, co = n0 + tcol * 4 + j;
          if (ci < C && co < C) pz[((size_t)t * C + ci) * C + co] = acc[t][i][j];
        }
  }
}

// dk[i] = the slabs' partials summed in order, rounded once.
template <typename T>
__global__ void wgrad_finalize_kernel(const float* __restrict__ partial, T* __restrict__ dk,
                                      int n_slabs, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < n_slabs; ++z) s += partial[(size_t)z * n + i];
    dk[i] = from_f32<T>(s);
  }
}

int elementwise_blocks(size_t total) {
  const size_t want = (total + 255) / 256;
  return want < 132 * 16 ? (int)want : 132 * 16;
}

#define LAUNCH_CHECK()                                  \
  do {                                                  \
    const int e_ = (int)cudaGetLastError();             \
    if (e_) return e_;                                  \
  } while (0)

struct Shape {
  int B, L, C, G, rows_per_tile, chunks_per_slab, n_slabs;
  float eps;
};

struct Scratch {
  float* red_partial;  // [B, n_tiles, C, 3]
  float* col;          // [B, C, 3]
  float2* means;       // [B, G]
  float* wpartial;     // [n_slabs, 3, C, C]
};

// The GroupNorm backward of one stage: d is the gradient of the stage's
// normalised-and-scaled value, u the stage input; out <- (extra) + du.
template <typename T, typename TD>
int gn_backward(const TD* d, const T* u, const T* e, const T* extra, T* out, const float2* stats,
                const T* gamma, const T* beta, const T* scale, T* dgamma, T* dbeta, T* dbias,
                T* dscale, T* dshift, const Shape& sh, const Scratch& sc, cudaStream_t stream) {
  const int n_tiles = (sh.L + sh.rows_per_tile - 1) / sh.rows_per_tile;
  gn_bwd_partial_kernel<T, TD><<<dim3(n_tiles, sh.B), RED_THREADS, 0, stream>>>(
      d, u, e, stats, sc.red_partial, sh.L, sh.C, sh.G, sh.rows_per_tile);
  LAUNCH_CHECK();
  gn_bwd_finalize_kernel<T><<<sh.B, RED_THREADS, 0, stream>>>(
      sc.red_partial, stats, gamma, scale, sc.col, sc.means, n_tiles, sh.C, sh.G,
      (float)sh.L * (sh.C / sh.G), sh.eps);
  LAUNCH_CHECK();
  gn_bwd_params_kernel<T><<<(sh.C + 255) / 256, 256, 0, stream>>>(
      sc.col, gamma, beta, scale, dgamma, dbeta, dbias, dscale, dshift, sh.B, sh.C);
  LAUNCH_CHECK();
  const size_t total = (size_t)sh.B * sh.L * sh.C;
  gn_bwd_apply_kernel<T, TD><<<elementwise_blocks(total), 256, 0, stream>>>(
      d, u, extra, out, stats, sc.means, gamma, scale, sh.L, sh.C, sh.G, total);
  LAUNCH_CHECK();
  return 0;
}

// One conv stage: dk and dn (f32, into dn_out) from the stage input u and dv.
template <typename T>
int conv_backward(const T* u, const T* dv, const float2* stats, const T* gamma, const T* beta,
                  const T* k, T* dk, float* dn_out, const Shape& sh, const Scratch& sc,
                  cudaStream_t stream) {
  const int chunks_per_row = (sh.L + WG_BL - 1) / WG_BL;
  const int tiles = ((sh.C + WG_TM - 1) / WG_TM) * ((sh.C + WG_TN - 1) / WG_TN);
  conv3_wgrad_kernel<T><<<dim3(tiles, sh.n_slabs), THREADS, 0, stream>>>(
      u, stats, gamma, beta, dv, sc.wpartial, sh.L, sh.C, sh.G, chunks_per_row,
      sh.B * chunks_per_row, sh.chunks_per_slab);
  LAUNCH_CHECK();
  const size_t n = (size_t)3 * sh.C * sh.C;
  wgrad_finalize_kernel<T><<<elementwise_blocks(n), 256, 0, stream>>>(sc.wpartial, dk, sh.n_slabs,
                                                                     n);
  LAUNCH_CHECK();
  const dim3 grid((sh.L + BM - 1) / BM, (sh.C + BN - 1) / BN, sh.B);
  conv3_kernel<T, kDataGrad, float><<<grid, THREADS, 0, stream>>>(dv, stats, gamma, beta, k, nullptr, u,
                                                           dn_out, sh.L, sh.C, sh.G);
  LAUNCH_CHECK();
  return 0;
}

template <typename T>
struct ItemBackwardArgs {
  const T *g, *x, *h, *y, *gn1s, *gn1b, *k1, *gn2s, *gn2b, *k2, *mods, *mgs, *mgb;
  T *dx, *dgn1s, *dgn1b, *dk1, *dc1b, *dgn2s, *dgn2b, *dk2, *dc2b, *dmods, *dmodb, *dmgs, *dmgb;
  T *dy, *dh;
  float* dn;
};

template <typename T>
int item_backward(const ItemBackwardArgs<T>& a, const float2* stats, const Shape& sh,
                  const Scratch& sc, int use_modulation, cudaStream_t stream) {
  const float2* stats1 = stats;
  const float2* stats2 = stats + (size_t)sh.B * sh.G;
  const float2* stats3 = stats + (size_t)2 * sh.B * sh.G;
  int err;
  // Modulation: dy = g + GN backward of g with the factor gamma_m * (1 + scale).
  const T* dy = a.g;
  if (use_modulation) {
    if ((err = gn_backward<T, T>(a.g, a.y, nullptr, a.g, a.dy, stats3, a.mgs, a.mgb, a.mods, a.dmgs,
                              a.dmgb, nullptr, a.dmods, a.dmodb, sh, sc, stream)))
      return err;
    dy = a.dy;
  }
  // Stage 2 (input h, output gradient dy): dk2, then dn2 -> dh.
  if ((err = conv_backward<T>(a.h, dy, stats2, a.gn2s, a.gn2b, a.k2, a.dk2, a.dn, sh, sc,
                              stream)))
    return err;
  if ((err = gn_backward<T, float>(a.dn, a.h, dy, nullptr, a.dh, stats2, a.gn2s, a.gn2b,
                                   nullptr, a.dgn2s, a.dgn2b, a.dc2b, nullptr, nullptr, sh, sc,
                                   stream)))
    return err;
  // Stage 1 (input x, output gradient dh): dk1, then dn1 -> dx = dy + du.
  if ((err = conv_backward<T>(a.x, a.dh, stats1, a.gn1s, a.gn1b, a.k1, a.dk1, a.dn, sh, sc,
                              stream)))
    return err;
  return gn_backward<T, float>(a.dn, a.x, a.dh, dy, a.dx, stats1, a.gn1s, a.gn1b, nullptr,
                               a.dgn1s, a.dgn1b, a.dc1b, nullptr, nullptr, sh, sc, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// in:  g (gradient of the item's output), x, h, y [B, L, C] and stats
//      [3, B, G, 2] f32 as the forward left them; the forward's parameters
//      (conv biases and the modulation shift are not needed);
// out: the 13 gradients, each shaped and typed like its input;
// scratch: dy, dh [B, L, C]; dn f32 [B, L, C]; red_partial f32 [B, ceil(L / rows_per_tile), C, 3];
//      col f32 [B, C, 3]; means f32 [B, G, 2]; wpartial f32 [n_slabs, 3, C, C],
//      n_slabs = ceil(B * ceil(L / 32) / chunks_per_slab).
// Without modulation the modulation pointers and dy are not touched. Returns
// the first CUDA error code seen after a launch, 0 on success.
extern "C" int resnet_item_backward(
    int dtype, const void* g, const void* x, const void* h, const void* y, const void* stats,
    const void* gn1s, const void* gn1b, const void* k1, const void* gn2s, const void* gn2b,
    const void* k2, const void* mods, const void* mgs, const void* mgb, void* dx, void* dgn1s,
    void* dgn1b, void* dk1, void* dc1b, void* dgn2s, void* dgn2b, void* dk2, void* dc2b,
    void* dmods, void* dmodb, void* dmgs, void* dmgb, void* dy, void* dh, void* dn,
    void* red_partial, void* col, void* means, void* wpartial, int B, int L, int C, int G,
    int rows_per_tile, int chunks_per_slab, int n_slabs, float eps, int use_modulation,
    void* stream) {
  const Shape sh{B, L, C, G, rows_per_tile, chunks_per_slab, n_slabs, eps};
  const Scratch sc{static_cast<float*>(red_partial), static_cast<float*>(col),
                   static_cast<float2*>(means), static_cast<float*>(wpartial)};
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<const float2*>(stats);
  if (dtype == 0) {
    using T = float;
    const ItemBackwardArgs<T> a{
        (const T*)g, (const T*)x, (const T*)h, (const T*)y, (const T*)gn1s, (const T*)gn1b,
        (const T*)k1, (const T*)gn2s, (const T*)gn2b, (const T*)k2, (const T*)mods,
        (const T*)mgs, (const T*)mgb, (T*)dx, (T*)dgn1s, (T*)dgn1b, (T*)dk1, (T*)dc1b,
        (T*)dgn2s, (T*)dgn2b, (T*)dk2, (T*)dc2b, (T*)dmods, (T*)dmodb, (T*)dmgs, (T*)dmgb,
        (T*)dy, (T*)dh, (float*)dn};
    return item_backward<T>(a, st, sh, sc, use_modulation, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const ItemBackwardArgs<T> a{
        (const T*)g, (const T*)x, (const T*)h, (const T*)y, (const T*)gn1s, (const T*)gn1b,
        (const T*)k1, (const T*)gn2s, (const T*)gn2b, (const T*)k2, (const T*)mods,
        (const T*)mgs, (const T*)mgb, (T*)dx, (T*)dgn1s, (T*)dgn1b, (T*)dk1, (T*)dc1b,
        (T*)dgn2s, (T*)dgn2b, (T*)dk2, (T*)dc2b, (T*)dmods, (T*)dmodb, (T*)dmgs, (T*)dmgb,
        (T*)dy, (T*)dh, (float*)dn};
    return item_backward<T>(a, st, sh, sc, use_modulation, s);
  }
  return (int)cudaErrorInvalidValue;
}
