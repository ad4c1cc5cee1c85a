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
// limits are launch latency (18 launches per item) and filling the card with
// the two products, which wgrad_sm90.cuh and conv3_sm90.cuh answer (their
// headers say how).
//
// The kernels, in launch order per stage:
//   weight gradient  dK as a product whose inner dimension is B*L, split into
//                    slabs of position chunks, each slab writing an f32
//                    partial [3, C, C]; the input chunk is normalised and
//                    activated in shared memory. bf16: wgrad_sm90_kernel
//                    (wgmma, C >= 64) or wgrad_narrow_kernel (mma.sync, a
//                    3C x C tile for C <= 32) from wgrad_sm90.cuh, with the
//                    slabs of wgrad_plan() in ops/kernels/resnet.py, a single
//                    slab writing dK itself. f32: conv3_wgrad_kernel, one
//                    64 x 64 tile of all three taps per CTA on FMAs over
//                    32-position chunks, double-buffered;
//   wgrad_finalize   sums the slabs in order and rounds once (one thread per
//                    element, or over many slabs 4 or 32 warps per 32
//                    elements);
//   data gradient    dn: bf16 conv3_sm90_kernel<kDataGrad> (conv3_sm90.cuh),
//                    the forward's wgmma conv with the taps flipped and a
//                    K-major B, split-K and tile from conv_plan(); f32
//                    conv3_kernel<kDataGrad> (resnet_common.cuh);
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
#include "wgrad_sm90.cuh"

namespace {

constexpr int RED_THREADS = 256;
// The f32 weight gradient's tile: input channels (rows of dK) and output
// channels (cols of dK) per CTA, positions per chunk of the inner dimension.
constexpr int WG_TM = 64;
constexpr int WG_TN = 64;
constexpr int WG_BL = 32;

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
// f32 only (the bf16 weight gradient is wgrad_sm90.cuh's), on FMAs.
// grid (ceil(C / WG_TM) * ceil(C / WG_TN), n_slabs), THREADS threads.
__global__ void __launch_bounds__(THREADS)
conv3_wgrad_kernel(const float* __restrict__ u, const float2* __restrict__ stats,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ dv, float* __restrict__ partial, int L, int C, int G,
                   int chunks_per_row, int total_chunks, int chunks_per_slab) {
  using T = float;
  constexpr int LDA = WG_TM + 16;  // pitch of the input chunk [WG_BL + 2, WG_TM]
  constexpr int LDD = WG_TN + 8;   // pitch of the gradient chunk [WG_BL, WG_TN]
  constexpr int VEC = 16 / sizeof(T);
  constexpr int A_ELEMS = (WG_BL + 2) * LDA;
  constexpr int D_ELEMS = WG_BL * LDD;
  constexpr int A_VECS = (WG_BL + 2) * WG_TM / VEC;
  constexpr int D_VECS = WG_BL * WG_TN / VEC;
  // Two stages of [input chunk | gradient chunk].
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

  // Thread (tr, tc) owns rows tr*8.., cols tc*4.. of every tap.
  const int tr = tid / 16, tcol = tid % 16;
  float acc[3][8][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;

  // Each thread normalises one channel of the input chunk (THREADS is a
  // multiple of WG_TM); its scale and bias do not change between chunks.
  const int nm = tid % WG_TM, nc = m0 + nm;
  const float ng = nc < C ? gamma[nc] : 0.f;
  const float nb = nc < C ? beta[nc] : 0.f;

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
        if (l >= 0 && l < L && nc < C) v = silu(gn_affine(As[s][r * LDA + nm], ms.x, ms.y, ng, nb));
        As[s][r * LDA + nm] = v;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < WG_BL; ++k) {
      float dvv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dvv[j] = Ds[s][k * LDD + tcol * 4 + j];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[s][(k + t) * LDA + tr * 8 + i];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[t][i][j] = fmaf(av[i], dvv[j], acc[t][i][j]);
      }
    }
    __syncthreads();  // buffer s is refilled by the next iteration's stage()
  }

  float* pz = partial + (size_t)slab * 3 * C * C;
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

// dk[i] = the slabs' partials summed in a fixed order, rounded once.
// SW = 1: one thread per element, slabs in order. SW > 1 (for many slabs of
// few elements: level 0's 3 x 8 x 8 from 512): a block of SW warps takes 32
// consecutive elements, one per lane, so that every load is coalesced; warp
// w sums slabs w, w + SW, .. in order, and lane i of warp 0 sums the SW
// warps' sums in order. finalize_groups() picks SW from the shape alone.
template <typename T, int SW>
__global__ void __launch_bounds__(SW == 1 ? 256 : 32 * SW)
wgrad_finalize_kernel(const float* __restrict__ partial, T* __restrict__ dk, int n_slabs,
                      size_t n) {
  if constexpr (SW == 1) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
      float s = 0.f;
      for (int z = 0; z < n_slabs; ++z) s += partial[(size_t)z * n + i];
      dk[i] = from_f32<T>(s);
    }
  } else {
    __shared__ float part[SW][33];
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    for (size_t i0 = (size_t)blockIdx.x * 32; i0 < n; i0 += (size_t)gridDim.x * 32) {
      const size_t i = i0 + lane;
      float s = 0.f;
      if (i < n) {
#pragma unroll 4
        for (int z = w; z < n_slabs; z += SW) s += partial[(size_t)z * n + i];
      }
      part[w][lane] = s;
      __syncthreads();
      if (w == 0 && i < n) {
        float t = 0.f;
#pragma unroll
        for (int g = 0; g < SW; ++g) t += part[g][lane];
        dk[i] = from_f32<T>(t);
      }
      __syncthreads();
    }
  }
}

int elementwise_blocks(size_t total) {
  const size_t want = (total + 255) / 256;
  return want < 132 * 16 ? (int)want : 132 * 16;
}

// Slab groups of wgrad_finalize: as many as keep n * SW threads within about
// one wave of the card (2048 threads on each of 132 SMs), and at most half
// the slabs.
int finalize_groups(size_t n, int n_slabs) {
  const size_t wave = (size_t)132 * 2048;
  if (n * 32 <= wave && n_slabs >= 64) return 32;
  if (n * 4 <= wave && n_slabs >= 8) return 4;
  return 1;
}

#define LAUNCH_CHECK()                                  \
  do {                                                  \
    const int e_ = (int)cudaGetLastError();             \
    if (e_) return e_;                                  \
  } while (0)

struct Shape {
  int B, L, C, G, rows_per_tile;
  int wtile, wchunk, chunks_per_slab, n_slabs;  // the weight gradient's plan
  int dbn, dmt, dbk, dsplits, dcps;           // the bf16 data gradient's plan
  float eps;
};

struct Scratch {
  float* red_partial;  // [B, n_tiles, C, 3]
  float* col;          // [B, C, 3]
  float2* means;       // [B, G]
  float* wpartial;     // [n_slabs, 3, C, C] (none for one bf16 slab)
  float* dgrad_ws;     // [dsplits, B, L, C] (bf16 with split-K only)
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
  const size_t n = (size_t)3 * sh.C * sh.C;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    int err = (int)wgrad_sm90(sh.wtile, sh.wchunk, u, stats, gamma, beta, dv, sc.wpartial, dk,
                              sh.B, sh.L, sh.C, sh.G, sh.chunks_per_slab, sh.n_slabs, stream);
    if (err) return err;
    const int groups = finalize_groups(n, sh.n_slabs);
    const int blocks = (int)((n + 31) / 32 < 132 * 16 ? (n + 31) / 32 : 132 * 16);
    if (sh.n_slabs > 1 && groups == 32)
      wgrad_finalize_kernel<T, 32><<<blocks, 32 * 32, 0, stream>>>(sc.wpartial, dk, sh.n_slabs,
                                                                    n);
    else if (sh.n_slabs > 1 && groups == 4)
      wgrad_finalize_kernel<T, 4><<<blocks, 32 * 4, 0, stream>>>(sc.wpartial, dk, sh.n_slabs, n);
    else if (sh.n_slabs > 1)
      wgrad_finalize_kernel<T, 1><<<elementwise_blocks(n), 256, 0, stream>>>(sc.wpartial, dk,
                                                                           sh.n_slabs, n);
    LAUNCH_CHECK();
    return (int)conv3_sm90<kDataGrad>(sh.dbn, sh.dmt, sh.dbk, dv, stats, gamma, beta, k, nullptr,
                                      u, dn_out, sc.dgrad_ws, sh.B, sh.L, sh.C, sh.G, sh.dsplits,
                                      sh.dcps, stream);
  } else {
    const int chunks_per_row = (sh.L + WG_BL - 1) / WG_BL;
    const int tiles = ((sh.C + WG_TM - 1) / WG_TM) * ((sh.C + WG_TN - 1) / WG_TN);
    conv3_wgrad_kernel<<<dim3(tiles, sh.n_slabs), THREADS, 0, stream>>>(
        u, stats, gamma, beta, dv, sc.wpartial, sh.L, sh.C, sh.G, chunks_per_row,
        sh.B * chunks_per_row, sh.chunks_per_slab);
    LAUNCH_CHECK();
    wgrad_finalize_kernel<T, 1><<<elementwise_blocks(n), 256, 0, stream>>>(sc.wpartial, dk,
                                                                         sh.n_slabs, n);
    LAUNCH_CHECK();
    const dim3 grid((sh.L + BM - 1) / BM, (sh.C + BN - 1) / BN, sh.B);
    conv3_kernel<T, kDataGrad, float><<<grid, THREADS, 0, stream>>>(dv, stats, gamma, beta, k,
                                                                    nullptr, u, dn_out, sh.L,
                                                                    sh.C, sh.G);
    LAUNCH_CHECK();
    return 0;
  }
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
// scratch: dy, dh [B, L, C]; one f32 buffer holding, at the given offsets
//      (in floats, each a multiple of 4): dn [B, L, C]; red_partial
//      [B, ceil(L / rows_per_tile), C, 3]; col [B, C, 3]; means [B, G, 2];
//      wpartial [wslabs, 3, C, C] (f32 always; bf16 when wslabs > 1);
//      dgrad_ws [dsplits, B, L, C] (bf16 when dsplits > 1);
// plans: the weight gradient's (wtile, wchunk positions a chunk, chunks per
//      slab, slabs: wgrad_plan(); the f32 tile is 0 with 32-position chunks)
//      and the bf16 data gradient's (conv_plan()'s bn, mt, bk, splits, cps;
//      ignored for f32).
// Without modulation the modulation pointers and dy are not touched. Returns
// the first CUDA error code seen after a launch, 0 on success.
extern "C" int resnet_item_backward(
    int dtype, const void* g, const void* x, const void* h, const void* y, const void* stats,
    const void* gn1s, const void* gn1b, const void* k1, const void* gn2s, const void* gn2b,
    const void* k2, const void* mods, const void* mgs, const void* mgb, void* dx, void* dgn1s,
    void* dgn1b, void* dk1, void* dc1b, void* dgn2s, void* dgn2b, void* dk2, void* dc2b,
    void* dmods, void* dmodb, void* dmgs, void* dmgb, void* dy, void* dh, void* scratch,
    long long dn_off, long long red_off, long long col_off, long long means_off,
    long long wpartial_off, long long dgrad_ws_off, int B, int L, int C, int G,
    int rows_per_tile, int wtile, int wchunk, int chunks_per_slab, int n_slabs, int dbn,
    int dmt, int dbk, int dsplits, int dcps, float eps, int use_modulation, void* stream) {
  const Shape sh{B, L, C, G, rows_per_tile, wtile, wchunk, chunks_per_slab, n_slabs,
                 dbn, dmt, dbk, dsplits, dcps, eps};
  float* f = static_cast<float*>(scratch);
  const Scratch sc{f + red_off, f + col_off, reinterpret_cast<float2*>(f + means_off),
                   f + wpartial_off, f + dgrad_ws_off};
  float* dn = f + dn_off;
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<const float2*>(stats);
  if (dtype == 0) {
    using T = float;
    const ItemBackwardArgs<T> a{
        (const T*)g, (const T*)x, (const T*)h, (const T*)y, (const T*)gn1s, (const T*)gn1b,
        (const T*)k1, (const T*)gn2s, (const T*)gn2b, (const T*)k2, (const T*)mods,
        (const T*)mgs, (const T*)mgb, (T*)dx, (T*)dgn1s, (T*)dgn1b, (T*)dk1, (T*)dc1b,
        (T*)dgn2s, (T*)dgn2b, (T*)dk2, (T*)dc2b, (T*)dmods, (T*)dmodb, (T*)dmgs, (T*)dmgb,
        (T*)dy, (T*)dh, dn};
    return item_backward<T>(a, st, sh, sc, use_modulation, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const ItemBackwardArgs<T> a{
        (const T*)g, (const T*)x, (const T*)h, (const T*)y, (const T*)gn1s, (const T*)gn1b,
        (const T*)k1, (const T*)gn2s, (const T*)gn2b, (const T*)k2, (const T*)mods,
        (const T*)mgs, (const T*)mgb, (T*)dx, (T*)dgn1s, (T*)dgn1b, (T*)dk1, (T*)dc1b,
        (T*)dgn2s, (T*)dgn2b, (T*)dk2, (T*)dc2b, (T*)dmods, (T*)dmodb, (T*)dmgs, (T*)dmgb,
        (T*)dy, (T*)dh, dn};
    return item_backward<T>(a, st, sh, sc, use_modulation, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The occupancy of the bf16 backward's two convolutions without a launch:
// the dynamic shared memory and resident CTAs per SM of the data gradient's
// tile (bn x 64*mt rows, K chunks of bk, cps chunks per split; conv_plan())
// and of the weight gradient's tile (tile, chunk, cps chunks per slab;
// wgrad_plan()). Each returns a CUDA error code, 0 on success.
extern "C" int resnet_dgrad_occupancy(int bn, int mt, int bk, int cps, int* smem,
                                      int* blocks_per_sm) {
  return (int)conv3_sm90<kDataGrad>(bn, mt, bk, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 1, 1, cps,
                                    nullptr, smem, blocks_per_sm);
}

extern "C" int resnet_wgrad_occupancy(int tile, int chunk, int cps, int* smem,
                                      int* blocks_per_sm) {
  return (int)wgrad_sm90(tile, chunk, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, 0, 0, 0, 1, cps, 1, nullptr, smem, blocks_per_sm);
}
