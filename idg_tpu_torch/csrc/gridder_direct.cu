// K8a, the direct gridder: visibilities -> subgrids c64[S, P, N, N], FP32 on
// the CUDA cores, exact at any w (no Taylor of the w term).
//
// Replaces idg_tpu/ops/pallas/gridder.py:_gridder_direct (body
// _kernel_direct), registered as gridder pallas_v1 and, with the channel
// recurrence (kRecur), pallas_v2. It computes the reference kernel's math
// (gridder_reference.cu:40-107):
//   pi[t,y,x]    = u_t·l_x + v_t·m_y + w_t·n_yx
//   po[y,x]      = po_x[x] + po_y[y] + w_off·n_yx
//   pixel[y,x,p] = Σ_{t,c} vis[t,c,p] · e^{i(po[y,x] − pi[t,y,x]·k_c)}
// then the Jones correction A1ᴴ·P·A2 and the spheroidal taper. The phase is
// JAX's, term for term: w_off·n rides in po (the separable kernels carry it
// in μ instead).
//
// What bounds it on an H100: FP32 arithmetic. Per pixel and visibility the
// full-phase form does one accurate sincosf (~20-30 instructions at these
// arguments) and four complex multiply-adds (16 FMAs); kRecur replaces the
// sincosf by one complex multiply per channel, stepping by e^{−i·pi·Δk},
// Δk = k[1] − k[0] (one sincosf per (t, pixel)), and restarts from an exact
// phasor every kChanGroup channels, as K9a does: JAX's pallas_v2 never
// restarts and drifts past the 1e-5 gate at C = 256. The restarts cost one
// sincosf per (t, pixel) and group. The recurrence assumes uniform channel
// spacing (the API guard falls back to the full-phase form otherwise).
//
// Design: one block per subgrid, 256 threads, each owning N²/256 pixels with
// their four complex pol accumulators in registers. The block stages the
// visibilities and uvw of a tile of timesteps in shared memory (coalesced
// loads), and every thread reads them as warp-wide broadcasts. No fast math:
// the phases reach ~50 rad. The TPU kernel's time tiling served its MXU
// contraction and its 64 MB VMEM limit; neither has a counterpart here.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kTileBytes = 32 * 1024;  // shared visibilities per tile of timesteps
constexpr int kChanGroup = 8;  // exact restarts of the recurrence (ops/cuda/gridder_direct.py)

template <int N, bool kRecur>
__global__ void __launch_bounds__(kThreads) gridder_direct_kernel(
    const float* __restrict__ uvw,          // [S, T, 3]
    const float2* __restrict__ vis,         // [S, T, C, P]
    const float* __restrict__ k,            // [C]
    const float* __restrict__ w_off,        // [S]
    const float* __restrict__ po_x,         // [S, N]
    const float* __restrict__ po_y,         // [S, N]
    const float* __restrict__ l,            // [N]
    const float* __restrict__ m,            // [N]
    const float* __restrict__ n,            // [N, N]
    const float* __restrict__ sph,          // [N, N]
    const float2* __restrict__ aterms,      // [ts, stations, N, N, P]
    const int* __restrict__ aterm_index,    // [S]
    const int* __restrict__ station1,       // [S]
    const int* __restrict__ station2,       // [S]
    float2* __restrict__ out,               // [S, P, N, N]
    int T, int C, int nr_stations, int tile_t) {
  using namespace idg;
  static_assert((N * N) % kThreads == 0, "pixels must split evenly");
  constexpr int kPix = N * N / kThreads;

  extern __shared__ float4 smem[];
  float2* s_vis = reinterpret_cast<float2*>(smem);             // [tile_t][C][P]
  float* s_k = reinterpret_cast<float*>(s_vis + (size_t)tile_t * C * kPols);  // [C]
  float* s_uvw = s_k + C;                                      // [tile_t][3]

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * T * C * kPols;
  for (int c = tid; c < C; c += kThreads) s_k[c] = k[c];
  const float dk = C > 1 ? k[1] - k[0] : 0.0f;

  // pixel q = tid + i·kThreads → (y, x) = (q / N, q % N)
  float l_p[kPix], m_p[kPix], n_p[kPix], po_p[kPix];
  float2 acc[kPix][kPols];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int q = tid + i * kThreads, y = q / N, x = q % N;
    l_p[i] = l[x];
    m_p[i] = m[y];
    n_p[i] = n[q];
    po_p[i] = po_x[(size_t)s * N + x] + po_y[(size_t)s * N + y] + w_off[s] * n_p[i];
#pragma unroll
    for (int p = 0; p < kPols; ++p) acc[i][p] = make_float2(0.0f, 0.0f);
  }

  for (int t0 = 0; t0 < T; t0 += tile_t) {
    const int nt = min(tile_t, T - t0);
    for (int e = tid; e < nt * C * kPols; e += kThreads) {
      s_vis[e] = vis_s[(size_t)t0 * C * kPols + e];
    }
    for (int e = tid; e < nt * 3; e += kThreads) s_uvw[e] = uvw_s[t0 * 3 + e];
    __syncthreads();

    for (int j = 0; j < nt; ++j) {
      const float u = s_uvw[3 * j], v = s_uvw[3 * j + 1], w = s_uvw[3 * j + 2];
      float pi[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) pi[i] = u * l_p[i] + v * m_p[i] + w * n_p[i];
      const float4* vis_j = reinterpret_cast<const float4*>(s_vis + (size_t)j * C * kPols);
      if constexpr (kRecur) {
        float2 ph[kPix], d[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          float sn, cs;
          sincosf(-(pi[i] * dk), &sn, &cs);
          d[i] = make_float2(cs, sn);
        }
        for (int c0 = 0; c0 < C; c0 += kChanGroup) {
          // an exact phasor at each group's first channel: no drift
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            float sn, cs;
            sincosf(po_p[i] - pi[i] * s_k[c0], &sn, &cs);
            ph[i] = make_float2(cs, sn);
          }
          const int c1 = min(c0 + kChanGroup, C);
          for (int c = c0; c < c1; ++c) {
            const float4 va = vis_j[2 * c], vb = vis_j[2 * c + 1];
            const float2 vp[kPols] = {make_float2(va.x, va.y), make_float2(va.z, va.w),
                                      make_float2(vb.x, vb.y), make_float2(vb.z, vb.w)};
#pragma unroll
            for (int i = 0; i < kPix; ++i) {
#pragma unroll
              for (int p = 0; p < kPols; ++p) cmac(acc[i][p], vp[p], ph[i]);
              ph[i] = cmul(ph[i], d[i]);
            }
          }
        }
      } else {
        for (int c = 0; c < C; ++c) {
          const float kc = s_k[c];
          const float4 va = vis_j[2 * c], vb = vis_j[2 * c + 1];
          const float2 vp[kPols] = {make_float2(va.x, va.y), make_float2(va.z, va.w),
                                    make_float2(vb.x, vb.y), make_float2(vb.z, vb.w)};
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            float sn, cs;
            sincosf(po_p[i] - pi[i] * kc, &sn, &cs);
            const float2 ph = make_float2(cs, sn);
#pragma unroll
            for (int p = 0; p < kPols; ++p) cmac(acc[i][p], vp[p], ph);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: A1ᴴ · P · A2, then the taper
  const size_t nn = (size_t)N * N;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int q = tid + i * kThreads;
    float2 o[kPols];
    jones_gridder(aterms + (at1 + q) * kPols, aterms + (at2 + q) * kPols, acc[i], o);
    const float taper = sph[q];
#pragma unroll
    for (int p = 0; p < kPols; ++p) {
      out[((size_t)s * kPols + p) * nn + q] = make_float2(o[p].x * taper, o[p].y * taper);
    }
  }
}

template <int N, bool kRecur>
cudaError_t launch(const float* uvw, const float2* vis, const float* k, const float* w_off,
                   const float* po_x, const float* po_y, const float* l, const float* m,
                   const float* n, const float* sph, const float2* aterms,
                   const int* aterm_index, const int* station1, const int* station2,
                   float2* out, int S, int T, int C, int nr_stations, cudaStream_t stream) {
  // a tile of whole timesteps, all channels, about kTileBytes of visibilities
  const size_t per_t = (size_t)C * idg::kPols * sizeof(float2) + 3 * sizeof(float);
  size_t tile_t = kTileBytes / per_t;
  if (tile_t < 1) tile_t = 1;
  if (tile_t > (size_t)T) tile_t = T;
  const size_t bytes = tile_t * per_t + (size_t)C * sizeof(float);
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(gridder_direct_kernel<N, kRecur>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  gridder_direct_kernel<N, kRecur><<<S, kThreads, bytes, stream>>>(
      uvw, vis, k, w_off, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1,
      station2, out, T, C, nr_stations, (int)tile_t);
  return cudaGetLastError();
}

}  // namespace

// recurrence = 0: full phase per (t, c, pixel) (cuda_v1); 1: channel recurrence (cuda_v2)
extern "C" int idg_gridder_direct(
    const void* uvw, const void* vis, const void* k, const void* w_off, const void* po_x,
    const void* po_y, const void* l, const void* m, const void* n, const void* sph,
    const void* aterms, const void* aterm_index, const void* station1,
    const void* station2, void* out, int S, int T, int C, int N, int nr_stations,
    int recurrence, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float2*)vis, (const float*)k, (const float*)w_off,         \
      (const float*)po_x, (const float*)po_y, (const float*)l, (const float*)m,        \
      (const float*)n, (const float*)sph, (const float2*)aterms,                       \
      (const int*)aterm_index, (const int*)station1, (const int*)station2,             \
      (float2*)out, S, T, C, nr_stations, st
  switch (N * 2 + (recurrence ? 1 : 0)) {
    case 32: return (int)launch<16, false>(IDG_ARGS);
    case 33: return (int)launch<16, true>(IDG_ARGS);
    case 64: return (int)launch<32, false>(IDG_ARGS);
    case 65: return (int)launch<32, true>(IDG_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}
