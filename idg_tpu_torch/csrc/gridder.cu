// Gridder: visibilities -> subgrids c64[S, P, N, N], FP32 on the CUDA cores.
//
// Replaces idg_tpu/ops/pallas/gridder.py:_kernel_sep_recur_batch (launcher
// _gridder_sep_recur_batch_run, registered as gridder pallas_v6), non-fused
// form. It computes the same separable-phasor function:
//   pixel[y,x,p] = Σ_v vis[v,p] · Φx[v,x] · Φy[v,y] · Σ_{r<w_rank} (iμ_v·n[y,x])^r / r!
//   Φx[v,x] = e^{i(po_x[x] − l[x]·u_t·k_c)},  Φy[v,y] = e^{i(po_y[y] − m[y]·v_t·k_c)}
// then the Jones correction A1ᴴ·P·A2 and the spheroidal taper.
//
// What bounds it on an H100: FP32 arithmetic. Per pixel and visibility it
// does one complex multiply for Φx·Φy, the Horner Taylor of the w term and
// four complex multiply-adds (~22 FMAs); the inputs of one subgrid
// (2048 visibilities × 32 B) are read once, so the kernel does ~1e3 FLOP per
// byte of device memory, far above the card's FP32 ridge.
//
// Design: one block per subgrid (S = 24,500 blocks fill 132 SMs many times
// over), 256 threads, each owning N²/256 pixels that share one column x.
// Visibilities are walked in tiles of kTile: the block computes the tile's
// Φx and Φy planes once into shared memory (O(V·N) sincosf per subgrid
// instead of O(V·N²)), then every thread accumulates its pixels in
// registers, reading Φy and the visibility as warp-wide broadcasts. Phases
// use accurate sincosf (no fast math). No channel recurrence: the kernel
// makes no assumption on the channel spacing. The TPU kernel's bf16 hi/lo
// split products, step batching and scratch double-buffering were answers
// to the TPU's bf16-only matrix unit and VMEM and have no counterpart here.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // visibilities staged per pass: 2·64·N·8 B of Φ

template <int N>
__global__ void __launch_bounds__(kThreads) gridder_kernel(
    const float* __restrict__ uvw,          // [S, T, 3]
    const float2* __restrict__ vis,         // [S, T, C, P]
    const float* __restrict__ mu,           // [S, T, C]
    const float* __restrict__ k,            // [C]
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
    int T, int C, int nr_stations, int w_rank) {
  using namespace idg;
  static_assert((N * N) % kThreads == 0, "pixels must split evenly");
  static_assert(kThreads % N == 0, "a thread's pixels share one column");
  constexpr int kPix = N * N / kThreads;

  __shared__ float2 s_phx[kTile][N];
  __shared__ float2 s_phy[kTile][N];
  __shared__ float2 s_vis[kTile][kPols];
  __shared__ float s_mu[kTile];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int V = T * C;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * V * kPols;
  const float* mu_s = mu + (size_t)s * V;
  const float* pox_s = po_x + (size_t)s * N;
  const float* poy_s = po_y + (size_t)s * N;

  // pixel q = tid + i·kThreads → (y, x) = (q / N, q % N); x is the same for
  // every pixel of this thread
  const int x = tid % N;
  float n_pix[kPix];
  float2 acc[kPix][kPols];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    n_pix[i] = n[tid + i * kThreads];
#pragma unroll
    for (int p = 0; p < kPols; ++p) acc[i][p] = make_float2(0.0f, 0.0f);
  }

  for (int v0 = 0; v0 < V; v0 += kTile) {
    const int nv = min(kTile, V - v0);
    for (int e = tid; e < nv * N; e += kThreads) {
      const int j = e / N, a = e % N;
      const int v = v0 + j;
      const int t = v / C, c = v % C;
      const float kc = k[c];
      const float uk = uvw_s[t * 3 + 0] * kc;
      const float vk = uvw_s[t * 3 + 1] * kc;
      float sx, cx, sy, cy;
      sincosf(pox_s[a] - l[a] * uk, &sx, &cx);
      sincosf(poy_s[a] - m[a] * vk, &sy, &cy);
      s_phx[j][a] = make_float2(cx, sx);
      s_phy[j][a] = make_float2(cy, sy);
    }
    for (int e = tid; e < nv * kPols; e += kThreads) {
      s_vis[e / kPols][e % kPols] = vis_s[(size_t)v0 * kPols + e];
    }
    for (int e = tid; e < nv; e += kThreads) s_mu[e] = mu_s[v0 + e];
    __syncthreads();

    for (int j = 0; j < nv; ++j) {
      const float2 phx = s_phx[j][x];
      const float mu_j = s_mu[j];
      float2 vp[kPols];
#pragma unroll
      for (int p = 0; p < kPols; ++p) vp[p] = s_vis[j][p];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int y = (tid + i * kThreads) / N;
        float2 ph = cmul(phx, s_phy[j][y]);
        ph = cmul(ph, taylor_expi(mu_j * n_pix[i], w_rank));
#pragma unroll
        for (int p = 0; p < kPols; ++p) cmac(acc[i][p], vp[p], ph);
      }
    }
    __syncthreads();
  }

  // epilogue: A1ᴴ · P · A2 (math.hpp:64-77), then the taper
  const size_t nn = (size_t)N * N;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int q = tid + i * kThreads;
    const float2* a = aterms + (at1 + q) * kPols;
    const float2* b = aterms + (at2 + q) * kPols;
    const float2 a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
    const float2 b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3];
    const float2 p0 = acc[i][0], p1 = acc[i][1], p2 = acc[i][2], p3 = acc[i][3];
    const float2 t0 = cadd(cmul_conj(a0, p0), cmul_conj(a2, p2));
    const float2 t1 = cadd(cmul_conj(a0, p1), cmul_conj(a2, p3));
    const float2 t2 = cadd(cmul_conj(a1, p0), cmul_conj(a3, p2));
    const float2 t3 = cadd(cmul_conj(a1, p1), cmul_conj(a3, p3));
    const float2 o[kPols] = {
        cadd(cmul(t0, b0), cmul(t1, b2)), cadd(cmul(t0, b1), cmul(t1, b3)),
        cadd(cmul(t2, b0), cmul(t3, b2)), cadd(cmul(t2, b1), cmul(t3, b3)),
    };
    const float taper = sph[q];
#pragma unroll
    for (int p = 0; p < kPols; ++p) {
      out[((size_t)s * kPols + p) * nn + q] = make_float2(o[p].x * taper, o[p].y * taper);
    }
  }
}

template <int N>
cudaError_t launch(const float* uvw, const float2* vis, const float* mu, const float* k,
                   const float* po_x, const float* po_y, const float* l, const float* m,
                   const float* n, const float* sph, const float2* aterms,
                   const int* aterm_index, const int* station1, const int* station2,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  gridder_kernel<N><<<S, kThreads, 0, stream>>>(
      uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1,
      station2, out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_gridder_v6(
    const void* uvw, const void* vis, const void* mu, const void* k, const void* po_x,
    const void* po_y, const void* l, const void* m, const void* n, const void* sph,
    const void* aterms, const void* aterm_index, const void* station1,
    const void* station2, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float2*)vis, (const float*)mu, (const float*)k,            \
      (const float*)po_x, (const float*)po_y, (const float*)l, (const float*)m,        \
      (const float*)n, (const float*)sph, (const float2*)aterms,                       \
      (const int*)aterm_index, (const int*)station1, (const int*)station2,             \
      (float2*)out, S, T, C, nr_stations, w_rank, st
  switch (N) {
    case 16: return (int)launch<16>(IDG_ARGS);
    case 32: return (int)launch<32>(IDG_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}
