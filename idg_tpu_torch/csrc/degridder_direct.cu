// K9a, the direct degridder: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P], FP32 on the CUDA cores, exact at any w.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_degridder_direct (body
// _kernel_direct), registered as degridder pallas_v1 and, with the channel
// recurrence (kRecur), pallas_v2. It computes the adjoint of K8a
// (degridder_reference.cu:39-115):
//   pix'[y,x,p] = A1 · (sph·P) · A2ᴴ                                  (prologue)
//   vis[t,c,p]  = Σ_{y,x} pix'[y,x,p] · e^{i(pi[t,y,x]·k_c − po[y,x])}
// with pi = u·l + v·m + w·n and po = po_x + po_y + w_off·n, JAX's phase.
//
// What bounds it on an H100: FP32 arithmetic, as in K8a: one accurate
// sincosf and four complex multiply-adds per pixel and visibility, or with
// kRecur one complex multiply in place of the sincosf.
//
// Design: one block per subgrid, 256 threads. The prologue writes the
// prepared pixels (P·N²·8 B = 32 KB at N = 32) and each pixel's (n, po)
// into shared memory. Each thread then owns one timestep and a group of
// kChanGroup channels: it sums over the N² pixels, which every thread of a
// warp reads at the same time (broadcasts), with kChanGroup × 4 complex
// accumulators in registers and pi computed once per pixel for the group.
// So no reduction crosses threads. With kRecur the group's first phasor and
// the step e^{i·pi·Δk}, Δk = k[1] − k[0], take two sincosf per pixel, and
// the phasor advances by one complex multiply per channel: the recurrence
// restarts exactly at each group's first channel (JAX's starts once, at
// channel 0). One thread owning all 16 channels would need 128 accumulator
// registers; a group of 8 keeps it near 100.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChanGroup = 8;  // ops/cuda/degridder_direct.py CHANNEL_GROUP

template <int N>
constexpr size_t smem_bytes() {
  return (size_t)N * N * idg::kPols * sizeof(float2)  // prepared pixels
         + (size_t)N * N * sizeof(float2)             // (n, po) per pixel
         + (size_t)2 * N * sizeof(float);             // l, m
}

template <int N, bool kRecur>
__global__ void __launch_bounds__(kThreads) degridder_direct_kernel(
    const float* __restrict__ uvw,          // [S, T, 3]
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
    const float2* __restrict__ subgrids,    // [S, P, N, N]
    float2* __restrict__ out,               // [S, T, C, P]
    int T, int C, int nr_stations) {
  using namespace idg;
  extern __shared__ float4 smem[];
  float4* s_pix = smem;                                           // [N·N][2] (4 pols)
  float2* s_geo = reinterpret_cast<float2*>(smem + 2 * N * N);   // [N·N] (n, po)
  float* s_l = reinterpret_cast<float*>(s_geo + N * N);          // [N]
  float* s_m = s_l + N;                                           // [N]

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = (size_t)N * N;
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;

  // prologue: taper, then A1 · P · A2ᴴ
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  const float woff = w_off[s];
  for (int q = tid; q < N * N; q += kThreads) {
    const float taper = sph[q];
    float2 p[kPols];
#pragma unroll
    for (int i = 0; i < kPols; ++i) {
      const float2 v = sub_s[i * nn + q];
      p[i] = make_float2(v.x * taper, v.y * taper);
    }
    float2 o[kPols];
    jones_degridder(aterms + (at1 + q) * kPols, aterms + (at2 + q) * kPols, p, o);
    s_pix[2 * q + 0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
    s_pix[2 * q + 1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
    const float nq = n[q];
    s_geo[q] = make_float2(nq, po_x[(size_t)s * N + q % N] + po_y[(size_t)s * N + q / N] +
                                   woff * nq);
  }
  for (int e = tid; e < N; e += kThreads) {
    s_l[e] = l[e];
    s_m[e] = m[e];
  }
  __syncthreads();

  const float* uvw_s = uvw + (size_t)s * T * 3;
  const int groups = (C + kChanGroup - 1) / kChanGroup;
  const float dk = C > 1 ? k[1] - k[0] : 0.0f;
  // no barrier inside this loop: the shared data is read-only from here on
  for (int item = tid; item < T * groups; item += kThreads) {
    const int t = item / groups, c0 = (item % groups) * kChanGroup;
    const int nc = min(kChanGroup, C - c0);
    const float u = uvw_s[t * 3 + 0], v = uvw_s[t * 3 + 1], w = uvw_s[t * 3 + 2];
    float kc[kChanGroup];
    float2 acc[kChanGroup][kPols];
#pragma unroll
    for (int j = 0; j < kChanGroup; ++j) {
      kc[j] = k[min(c0 + j, C - 1)];
#pragma unroll
      for (int p = 0; p < kPols; ++p) acc[j][p] = make_float2(0.0f, 0.0f);
    }
    for (int y = 0; y < N; ++y) {
      const float vm = v * s_m[y];
#pragma unroll 2
      for (int x = 0; x < N; ++x) {
        const int q = y * N + x;
        const float2 geo = s_geo[q];
        const float pi = u * s_l[x] + vm + w * geo.x;
        const float4 pa = s_pix[2 * q + 0], pb = s_pix[2 * q + 1];
        const float2 px[kPols] = {make_float2(pa.x, pa.y), make_float2(pa.z, pa.w),
                                  make_float2(pb.x, pb.y), make_float2(pb.z, pb.w)};
        if constexpr (kRecur) {
          float sn, cs;
          sincosf(pi * kc[0] - geo.y, &sn, &cs);
          float2 ph = make_float2(cs, sn);
          sincosf(pi * dk, &sn, &cs);
          const float2 d = make_float2(cs, sn);
#pragma unroll
          for (int j = 0; j < kChanGroup; ++j) {
            if (j < nc) {
#pragma unroll
              for (int p = 0; p < kPols; ++p) cmac(acc[j][p], px[p], ph);
              ph = cmul(ph, d);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kChanGroup; ++j) {
            if (j < nc) {
              float sn, cs;
              sincosf(pi * kc[j] - geo.y, &sn, &cs);
              const float2 ph = make_float2(cs, sn);
#pragma unroll
              for (int p = 0; p < kPols; ++p) cmac(acc[j][p], px[p], ph);
            }
          }
        }
      }
    }
    float4* o = reinterpret_cast<float4*>(out + (((size_t)s * T + t) * C + c0) * kPols);
#pragma unroll
    for (int j = 0; j < kChanGroup; ++j) {
      if (j < nc) {
        o[2 * j + 0] = make_float4(acc[j][0].x, acc[j][0].y, acc[j][1].x, acc[j][1].y);
        o[2 * j + 1] = make_float4(acc[j][2].x, acc[j][2].y, acc[j][3].x, acc[j][3].y);
      }
    }
  }
}

template <int N, bool kRecur>
cudaError_t launch(const float* uvw, const float* k, const float* w_off, const float* po_x,
                   const float* po_y, const float* l, const float* m, const float* n,
                   const float* sph, const float2* aterms, const int* aterm_index,
                   const int* station1, const int* station2, const float2* subgrids,
                   float2* out, int S, int T, int C, int nr_stations, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<N>();
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(degridder_direct_kernel<N, kRecur>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_direct_kernel<N, kRecur><<<S, kThreads, bytes, stream>>>(
      uvw, k, w_off, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations);
  return cudaGetLastError();
}

}  // namespace

// recurrence = 0: full phase per (t, c, pixel) (cuda_v1); 1: channel recurrence (cuda_v2)
extern "C" int idg_degridder_direct(
    const void* uvw, const void* k, const void* w_off, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* subgrids, void* out, int S, int T, int C, int N, int nr_stations,
    int recurrence, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float*)k, (const float*)w_off, (const float*)po_x,         \
      (const float*)po_y, (const float*)l, (const float*)m, (const float*)n,           \
      (const float*)sph, (const float2*)aterms, (const int*)aterm_index,               \
      (const int*)station1, (const int*)station2, (const float2*)subgrids,             \
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
