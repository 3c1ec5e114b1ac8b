// K9a, the direct degridder: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P], exact at any w, its complex MAC on the TF32 tensor cores.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_degridder_direct (degridder.py:127,
// body _kernel_direct :71), registered as degridder pallas_v1 and, with the
// channel recurrence (kRecur), pallas_v2. It computes the adjoint of K8a
// (degridder_reference.cu:39-115):
//   pix'[y,x,p] = A1 · (sph·P) · A2ᴴ                                  (prologue)
//   vis[t,c,p]  = Σ_{y,x} pix'[y,x,p] · e^{i(pi[t,y,x]·k_c − po[y,x])}
// with pi = u·l + v·m + w·n and po = po_x + po_y + w_off·n, JAX's phase.
// kRecur steps the phasor over a group of kChanGroup channels by one complex
// multiply with e^{i·pi·Δk}, Δk = k[1] − k[0], from an exact phasor at the
// group's first channel (JAX's pallas_v2 starts once, at channel 0).
//
// The sum is a skinny product per channel, vis[t, (p, re|im)] =
// Φ[t, (pixel, re|im)] · X[(pixel, re|im), (p, re|im)], M = T, K = 2N²,
// N = 8, with X the prepared pixels laid out per pixel as
// [[x_re, x_im], [−x_im, x_re]] over the four pols. Φ (T·C × N² phasors a
// subgrid) is formed where the tensor cores read it, in registers.
//
// What bounds it on an H100, per (visibility, pixel) pair (5.14·10¹⁰ in the
// default problem): in the FFMA design the FP32 CUDA cores (16 FFMA of MAC,
// and in cuda_v1 ~30 instructions of accurate sincosf a pair). Here the MAC
// is three TF32 passes on the tensor cores (10 ms at the 495 TFLOP/s of
// wgmma; mma.sync reaches less); the CUDA cores form Φ and split it:
// cuda_v2 one complex multiply and the split of two values a pair, and two
// exact phasors a (t, pixel) and channel group, cuda_v1 one exact phasor a
// pair, two MUFU on the SFU (a 24.6 ms floor) after the 2π reduction
// (common.cuh:expi_reduced; the gridder's coherent sums need its unit-circle
// step, these do not). Diagnostic copies (scripts/time_direct.py --drop)
// took ~29 ms (v2) without the products and ~22 without the phasors,
// against ~41 in full (PERF.md).
//
// Design: one block per subgrid, 8 warps. The prologue writes the prepared
// pixels and each pixel's (l, m, n, po) into shared memory (48 KB at
// N = 32). A warp's work item is 16 timesteps (rows g and g+8 of mma.sync
// m16n8k8, g = lane / 4) × one group of kChanGroup channels, each channel
// its own accumulator, so the recurrence runs inside a thread. K walks the
// pixels, 4 a k step (t = lane % 4): the thread forms the phasors of its two
// timesteps at its pixel for the 8 channels and splits them into TF32 hi/lo
// in the A registers (wgmma.cuh:split_unit_tf32); the pixel's B fragment
// (two values, read from shared memory and split) serves all 8 channels.
// The tensor cores' float32 accumulation truncates, so every 16 pixels'
// products start fresh and fold into round-to-nearest running sums in
// registers. The phases are formed in the plain version's operation order
// (common.cuh:phase_index).

#include <cuda_runtime.h>

#include "common.cuh"
#include "wgmma.cuh"

// Diagnostic copies only (scripts/time_direct.py --drop): 1 drops the
// products, 2 the phasors (each k step takes its pixel's first); the results
// are wrong.
#ifndef IDG_DIRECT_DROP
#define IDG_DIRECT_DROP 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChanGroup = 8;  // ops/cuda/degridder_direct.py CHANNEL_GROUP
constexpr int kFoldSteps = 4;  // k steps (4 pixels each) of products before a fold
constexpr bool kProducts = IDG_DIRECT_DROP != 1;
constexpr bool kPhasors = IDG_DIRECT_DROP != 2;

template <int N>
constexpr size_t smem_bytes() {
  return (size_t)N * N * idg::kPols * sizeof(float2)  // prepared pixels [N·N][P]
         + (size_t)N * N * sizeof(float4);            // (l, m, n, po) per pixel
}

template <int N, bool kRecur>
__global__ void __launch_bounds__(kThreads, 2) degridder_direct_kernel(
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
  float2* s_pix = reinterpret_cast<float2*>(smem);           // [N·N][P]
  float4* s_geo = smem + N * N * kPols / 2;                   // [N·N] (l, m, n, po)

  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t sink = 0;
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
#pragma unroll
    for (int i = 0; i < kPols; ++i) s_pix[q * kPols + i] = o[i];
    const float nq = n[q];
    s_geo[q] = make_float4(l[q % N], m[q / N], nq,
                           phase_offset(po_x[(size_t)s * N + q % N],
                                        po_y[(size_t)s * N + q / N], woff, nq));
  }
  __syncthreads();

  const float* uvw_s = uvw + (size_t)s * T * 3;
  const int groups = (C + kChanGroup - 1) / kChanGroup;
  const int items = (T + 15) / 16 * groups;
  const float dk = C > 1 ? k[1] - k[0] : 0.0f;
  // lane (g, t) reads B[(pixel, re), (p, ri)] and B[(pixel, im), (p, ri)],
  // p = g / 2, ri = g % 2: (x_re, −x_im) or (x_im, x_re)
  const int pol = g >> 1;
  const bool ri = g & 1;
  // no barrier inside this loop: the shared data is read-only from here on
  for (int item = warp; item < items; item += kWarps) {
    const int ta = (item / groups) * 16 + g, tb = ta + 8;
    const int c0 = (item % groups) * kChanGroup;
    const int nc = min(kChanGroup, C - c0);
    float ua = 0.0f, va = 0.0f, wa = 0.0f, ub = 0.0f, vb = 0.0f, wb = 0.0f;
    if (ta < T) ua = uvw_s[3 * ta], va = uvw_s[3 * ta + 1], wa = uvw_s[3 * ta + 2];
    if (tb < T) ub = uvw_s[3 * tb], vb = uvw_s[3 * tb + 1], wb = uvw_s[3 * tb + 2];
    float kc[kChanGroup];
    float sum[kChanGroup][4];
#pragma unroll
    for (int j = 0; j < kChanGroup; ++j) {
      kc[j] = k[min(c0 + j, C - 1)];
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[j][e] = 0.0f;
    }
    for (int q0 = 0; q0 < N * N; q0 += 4 * kFoldSteps) {
      float acc[kChanGroup][4] = {};
#pragma unroll 1
      for (int q = q0 + t4; q < q0 + 4 * kFoldSteps; q += 4) {
        const float4 geo = s_geo[q];
        const float2 x = s_pix[q * kPols + pol];
        float4 b;
        split_tf32_raw(ri ? x.y : x.x, b.x, b.z);
        split_tf32_raw(ri ? x.x : -x.y, b.y, b.w);
        const float pia = phase_index(ua, va, wa, geo.x, geo.y, geo.z);
        const float pib = phase_index(ub, vb, wb, geo.x, geo.y, geo.z);
        float2 pha{}, phb{}, da{}, db{};
        if constexpr (kRecur || !kPhasors) {
          pha = expi_reduced(__fmaf_rn(pia, kc[0], -geo.w));
          phb = expi_reduced(__fmaf_rn(pib, kc[0], -geo.w));
        }
        if constexpr (kRecur && kPhasors) {
          da = expi_reduced(pia * dk);
          db = expi_reduced(pib * dk);
        }
#pragma unroll
        for (int j = 0; j < kChanGroup; ++j) {
          if constexpr (!kRecur && kPhasors) {
            pha = expi_reduced(__fmaf_rn(pia, kc[j], -geo.w));
            phb = expi_reduced(__fmaf_rn(pib, kc[j], -geo.w));
          }
          float a_hi[4], a_lo[4];
          split_phasors(pha, phb, a_hi, a_lo);
          if constexpr (kProducts) {
            mma3_tf32_16x8(acc[j], a_hi, a_lo, b);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) sink ^= __float_as_uint(a_hi[e]) ^ __float_as_uint(a_lo[e]);
            sink ^= __float_as_uint(b.x) ^ __float_as_uint(b.w);
          }
          if constexpr (kRecur && kPhasors) {
            pha = cmul(pha, da);
            phb = cmul(phb, db);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChanGroup; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[j][e] += acc[j][e];
    }
    if constexpr (!kProducts) sum[0][0] += __uint_as_float(sink & 0x007fffffu);
    // sum[j] = {re, im of pol t4 at timestep ta, the same at tb}, channel c0 + j
#pragma unroll
    for (int j = 0; j < kChanGroup; ++j) {
      if (j < nc) {
        if (ta < T) out[(((size_t)s * T + ta) * C + c0 + j) * kPols + t4] = make_float2(sum[j][0], sum[j][1]);
        if (tb < T) out[(((size_t)s * T + tb) * C + c0 + j) * kPols + t4] = make_float2(sum[j][2], sum[j][3]);
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
