// K8a, the direct gridder: visibilities -> subgrids c64[S, P, N, N], exact at
// any w (no Taylor of the w term), its complex MAC on the TF32 tensor cores.
//
// Replaces idg_tpu/ops/pallas/gridder.py:_gridder_direct (gridder.py:334,
// body _kernel_direct :278), registered as gridder pallas_v1 and, with the
// channel recurrence (kRecur), pallas_v2. It computes the reference kernel's
// math (gridder_reference.cu:40-107):
//   pi[t,y,x]    = u_t·l_x + v_t·m_y + w_t·n_yx
//   po[y,x]      = po_x[x] + po_y[y] + w_off·n_yx
//   pixel[y,x,p] = Σ_{t,c} vis[t,c,p] · e^{i(po[y,x] − pi[t,y,x]·k_c)}
// then the Jones correction A1ᴴ·P·A2 and the spheroidal taper. The phase is
// JAX's, term for term: w_off·n rides in po (the separable kernels carry it
// in μ instead). kRecur steps the phasor over the channels by one complex
// multiply with e^{−i·pi·Δk}, Δk the uniform fit's step
// (k[C], common.cuh), and restarts it exactly every kChanGroup
// channels (JAX's pallas_v2 never restarts, steps by k[1] − k[0] and drifts
// past the 1e-5 gate at C = 256); it assumes uniform channel spacing (the API
// guard falls back to the full-phase form otherwise).
//
// The sum is a skinny product, out[pixel, (p, re|im)] = Φ[pixel, (v, re|im)]
// · B[(v, re|im), (p, re|im)], M = N² pixels, K = 2·T·C, N = 8, with B the
// visibilities laid out per visibility as [[v_re, v_im], [−v_im, v_re]] over
// the four pols. Φ (N² × T·C phasors a subgrid, 411 TB over the default
// problem) can never be staged: it is formed where the tensor cores read it.
//
// What bounds it on an H100, per (pixel, visibility) pair (5.14·10¹⁰ of
// them in the default problem): in the FFMA design the FP32 CUDA cores (16
// FFMA of MAC a pair, and in cuda_v1 ~30 instructions of accurate sincosf).
// Here the MAC is three TF32 passes on the tensor cores (hi·hi + hi·lo +
// lo·hi, 1.64·10¹² FLOP a pass each, 10 ms at the 495 TFLOP/s of wgmma;
// mma.sync reaches less), and the CUDA cores form and split Φ: cuda_v2 one
// complex multiply and the split of two values a pair (10 FP32
// instructions, 15 ms at the FP32 rate), cuda_v1 an exact phasor a pair:
// the 2π reduction, two MUFU (16 a clock an SM: a 24.6 ms floor) and the
// step back onto the unit circle. The two sides share the issue slots and
// overlap in part: diagnostic copies (scripts/time_direct.py --drop) run
// at about two thirds of the full kernel's time without the products and
// about half without the phasors (PERF.md).
//
// Design: one block per subgrid, 8 warps, each owning N²/128 row tiles of 16
// pixels (rows g and g+8 of mma.sync m16n8k8, g = lane / 4). A k8 step is 4
// timesteps (t = lane % 4) at one channel, so each thread forms the phasors of
// its pixels and its timestep, split into TF32 hi/lo right in the A
// registers on the FP32 pipe (wgmma.cuh:split_unit_tf32), and keeps them from
// channel to channel: kRecur steps them (the step from the FMA-pipe
// polynomial, common.cuh:expi_poly, as its error compounds), the full-phase
// form evaluates them afresh. Two row tiles run together (four in the full
// phase form), independent accumulator chains. B, pre-split into hi/lo in
// each lane's fragment order (one 16-byte load a k step), is staged a block
// of timesteps and channels at a time in shared memory. The tensor cores'
// float32 accumulation truncates, so every 4 channels' products start fresh,
// hi·hi apart from the small cross terms, and fold into round-to-nearest
// running sums, one complex value per pixel and pol, in registers across
// the stages. A coherent sum adds up what is biased in each term, so the
// exact phasors are brought back onto the unit circle
// (common.cuh:expi_reduced_unit). The epilogue passes the sums through
// shared memory to one thread per pixel. The phases are formed in the
// plain version's operation order (common.cuh:phase_index), so the float32
// phase is the plain version's. wgmma m64n8k8 with A from registers, tried
// in place of mma.sync, lost (PERF.md): at N = 8 ptxas serialises it.

#include <cuda_runtime.h>

#include "common.cuh"
#include "wgmma.cuh"

// Diagnostic copies only (scripts/time_direct.py --drop): 1 drops the
// products, 2 the phasors' evaluation (each timestep group keeps its
// first); the results are wrong.
#ifndef IDG_DIRECT_DROP
#define IDG_DIRECT_DROP 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChanGroup = 8;      // exact restarts of the recurrence (ops/cuda/gridder_direct.py)
constexpr int kFold = 4;           // channels of products before a fold
constexpr int kStageChans = 64;    // channels a stage, a multiple of kChanGroup
constexpr size_t kStageBytes = 64 * 1024;             // the pre-split B of a stage
constexpr int kStepBytes = 32 * (int)sizeof(float4);  // one k step's B fragments
constexpr bool kProducts = IDG_DIRECT_DROP != 1;
constexpr bool kPhasors = IDG_DIRECT_DROP != 2;

template <int N>
__host__ __device__ constexpr size_t acc_bytes() {
  return (size_t)N * N * idg::kPols * sizeof(float2);  // the epilogue's sums
}

template <int N, bool kRecur>
__global__ void __launch_bounds__(kThreads, 2) gridder_direct_kernel(
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
    int T, int C, int nr_stations, int stage_tg, int stage_c, int b_bytes) {
  using namespace idg;
  constexpr int kTiles = N * N / 16 / kWarps;   // row tiles a warp: 8 (N = 32) or 2
  // row tiles a pass: two independent accumulator chains, four in the full
  // phase form (no phasors carried, registers to spare)
  constexpr int kGroup = (kRecur ? 2 : 4) < kTiles ? (kRecur ? 2 : 4) : kTiles;
  constexpr int kPh = 2 * kGroup;               // a thread's pixels at its timestep
  static_assert(kTiles % kGroup == 0, "row tiles run in groups");

  extern __shared__ float4 smem[];
  float4* s_b = smem;                                                   // [tg][c][lane]
  float4* s_geo = reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(smem) + b_bytes);
  float* s_uvw = reinterpret_cast<float*>(s_geo + N * N);              // [4·stage_tg][3]
  float* s_k = s_uvw + 12 * stage_tg;                                   // [C]

  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t sink = 0;   // keeps the formation alive in the copy without products
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * T * C * kPols;
  for (int c = tid; c < C; c += kThreads) s_k[c] = k[c];
  const float dk = k[C];   // the recurrence's channel step (common.cuh)
  const float woff = w_off[s];
  for (int q = tid; q < N * N; q += kThreads) {
    const int y = q / N, x = q % N;
    const float nq = n[q];
    s_geo[q] = make_float4(l[x], m[y], nq,
                           phase_offset(po_x[(size_t)s * N + x], po_y[(size_t)s * N + y], woff, nq));
  }

  // sum[i] = {re, im of pol t4 at pixel row g, the same at row g + 8} of row
  // tile warp·kTiles + i (pixels 16·(warp·kTiles + i) + 0..15)
  float sum[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[i][e] = 0.0f;

  const int groups_t = (T + 3) / 4;
  for (int tg0 = 0; tg0 < groups_t; tg0 += stage_tg) {
    const int ntg = min(stage_tg, groups_t - tg0);
    for (int ca = 0; ca < C; ca += stage_c) {
      const int nc = min(stage_c, C - ca);
      __syncthreads();   // the last stage's B is read
      // B of this stage in each lane's fragment order: lane (g, t) holds
      // B[(v, re), (p, ri)] and B[(v, im), (p, ri)] of v = (4·tg + t, c),
      // p = g / 2, ri = g % 2: (v_re, −v_im) or (v_im, v_re), split hi | lo
      for (int e = tid; e < ntg * nc * 32; e += kThreads) {
        const int ln = e & 31, j = e >> 5, tg = j / nc, c = ca + j % nc;
        const int ta = 4 * (tg0 + tg) + (ln & 3), p = (ln >> 2) >> 1;
        const bool im = (ln >> 2) & 1;
        const float2 v = ta < T ? vis_s[((size_t)ta * C + c) * kPols + p] : make_float2(0.0f, 0.0f);
        float hi0, lo0, hi1, lo1;
        split_tf32(im ? v.y : v.x, hi0, lo0);
        split_tf32(im ? v.x : -v.y, hi1, lo1);
        s_b[j * 32 + ln] = make_float4(hi0, hi1, lo0, lo1);
      }
      for (int e = tid; e < 12 * ntg; e += kThreads) {
        const int ta = 4 * tg0 + e / 3;
        s_uvw[e] = ta < T ? uvw_s[(size_t)4 * tg0 * 3 + e] : 0.0f;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kTiles; i += kGroup) {
        for (int tg = 0; tg < ntg; ++tg) {
          // pixels: rows g, g + 8 of row tiles i .. i + kGroup − 1
          float4 geo[kPh];
#pragma unroll
          for (int e = 0; e < kPh; ++e) geo[e] = s_geo[16 * (warp * kTiles + i + e / 2) + g + 8 * (e & 1)];
          const float u = s_uvw[12 * tg + 3 * t4], v = s_uvw[12 * tg + 3 * t4 + 1],
                      w = s_uvw[12 * tg + 3 * t4 + 2];
          float pi[kPh];
          float2 ph[kPh] = {}, d[kPh] = {};
#pragma unroll
          for (int e = 0; e < kPh; ++e) {
            pi[e] = phase_index(u, v, w, geo[e].x, geo[e].y, geo[e].z);
            // the step's error compounds over the group: the FMA-pipe phasor
            if constexpr (kRecur) d[e] = expi_poly(-(pi[e] * dk));
            if constexpr (!kPhasors) ph[e] = expi_reduced_unit(__fmaf_rn(-pi[e], s_k[ca], geo[e].w));
          }
          for (int c0 = 0; c0 < nc; c0 += kChanGroup) {
            if constexpr (kRecur && kPhasors) {
              // an exact phasor at each group's first channel: no drift
#pragma unroll
              for (int e = 0; e < kPh; ++e) ph[e] = expi_reduced_unit(__fmaf_rn(-pi[e], s_k[ca + c0], geo[e].w));
            }
            const int c1 = min(c0 + kChanGroup, nc);
            for (int cf = c0; cf < c1; cf += kFold) {
              // hi·hi, and apart from it the small lo·hi + hi·lo: each
              // accumulator truncates against its own magnitude
              float acc[kGroup][4] = {}, acx[kGroup][4] = {};
#pragma unroll
              for (int cc = 0; cc < kFold; ++cc) {
                const int c = cf + cc;
                if (c >= c1) break;
                if constexpr (!kRecur && kPhasors) {
                  const float kc = s_k[ca + c];
#pragma unroll
                  for (int e = 0; e < kPh; ++e) ph[e] = expi_reduced_unit(__fmaf_rn(-pi[e], kc, geo[e].w));
                }
                float a_hi[kGroup][4], a_lo[kGroup][4];
#pragma unroll
                for (int h = 0; h < kGroup; ++h) split_phasors(ph[2 * h], ph[2 * h + 1], a_hi[h], a_lo[h]);
                const float4 b = s_b[(tg * nc + c) * 32 + lane];
#pragma unroll
                for (int h = 0; h < kGroup; ++h) {
                  if constexpr (kProducts) {
                    mma_tf32_16x8(acx[h], a_lo[h], b.x, b.y);
                    mma_tf32_16x8(acx[h], a_hi[h], b.z, b.w);
                    mma_tf32_16x8(acc[h], a_hi[h], b.x, b.y);
                  } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) sink ^= __float_as_uint(a_hi[h][e]) ^ __float_as_uint(a_lo[h][e]);
                  }
                }
                if constexpr (!kProducts) sink ^= __float_as_uint(b.x) ^ __float_as_uint(b.w);
                if constexpr (kRecur && kPhasors) {
#pragma unroll
                  for (int e = 0; e < kPh; ++e) ph[e] = cmul(ph[e], d[e]);
                }
              }
#pragma unroll
              for (int h = 0; h < kGroup; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e) sum[i + h][e] += acc[h][e] + acx[h][e];
            }
          }
        }
      }
    }
  }
  if constexpr (!kProducts) sum[0][0] += __uint_as_float(sink & 0x007fffffu);

  // epilogue: the sums through shared memory to one thread per pixel, then
  // A1ᴴ · P · A2 and the taper
  __syncthreads();
  float2* s_acc = reinterpret_cast<float2*>(smem);   // [N·N][P], over the stage's B
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int q = 16 * (warp * kTiles + i) + g;
    s_acc[q * kPols + t4] = make_float2(sum[i][0], sum[i][1]);
    s_acc[(q + 8) * kPols + t4] = make_float2(sum[i][2], sum[i][3]);
  }
  __syncthreads();
  const size_t nn = (size_t)N * N;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  for (int q = tid; q < N * N; q += kThreads) {
    float2 pix[kPols], o[kPols];
#pragma unroll
    for (int p = 0; p < kPols; ++p) pix[p] = s_acc[q * kPols + p];
    jones_gridder(aterms + (at1 + q) * kPols, aterms + (at2 + q) * kPols, pix, o);
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
  // a stage: up to kStageChans channels (whole restart groups) of as many
  // groups of 4 timesteps as fit kStageBytes of B
  const int stage_c = C < kStageChans ? C : kStageChans;
  const int groups_t = (T + 3) / 4;
  int stage_tg = (int)(kStageBytes / ((size_t)stage_c * kStepBytes));
  if (stage_tg < 1) stage_tg = 1;
  if (stage_tg > groups_t) stage_tg = groups_t;
  size_t b_bytes = (size_t)stage_tg * stage_c * kStepBytes;
  if (b_bytes < acc_bytes<N>()) b_bytes = acc_bytes<N>();
  const size_t bytes = b_bytes + (size_t)N * N * sizeof(float4) +
                       (size_t)12 * stage_tg * sizeof(float) + (size_t)C * sizeof(float);
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(gridder_direct_kernel<N, kRecur>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  gridder_direct_kernel<N, kRecur><<<S, kThreads, bytes, stream>>>(
      uvw, vis, k, w_off, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1,
      station2, out, T, C, nr_stations, stage_tg, stage_c, (int)b_bytes);
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
