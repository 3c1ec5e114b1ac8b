// K9c, degridder cuda_v5: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P], stage 1 in split bf16 on the tensor cores (mma.sync) with
// Φ by the channel recurrence; and the entry point of the three separable
// rungs (cuda_v3: degridder_sep_fp32.cu, cuda_v4: degridder_sep_bf16.cu).
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_sep_recur (launcher
// _degridder_sep_recur_one behind _chunked, degridder.py:559, registered as
// pallas_v5). The adjoint of gridder_separable.cu:
//   B[y, (p,x)] = A1 · (sph·P) · A2ᴴ                                     (prologue)
//   D_r[v, (p,x)] = Σ_y conj(Φy[v,y]) · n^r[y,x] · B[y,(p,x)]           (stage 1)
//   vis[v,p] = Σ_r conj((iμ_v)^r / r!) · Σ_x D_r[v,(p,x)] · conj(Φx[v,x]) (stage 2)
// Stage 1 is the product, packed on the contraction axis:
//   [Φy_re | Φy_im] (V × 2N) · [[B_re, B_im], [B_im, −B_re]] (2N × 2NP),
// as bf16 mma.sync m16n8k16 into float32, "3x" (hi·hi + hi·lo + lo·hi of
// round-to-nearest splits) or "default" (hi·hi) per rank as rank_precisions
// says. Stage 2 is float32 on the CUDA cores. Φ comes from the channel
// recurrence with its exact restart from k0 + c·Δk at every c % 16 == 0,
// c > 0. The output is written as [S, T, C, P] directly (the TPU kernel
// wrote [S, P, V] and transposed).
//
// What bounds it on an H100: stage 1's products, 2·V·2NP·2N FLOP per subgrid,
// rank and pass (67 MFLOP at N = 32), against ~100 KB of input per subgrid:
// compute-bound on the tensor cores, where the O(V·N) Φ planes, their bf16
// splits and stage 2's O(V·N·P) multiply-adds on the CUDA cores compete with
// the mma issue. Stage 2's reduction was measured to weigh most: with a
// warp's 32 lanes over the x of one (v, p) and five shuffle rounds per pair,
// the kernel took 91.2 ms at the default problem, with 8 lanes and three
// rounds 56.3 ms (H100 80GB HBM3, 700 W).
//
// Design: one block of 256 threads per subgrid, the rank loop outermost (a
// thread holds one tile's accumulators for any rank 1–6). At the start of a
// rank the block forms n^r ⊙ B from the subgrid (the prologue is recomputed
// per rank: it costs O(N²) against the rank's O(V·N·NP)) into shared memory,
// as bf16 hi/lo halves in column-major B-fragment order. It then walks tiles
// of kTile timesteps of one channel, t-tile outer and channel inner, so the
// recurrence's state stays in registers. Per tile: Φy (the A operand) and
// Φx into shared memory; stage 1 with warp w owning output columns
// [32w, 32w + 32) at N = 32 (warps 0–3 real parts, 4–7 imaginary) into a
// float32 D tile; stage 2 with 8 lanes over the x of each (v, p), reduced by
// three shuffles (a warp over all x of one (v, p) took five per pair); the
// rank's term is added into the output. The TPU kernel's whole-V planes and
// its [2NP, 2V] product, which the VMEM held, have no counterpart. The
// rungs cuda_v3 and cuda_v4 have kernels of their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "separable.cuh"

namespace {

using idg::kPols;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // timesteps of one channel per pass
constexpr int kPad = 8;     // bf16 row padding of the operand tiles

template <int N>
struct Smem {
  static constexpr int kNP = N * kPols;
  static constexpr int kLdA = 2 * N + kPad;   // A row: [Φy_re | Φy_im] over y
  static constexpr int kLdB = N + kPad;       // B column: y
  // D row: re then im, each [p][x] with pol stride kLdP, so that stage 2's
  // 8-lane groups of four pols and the fragment stores hit distinct banks
  static constexpr int kLdP = N + 8;
  static constexpr int kIm = kPols * kLdP;
  static constexpr int kLdD = 2 * kIm + 8;
  static constexpr size_t d = (size_t)kTile * kLdD * sizeof(float);
  static constexpr size_t phx = (size_t)kTile * N * sizeof(float2);
  static constexpr size_t coef = (size_t)kTile * sizeof(float2);
  static constexpr size_t a = (size_t)2 * kTile * kLdA * sizeof(__nv_bfloat16);
  static constexpr size_t b = (size_t)4 * kNP * kLdB * sizeof(__nv_bfloat16);
  static constexpr size_t bytes = d + phx + coef + a + b;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 2) degridder_sep_v5_kernel(
    const float* __restrict__ uvw,          // [S, T, 3]
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
    const float2* __restrict__ subgrids,    // [S, P, N, N]
    float2* __restrict__ out,               // [S, T, C, P]
    int T, int C, int nr_stations, int w_rank) {
  using namespace idg;
  using S = Smem<N>;
  constexpr int kNP = N * kPols, kLdA = S::kLdA, kLdB = S::kLdB, kLdD = S::kLdD;
  constexpr int kLdP = S::kLdP, kIm = S::kIm;
  // D's offset in a row of column c of the product ([re | im] over (p,x))
  auto dcol = [](int c) { return (c / kNP) * kIm + (c % kNP) / N * kLdP + c % N; };
  constexpr int kEnt = kTile * N / kThreads;   // Φ entries of each axis per thread
  static_assert(kTile * N % kThreads == 0 && kTile % 16 == 0 && N % 16 == 0, "tile shape");
  extern __shared__ float4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  float* s_d = reinterpret_cast<float*>(base);                                // [kTile][kLdD]
  float2* s_phx = reinterpret_cast<float2*>(base + S::d);                     // [kTile][N]
  float2* s_coef = reinterpret_cast<float2*>(base + S::d + S::phx);           // [kTile]
  char* ops = base + S::d + S::phx + S::coef;
  // Φy as A [hl][v][kLdA], n^r ⊙ B as B [hl][re|im][(p,x)][kLdB]
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(ops);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(ops + S::a);

  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t nn = (size_t)N * N;
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float* mu_s = mu + (size_t)s * T * C;
  const float* pox_s = po_x + (size_t)s * N;
  const float* poy_s = po_y + (size_t)s * N;
  float2* out_s = out + (size_t)s * T * C * kPols;
  const float dk = C > 1 ? k[1] - k[0] : 0.0f;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;

  // recurrence state of this thread's entries (tile row e / N, axis e % N)
  float2 cur_x[kEnt], step_x[kEnt], cur_y[kEnt], step_y[kEnt];

  // tensor-core tiling of the kTile × 2NP D tile: warp w owns columns
  // [w·kCols, (w+1)·kCols), the first half of the warps the real parts
  constexpr int kMT = kTile / 16, kCols = 2 * kNP / kWarps, kNT = kCols / 8;
  const bool imag_warp = warp >= kWarps / 2;
  const int colw = warp * kCols;                     // column of the D tile
  const int col0 = colw % kNP;                       // column within NP
  const int g = lane / 4, q = lane % 4;
  // stage 2: kLanes lanes per (v, p), each over every kLanes-th x
  constexpr int kLanes = 8, kPairs = 32 / kLanes;

  for (int r = 0; r < w_rank; ++r) {
    const bool three = r == 0 || w_rank > 2;   // rank_precisions(w_rank)[r]
    // prologue: n^r ⊙ A1 · (sph·P) · A2ᴴ (math.hpp:79-92) as this rank's B
    for (int px = tid; px < N * N; px += kThreads) {
      const int y = px / N, x = px % N;
      const float taper = sph[px];
      float2 p[kPols], o[kPols];
#pragma unroll
      for (int pol = 0; pol < kPols; ++pol) {
        const float2 v = sub_s[pol * nn + px];
        p[pol] = make_float2(v.x * taper, v.y * taper);
      }
      jones_degridder(aterms + (at1 + px) * kPols, aterms + (at2 + px) * kPols, p, o);
      const float np = power(n[px], r);
#pragma unroll
      for (int pol = 0; pol < kPols; ++pol) {
        const float2 v = make_float2(o[pol].x * np, o[pol].y * np);
        const int col = pol * N + x;
        split_bf16(v.x, s_b[(0 * kNP + col) * kLdB + y], s_b[(2 * kNP + col) * kLdB + y]);
        split_bf16(v.y, s_b[(1 * kNP + col) * kLdB + y], s_b[(3 * kNP + col) * kLdB + y]);
      }
    }

    for (int t0 = 0; t0 < T; t0 += kTile) {
      for (int c = 0; c < C; ++c) {
        // Φy, Φx and the conjugate Taylor coefficient of tile (t0, c)
#pragma unroll
        for (int i = 0; i < kEnt; ++i) {
          const int e = tid + i * kThreads, j = e / N, a = e % N;
          const int t = t0 + j;
          float2 phx = make_float2(0.0f, 0.0f), phy = phx;
          if (t < T) {
            phx = phasor<true>(pox_s[a], l[a], uvw_s[t * 3 + 0], k, c, dk, cur_x[i],
                                 step_x[i]);
            phy = phasor<true>(poy_s[a], m[a], uvw_s[t * 3 + 1], k, c, dk, cur_y[i],
                                 step_y[i]);
          }
          s_phx[j * N + a] = phx;
          split_bf16(phy.x, s_a[j * kLdA + a], s_a[(kTile + j) * kLdA + a]);
          split_bf16(phy.y, s_a[j * kLdA + N + a], s_a[(kTile + j) * kLdA + N + a]);
        }
        if (tid < kTile) {
          const int t = t0 + tid;
          s_coef[tid] = t < T ? taylor_coefficient<true>(mu_s[t * C + c], r)
                              : make_float2(0.0f, 0.0f);
        }
        __syncthreads();   // also orders this rank's prologue before its first product

        // stage 1: D = conj(Φy) · (n^r ⊙ B) over y
        float acc[kMT][kNT][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < 2 * N; k0 += 16) {
          // K rows [0, N) meet Φy_re, [N, 2N) Φy_im; real columns take
          // [B_re; B_im], imaginary columns [B_im; −B_re]
          const int half = k0 / N, y0 = k0 % N;
          const int src = imag_warp ? 1 - half : half;
          const uint32_t neg = (imag_warp && half == 1) ? kNegPair : 0u;
          uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const __nv_bfloat16* rh = s_a + (mt * 16 + g) * kLdA + k0 + 2 * q;
            const __nv_bfloat16* rl = rh + kTile * kLdA;
            ah[mt][0] = lds32(rh);
            ah[mt][1] = lds32(rh + 8 * kLdA);
            ah[mt][2] = lds32(rh + 8);
            ah[mt][3] = lds32(rh + 8 * kLdA + 8);
            if (three) {
              al[mt][0] = lds32(rl);
              al[mt][1] = lds32(rl + 8 * kLdA);
              al[mt][2] = lds32(rl + 8);
              al[mt][3] = lds32(rl + 8 * kLdA + 8);
            }
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const __nv_bfloat16* bh =
                s_b + (src * kNP + col0 + nt * 8 + g) * kLdB + y0 + 2 * q;
            const __nv_bfloat16* bl = bh + 2 * kNP * kLdB;
            const uint32_t bh0 = lds32(bh) ^ neg, bh1 = lds32(bh + 8) ^ neg;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][nt], ah[mt], bh0, bh1);
            if (three) {
              const uint32_t bl0 = lds32(bl) ^ neg, bl1 = lds32(bl + 8) ^ neg;
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
                mma_bf16(acc[mt][nt], ah[mt], bl0, bl1);
                mma_bf16(acc[mt][nt], al[mt], bh0, bh1);
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            float* d = s_d + (mt * 16 + g) * kLdD + dcol(colw + nt * 8 + 2 * q);
            *reinterpret_cast<float2*>(d) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(d + 8 * kLdD) =
                make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          }
        __syncthreads();

        // stage 2: vis[v,p] (+)= conj(coef) · Σ_x D[v,(p,x)] · conj(Φx[v,x])
        for (int pair = warp * kPairs + lane / kLanes; pair < kTile * kPols;
             pair += kWarps * kPairs) {
          const int j = pair / kPols, p = pair % kPols, xl = lane % kLanes;
          const float* dre = s_d + j * kLdD + p * kLdP;
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int x = xl; x < N; x += kLanes) {
            const float2 ph = s_phx[j * N + x];
            sr = fmaf(dre[x], ph.x, fmaf(dre[kIm + x], ph.y, sr));
            si = fmaf(dre[kIm + x], ph.x, fmaf(-dre[x], ph.y, si));
          }
#pragma unroll
          for (int off = kLanes / 2; off > 0; off /= 2) {
            sr += __shfl_xor_sync(0xffffffffu, sr, off);
            si += __shfl_xor_sync(0xffffffffu, si, off);
          }
          const int t = t0 + j;
          if (xl == 0 && t < T) {
            const float2 e = cmul(make_float2(sr, si), s_coef[j]);
            float2& dst = out_s[(t * C + c) * kPols + p];
            dst = r == 0 ? e : cadd(dst, e);
          }
        }
        __syncthreads();
      }
    }
  }
}

template <int N>
cudaError_t launch_v5(const float* uvw, const float* mu, const float* k, const float* po_x,
                   const float* po_y, const float* l, const float* m, const float* n,
                   const float* sph, const float2* aterms, const int* aterm_index,
                   const int* station1, const int* station2, const float2* subgrids,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  constexpr size_t bytes = Smem<N>::bytes;
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(degridder_sep_v5_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_sep_v5_kernel<N><<<S, kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

namespace idg {
cudaError_t degridder_sep_v3(const float*, const float*, const float*, const float*,
                             const float*, const float*, const float*, const float*,
                             const float*, const float2*, const int*, const int*, const int*,
                             const float2*, float2*, int, int, int, int, int, int, cudaStream_t);
cudaError_t degridder_sep_v4(const float*, const float*, const float*, const float*,
                             const float*, const float*, const float*, const float*,
                             const float*, const float2*, const int*, const int*, const int*,
                             const float2*, float2*, int, int, int, int, int, int, cudaStream_t);
}  // namespace idg

// variant: 0 = cuda_v3 (FP32 FFMA, exact Φ; degridder_sep_fp32.cu), 1 =
// cuda_v4 (bf16 wgmma, exact Φ; degridder_sep_bf16.cu), 2 = cuda_v5 (bf16
// mma.sync, recurrence Φ; this file).
extern "C" int idg_degridder_separable(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* subgrids, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, int variant, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float*)mu, (const float*)k, (const float*)po_x,            \
      (const float*)po_y, (const float*)l, (const float*)m, (const float*)n,           \
      (const float*)sph, (const float2*)aterms, (const int*)aterm_index,               \
      (const int*)station1, (const int*)station2, (const float2*)subgrids,             \
      (float2*)out, S, T, C
  switch (variant) {
    case 0: return (int)idg::degridder_sep_v3(IDG_ARGS, N, nr_stations, w_rank, st);
    case 1: return (int)idg::degridder_sep_v4(IDG_ARGS, N, nr_stations, w_rank, st);
    case 2:
      switch (N) {
        case 16: return (int)launch_v5<16>(IDG_ARGS, nr_stations, w_rank, st);
        case 32: return (int)launch_v5<32>(IDG_ARGS, nr_stations, w_rank, st);
        default: return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}
