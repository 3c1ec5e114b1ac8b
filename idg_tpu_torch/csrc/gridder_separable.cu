// K8c, gridder cuda_v5: visibilities -> subgrids c64[S, P, N, N], the
// separable product in split bf16 on the tensor cores (mma.sync) with Φ by
// the channel recurrence; and the entry point of the three separable rungs
// (cuda_v3: gridder_sep_fp32.cu, cuda_v4: gridder_sep_bf16.cu).
//
// Replaces idg_tpu/ops/pallas/gridder.py:_kernel_sep_recur (launcher
// _gridder_sep_recur_run, gridder.py:708, registered as pallas_v5). Per
// subgrid and Taylor rank r it takes one complex matrix product over the
// visibilities v = (c, t):
//   pix_r[y, (p,x)] = Σ_v Φy[v,y] · W_r[v,(p,x)],  W_r = Φx[v,x] · vis[v,p] · (iμ_v)^r / r!
// then pix = Σ_r n^r ⊙ pix_r, the Jones correction A1ᴴ·P·A2 and the taper.
// The complex product is packed on the contraction axis,
//   [Φy_re | Φy_im] (N × 2V) · [[W_re, W_im], [−W_im, W_re]] (2V × 2NP),
// so a rank's accumulators are N × 2NP float32 (32 × 256 at N = 32). The
// products are bf16 mma.sync m16n8k16 with float32 accumulation: the "3x"
// policy takes hi·hi + hi·lo + lo·hi of the round-to-nearest hi/lo splits,
// "default" one hi·hi pass (ops/precision.py). Φ is made by the recurrence
// (Φ_c = Φ_{c−1}·Φ_Δk, exact restart from k0 + c·Δk at every c % 16 == 0,
// c > 0).
//
// What bounds it on an H100: the products. Per subgrid, rank and pass they
// are 2·N·2NP·2V FLOP (67 MFLOP at N = 32, V = 2048) against ~130 KB of input,
// so the kernel is compute-bound on the tensor-core rate, where forming W
// (one complex multiply and two bf16 splits per entry of W, O(V·N·P) per
// rank) on the CUDA cores and the operands' trips through shared memory
// compete with the mma issue. The L1/shared-memory path is the one measured
// to bind: the first version read each tile's visibilities per lane with a
// 512 B stride (~4,700 L1 wavefronts a tile) and took 111 ms at the default
// problem; staging them once per tile with coalesced loads took it to 64
// ms (H100 80GB HBM3, 700 W).
//
// Design: one block of 512 threads per subgrid. The rank loop is outermost,
// so that a thread holds one rank's accumulators (16 floats at N = 32) for
// any rank 1–6; the ranks meet in a shared-memory pixel sum weighted by n^r.
// Inside a rank the block walks tiles of kTile timesteps of one channel,
// t-tile outer and channel inner, so the recurrence's state for a thread's Φ
// entries stays in its registers across the channels. Per tile the block
// stages the tile's vis·(iμ)^r/r! ([P][kTile], coalesced loads), writes Φy,
// then W, to shared memory as bf16 hi/lo halves and, after a barrier,
// multiplies. Warp w owns output columns [16w, 16w + 16) at N = 32: warps
// 0–7 the real parts, 8–15 the imaginary ones, each all N rows. The
// fragments' bf16 pairs are read with 32-bit loads from rows padded by 8
// values (no bank conflicts), −W_im by a sign flip of the loaded pair. A
// tile's mma.sync products go to fresh accumulators that are then added to
// the rank's in round-to-nearest FADDs: the tensor cores' accumulation
// truncates, and a running sum over all of V missed the 1e-5 gate against
// the plain version (3.2e-5 at V = 768). The TPU kernel's whole-V
// [2N, V] × [V, 2NP] dot and its [2N, 2NP] accumulator, which the VMEM held,
// have no counterpart: here the product is cut into tiles and the packing
// halves the accumulators. The rungs cuda_v3 and cuda_v4 have kernels of
// their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "separable.cuh"

namespace {

using idg::kPols;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // timesteps of one channel per pass
constexpr int kPad = 8;     // bf16 row padding of the operand tiles
constexpr int kLd = kTile + kPad;

template <int N>
struct Smem {
  static constexpr int kNP = N * kPols;
  // the pixel sum over ranks, [N(y)][NP] complex, the tile's weighted
  // visibilities [P][kTile] complex, then the operand tiles
  static constexpr size_t pix = (size_t)N * kNP * sizeof(float2);
  static constexpr size_t vt = (size_t)kPols * kTile * sizeof(float2);
  static constexpr size_t a = (size_t)4 * N * kLd * sizeof(__nv_bfloat16);
  static constexpr size_t b = (size_t)4 * kNP * kLd * sizeof(__nv_bfloat16);
  static constexpr size_t bytes = pix + vt + a + b;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1) gridder_sep_v5_kernel(
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
  constexpr int kNP = N * kPols;
  constexpr int kEnt = kTile * N / kThreads;   // Φ entries of each axis per thread
  static_assert(kTile * N % kThreads == 0 && kTile % 16 == 0, "tile shape");
  using S = Smem<N>;
  extern __shared__ float4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  float2* s_pix = reinterpret_cast<float2*>(base);                  // [N][NP]
  float2* s_vt = reinterpret_cast<float2*>(base + S::pix);          // [P][kTile]
  char* ops = base + S::pix + S::vt;
  // Φy as A [hl][re|im][y][kLd], W as B [hl][re|im][(p,x)][kLd]
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(ops);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(ops + S::a);

  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * T * C * kPols;
  const float* mu_s = mu + (size_t)s * T * C;
  const float* pox_s = po_x + (size_t)s * N;
  const float* poy_s = po_y + (size_t)s * N;
  const float dk = C > 1 ? k[1] - k[0] : 0.0f;

  // a thread's Φ entries: (axis index, tile row) of e = tid + i·kThreads,
  // tile row fastest
  auto entry = [&](int i, int& a, int& j) {
    const int e = tid + i * kThreads;
    a = e / kTile;
    j = e % kTile;
  };
  // recurrence state of this thread's entries
  float2 cur_x[kEnt], step_x[kEnt], cur_y[kEnt], step_y[kEnt];

  // tensor-core tiling: warp w owns columns [w·kCols, (w+1)·kCols) of the
  // N × 2NP output; the first half of the warps the real parts
  constexpr int kMT = N / 16, kCols = 2 * kNP / kWarps, kNT = kCols / 8;
  const bool imag_warp = warp >= kWarps / 2;
  const int col0 = (warp % (kWarps / 2)) * kCols;   // column within NP
  const int g = lane / 4, q = lane % 4;

  for (int r = 0; r < w_rank; ++r) {
    const bool three = r == 0 || w_rank > 2;   // gridder_precisions(w_rank)[r]
    float acc[kMT][kNT][4] = {};

    for (int t0 = 0; t0 < T; t0 += kTile) {
      for (int c = 0; c < C; ++c) {
        // the tile's vis·(iμ)^r/r!, read once per block with coalesced loads
        for (int e = tid; e < kTile * kPols; e += kThreads) {
          const int j = e / kPols, p = e % kPols, t = t0 + j;
          s_vt[p * kTile + j] = t < T ? cmul(vis_s[(t * C + c) * kPols + p],
                                             taylor_coefficient<false>(mu_s[t * C + c], r))
                                      : make_float2(0.0f, 0.0f);
        }
        // Φy of tile (t0, c) into shared memory, this thread's Φx kept
        float2 phx[kEnt];
#pragma unroll
        for (int i = 0; i < kEnt; ++i) {
          int a, j;
          entry(i, a, j);
          const int t = t0 + j;
          float2 phy = make_float2(0.0f, 0.0f);
          phx[i] = phy;
          if (t < T) {
            phx[i] = phasor<true>(pox_s[a], l[a], uvw_s[t * 3 + 0], k, c, dk, cur_x[i],
                                  step_x[i]);
            phy = phasor<true>(poy_s[a], m[a], uvw_s[t * 3 + 1], k, c, dk, cur_y[i],
                               step_y[i]);
          }
          split_bf16(phy.x, s_a[(0 * N + a) * kLd + j], s_a[(2 * N + a) * kLd + j]);
          split_bf16(phy.y, s_a[(1 * N + a) * kLd + j], s_a[(3 * N + a) * kLd + j]);
        }
        __syncthreads();
        // W = Φx ⊙ the weighted visibilities (zero past T)
#pragma unroll
        for (int i = 0; i < kEnt; ++i) {
          int a, j;
          entry(i, a, j);
#pragma unroll
          for (int p = 0; p < kPols; ++p) {
            const float2 w = cmul(phx[i], s_vt[p * kTile + j]);
            const int col = p * N + a;
            split_bf16(w.x, s_b[(0 * kNP + col) * kLd + j], s_b[(2 * kNP + col) * kLd + j]);
            split_bf16(w.y, s_b[(1 * kNP + col) * kLd + j], s_b[(3 * kNP + col) * kLd + j]);
          }
        }
        __syncthreads();

        // the tile's sum in fresh accumulators, added to the rank's with
        // round-to-nearest: mma.sync's own accumulation truncates, which
        // over the 64 tiles of V = 2048 biases the sum by ~1e-4
        float tacc[kMT][kNT][4] = {};
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          // columns' K halves: real parts [W_re; −W_im], imaginary [W_im; W_re]
          const int src = imag_warp ? 1 - ri : ri;
          const uint32_t neg = (!imag_warp && ri == 1) ? kNegPair : 0u;
#pragma unroll
          for (int k0 = 0; k0 < kTile; k0 += 16) {
            uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              const __nv_bfloat16* rh = s_a + (ri * N + mt * 16 + g) * kLd + k0 + 2 * q;
              const __nv_bfloat16* rl = rh + 2 * N * kLd;
              ah[mt][0] = lds32(rh);
              ah[mt][1] = lds32(rh + 8 * kLd);
              ah[mt][2] = lds32(rh + 8);
              ah[mt][3] = lds32(rh + 8 * kLd + 8);
              if (three) {
                al[mt][0] = lds32(rl);
                al[mt][1] = lds32(rl + 8 * kLd);
                al[mt][2] = lds32(rl + 8);
                al[mt][3] = lds32(rl + 8 * kLd + 8);
              }
            }
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const __nv_bfloat16* bh =
                  s_b + (src * kNP + col0 + nt * 8 + g) * kLd + k0 + 2 * q;
              const __nv_bfloat16* bl = bh + 2 * kNP * kLd;
              const uint32_t bh0 = lds32(bh) ^ neg, bh1 = lds32(bh + 8) ^ neg;
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) mma_bf16(tacc[mt][nt], ah[mt], bh0, bh1);
              if (three) {
                const uint32_t bl0 = lds32(bl) ^ neg, bl1 = lds32(bl + 8) ^ neg;
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                  mma_bf16(tacc[mt][nt], ah[mt], bl0, bl1);
                  mma_bf16(tacc[mt][nt], al[mt], bh0, bh1);
                }
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tacc[mt][nt][e];
        __syncthreads();
      }
    }

    // this rank's product, weighted by n^r, into the pixel sum; every
    // (row, column) belongs to one thread, so no barrier until the epilogue
    float* pix = reinterpret_cast<float*>(s_pix) + (imag_warp ? 1 : 0);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = mt * 16 + g + (e >= 2 ? 8 : 0);
          const int col = col0 + nt * 8 + 2 * q + (e & 1);
          const float v = acc[mt][nt][e] * power(n[y * N + col % N], r);
          float& dst = pix[2 * (y * kNP + col)];
          dst = r == 0 ? v : dst + v;
        }
  }
  __syncthreads();

  // epilogue: A1ᴴ · P · A2 (math.hpp:64-77), then the taper
  const size_t nn = (size_t)N * N;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  for (int px = tid; px < N * N; px += kThreads) {
    const int y = px / N, x = px % N;
    float2 p[kPols], o[kPols];
#pragma unroll
    for (int pol = 0; pol < kPols; ++pol) p[pol] = s_pix[y * kNP + pol * N + x];
    jones_gridder(aterms + (at1 + px) * kPols, aterms + (at2 + px) * kPols, p, o);
    const float taper = sph[px];
#pragma unroll
    for (int pol = 0; pol < kPols; ++pol) {
      out[((size_t)s * kPols + pol) * nn + px] = make_float2(o[pol].x * taper, o[pol].y * taper);
    }
  }
}

template <int N>
cudaError_t launch_v5(const float* uvw, const float2* vis, const float* mu, const float* k,
                   const float* po_x, const float* po_y, const float* l, const float* m,
                   const float* n, const float* sph, const float2* aterms,
                   const int* aterm_index, const int* station1, const int* station2,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  constexpr size_t bytes = Smem<N>::bytes;
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(gridder_sep_v5_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  gridder_sep_v5_kernel<N><<<S, kThreads, bytes, stream>>>(
      uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

namespace idg {
cudaError_t gridder_sep_v3(const float*, const float2*, const float*, const float*, const float*,
                           const float*, const float*, const float*, const float*,
                           const float*, const float2*, const int*, const int*, const int*,
                           float2*, int, int, int, int, int, int, cudaStream_t);
cudaError_t gridder_sep_v4(const float*, const float2*, const float*, const float*, const float*,
                           const float*, const float*, const float*, const float*,
                           const float*, const float2*, const int*, const int*, const int*,
                           float2*, int, int, int, int, int, int, cudaStream_t);
}  // namespace idg

// variant: 0 = cuda_v3 (FP32 FFMA, exact Φ; gridder_sep_fp32.cu), 1 =
// cuda_v4 (bf16 wgmma, exact Φ; gridder_sep_bf16.cu), 2 = cuda_v5 (bf16
// mma.sync, recurrence Φ; this file).
extern "C" int idg_gridder_separable(
    const void* uvw, const void* vis, const void* mu, const void* k, const void* po_x,
    const void* po_y, const void* l, const void* m, const void* n, const void* sph,
    const void* aterms, const void* aterm_index, const void* station1,
    const void* station2, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, int variant, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float2*)vis, (const float*)mu, (const float*)k,            \
      (const float*)po_x, (const float*)po_y, (const float*)l, (const float*)m,        \
      (const float*)n, (const float*)sph, (const float2*)aterms,                       \
      (const int*)aterm_index, (const int*)station1, (const int*)station2,             \
      (float2*)out, S, T, C
  switch (variant) {
    case 0: return (int)idg::gridder_sep_v3(IDG_ARGS, N, nr_stations, w_rank, st);
    case 1: return (int)idg::gridder_sep_v4(IDG_ARGS, N, nr_stations, w_rank, st);
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
