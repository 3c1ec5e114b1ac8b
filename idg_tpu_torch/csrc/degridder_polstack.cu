// Pol-stacked x-first degridder: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P] (K9d).
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_polstack (launcher
// _degridder_polstack_one behind _chunked; registered as pallas_v6 with
// degridder_precisions). Per subgrid and Taylor rank r:
//   lhs_r [4N, 2N] = pol-stacked [B_re·n^r | B_im·n^r],  B = A1·(sph·P)·A2ᴴ
//   rhs   [2N, 2V] = [[Φx_re, −Φx_im], [Φx_im, Φx_re]]    (Φx as [x, v])
//   D_r = lhs_r · rhs, the [Re | Im] of B_p · conj(Φx)ᵀ per pol   (the product)
//   vis[v,p] += conj((iμ_v)^r / r!) · Σ_y conj(Φy[v,y]) · D_r,p[y,v]   (stage 2)
// Φx and Φy come from the channel recurrence with its exact restart from
// k0 + c·Δk at every c % 16 == 0, c > 0, c-major (uniform channel spacing
// assumed; the API guard falls back to cuda_v4). The product is bf16
// mma.sync m16n8k16 into float32: "3x2k", all four products of the
// round-to-nearest hi/lo splits (lo·lo included), for rank 0 and for every
// rank of a rank > 2; one hi·hi pass for rank 1 at rank ≤ 2. The TPU kernel
// packed the splits on the contraction axis to fill its matrix unit; here
// each product is its own mma and the packing has no counterpart.
//
// What bounds it on an H100: the products, 2·4N·2N·2V FLOP per subgrid,
// rank and pass (67 MFLOP at N = 32; five passes at the default rank 2),
// on the tensor cores, against ~100 KB of input per subgrid. The separable
// rungs K9b/K9c were measured to be bound instead by the CUDA-core work
// around their mma: forming and splitting Φ once per rank, and stage 2's
// trips through shared memory (degridder_separable.cu). Design against that:
//  - the lhs of every rank is formed and split once per subgrid into shared
//    memory, in mma A-fragment order (one 16-byte load per fragment);
//  - the rank loop sits inside the loop over visibility tiles (kTile
//    timesteps of one channel; t-tile outer, channel inner, so the
//    recurrence's state stays in registers). Φx and Φy of a tile are formed,
//    and Φx split, once for every rank. The rhs tile holds only its real
//    columns, in B-fragment order: an imaginary column is the same data with
//    the two halves of the contraction axis swapped and the first negated;
//  - stage 2 runs on the accumulators in registers: each lane multiplies its
//    D entries by conj(Φy) and sums its rows, then a butterfly over the
//    eight lanes of a column group (8 shuffles) leaves each lane the y-sum of
//    one visibility. No D tile goes through shared memory;
//  - each visibility's sum over ranks stays in a register and is written
//    once per tile.
// Block: 256 threads per subgrid; warp w owns pol w / 2 (all N rows of it)
// and the tile's timesteps [16·(w % 2), +16): two n8 tiles of real and two
// of imaginary columns. In a "3x2k" pass the small products (lo·lo, hi·lo,
// lo·hi) of each 16-deep step go into the accumulator before hi·hi.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "separable.cuh"

namespace {

using idg::kPols;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;         // timesteps of one channel per tile
constexpr int kNT = kTile / 8;    // n8 tiles of the tile's real columns

template <int N>
struct Layout {
  static constexpr int kK = 2 * N;            // contraction: x (re) | x (im)
  static constexpr int kKS = kK / 16;         // 16-deep steps
  static constexpr int kLdPhy = N + 2;        // Φy row stride (float2): conflict-free stage 2
  static constexpr size_t lhs = (size_t)kPols * N * kK;   // bf16 per rank and split half
  static constexpr size_t rhs = (size_t)kTile * kK;       // bf16 per split half
  static size_t bytes(int w_rank) {
    return (2 * w_rank * lhs + 2 * rhs) * sizeof(__nv_bfloat16) +
           (size_t)kTile * kLdPhy * sizeof(float2);
  }
};

// bf16 offset of lhs element (row, k) in A-fragment order: per (16-row tile,
// 16-deep step) the 32 lanes' four registers, lane by lane (fragment
// ownership in separable.cuh:mma_bf16).
template <int N>
__device__ __forceinline__ int a_offset(int row, int k) {
  constexpr int kKS = Layout<N>::kKS;
  const int r = row & 15, kk = k & 15;
  const int lane = (r & 7) * 4 + ((kk & 7) >> 1);
  const int reg = (r >> 3) + 2 * (kk >> 3);
  return ((((row >> 4) * kKS + (k >> 4)) * 32 + lane) * 4 + reg) * 2 + (kk & 1);
}

// bf16 offset of rhs element (k, real column j) in B-fragment order: per
// (16-deep step, 8-column tile) the lanes' two registers.
__device__ __forceinline__ int b_offset(int k, int j) {
  const int kk = k & 15;
  const int lane = (j & 7) * 4 + ((kk & 7) >> 1);
  return ((((k >> 4) * kNT + (j >> 3)) * 32 + lane) * 2 + (kk >> 3)) * 2 + (kk & 1);
}

__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* base, int tile,
                                       int lane) {
  const uint4 v = *reinterpret_cast<const uint4*>(base + (tile * 32 + lane) * 8);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ uint2 load_b(const __nv_bfloat16* base, int tile, int lane) {
  return *reinterpret_cast<const uint2*>(base + (tile * 32 + lane) * 4);
}

// One 16-deep step of x on a 16-row tile and the real/imaginary n8 tiles
// of the same columns: a_re holds B_re·n^r, a_im B_im·n^r; b_re Φx_re,
// b_im Φx_im. D_re += a_re·b_re + a_im·b_im, D_im += a_im·b_re − a_re·b_im.
__device__ __forceinline__ void complex_step(float (&d_re)[4], float (&d_im)[4],
                                             const uint32_t (&a_re)[4],
                                             const uint32_t (&a_im)[4], uint2 b_re,
                                             uint2 b_im) {
  using idg::kNegPair;
  idg::mma_bf16(d_re, a_re, b_re.x, b_re.y);
  idg::mma_bf16(d_re, a_im, b_im.x, b_im.y);
  idg::mma_bf16(d_im, a_im, b_re.x, b_re.y);
  idg::mma_bf16(d_im, a_re, b_im.x ^ kNegPair, b_im.y ^ kNegPair);
}

// Sum over the eight lanes of a column group (lanes of one q = lane % 4) of
// four (re, im) partial sums, one per (n-tile, column parity): each lane
// ends with the full sum of entry 2·(g >> 2) + ((g >> 1) & 1), g = lane / 4.
__device__ __forceinline__ float2 reduce_rows(const float2 (&sv)[4], int lane) {
  const bool b2 = lane & 16, b1 = lane & 8;
  float2 t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 keep = b2 ? sv[i + 2] : sv[i], send = b2 ? sv[i] : sv[i + 2];
    t[i] = make_float2(keep.x + __shfl_xor_sync(0xffffffffu, send.x, 16),
                       keep.y + __shfl_xor_sync(0xffffffffu, send.y, 16));
  }
  const float2 keep = b1 ? t[1] : t[0], send = b1 ? t[0] : t[1];
  float2 u = make_float2(keep.x + __shfl_xor_sync(0xffffffffu, send.x, 8),
                         keep.y + __shfl_xor_sync(0xffffffffu, send.y, 8));
  u.x += __shfl_xor_sync(0xffffffffu, u.x, 4);
  u.y += __shfl_xor_sync(0xffffffffu, u.y, 4);
  return u;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2) degridder_polstack_kernel(
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
  using L = Layout<N>;
  constexpr int kKS = L::kKS, kXS = N / 16, kLdPhy = L::kLdPhy;
  constexpr int kEnt = kTile * N / kThreads;   // Φ entries of each axis per thread
  static_assert(kTile * N % kThreads == 0 && N % 16 == 0, "tile shape");
  static_assert(kWarps == 2 * kPols && kNT == 4, "warp tiling: two warps per pol");
  extern __shared__ float4 smem[];
  __nv_bfloat16* s_lhs = reinterpret_cast<__nv_bfloat16*>(smem);   // [w_rank][hi, lo][lhs]
  __nv_bfloat16* s_rhs = s_lhs + 2 * w_rank * L::lhs;               // [hi, lo][rhs]
  float2* s_phy = reinterpret_cast<float2*>(s_rhs + 2 * L::rhs);    // [kTile][kLdPhy]

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

  // prologue: lhs_r[(p, y)][x | N + x] = the splits of B_p[y][x]·n^r for
  // every rank (math.hpp:79-92; n^r by r multiplies, degridder.py:731)
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
    const float npx = n[px];
    float np = 1.0f;
    for (int r = 0; r < w_rank; ++r) {
      if (r) np *= npx;
      __nv_bfloat16* hi = s_lhs + 2 * r * L::lhs;
      __nv_bfloat16* lo = hi + L::lhs;
#pragma unroll
      for (int pol = 0; pol < kPols; ++pol) {
        const int row = pol * N + y;
        const int ore = a_offset<N>(row, x), oim = a_offset<N>(row, N + x);
        split_bf16(o[pol].x * np, hi[ore], lo[ore]);
        split_bf16(o[pol].y * np, hi[oim], lo[oim]);
      }
    }
  }

  // warp tiling, and the visibility each lane holds after reduce_rows
  const int pol = warp / 2, vhalf = warp % 2;
  const int g = lane / 4, q = lane % 4;
  const int jv = vhalf * 16 + (g >> 2) * 8 + 2 * q + ((g >> 1) & 1);
  const bool writer = (g & 1) == 0;

  // recurrence state of this thread's Φ entries (tile row e / N, axis e % N)
  float2 cur_x[kEnt], step_x[kEnt], cur_y[kEnt], step_y[kEnt];

  for (int t0 = 0; t0 < T; t0 += kTile) {
    for (int c = 0; c < C; ++c) {
      // Φx (split, B-fragment order) and Φy (float32) of tile (t0, c)
#pragma unroll
      for (int i = 0; i < kEnt; ++i) {
        const int e = tid + i * kThreads, j = e / N, a = e % N;
        const int t = t0 + j;
        float2 phx = make_float2(0.0f, 0.0f), phy = phx;
        if (t < T) {
          phx = phasor<true>(pox_s[a], l[a], uvw_s[t * 3 + 0], k, c, dk, cur_x[i], step_x[i]);
          phy = phasor<true>(poy_s[a], m[a], uvw_s[t * 3 + 1], k, c, dk, cur_y[i], step_y[i]);
        }
        const int ore = b_offset(a, j), oim = b_offset(N + a, j);
        split_bf16(phx.x, s_rhs[ore], s_rhs[L::rhs + ore]);
        split_bf16(phx.y, s_rhs[oim], s_rhs[L::rhs + oim]);
        s_phy[j * kLdPhy + a] = phy;
      }
      __syncthreads();   // also orders the prologue before the first product

      const int t = t0 + jv;
      const float mu_v = t < T ? mu_s[t * C + c] : 0.0f;
      float2 coef = make_float2(1.0f, 0.0f);   // conj((iμ)^r / r!), degridder.py:725-730
      float2 vis = make_float2(0.0f, 0.0f);
      for (int r = 0; r < w_rank; ++r) {
        if (r) {
          const float cr = coef.y * mu_v / r;
          coef.y = -coef.x * mu_v / r;
          coef.x = cr;
        }
        const bool three = r == 0 || w_rank > 2;   // degridder_precisions(w_rank)[r] == "3x2k"
        const __nv_bfloat16* lh = s_lhs + 2 * r * L::lhs;
        const __nv_bfloat16* ll = lh + L::lhs;
        float2 sv[4] = {};   // Σ_y conj(Φy)·D per (n-tile, column parity)
#pragma unroll
        for (int mt = 0; mt < N / 16; ++mt) {
          const int arow = pol * (N / 16) + mt;   // the 16-row tile of the lhs
          float acc[4][4] = {};                   // real n-tiles 0, 1, imaginary 0, 1
#pragma unroll
          for (int xs = 0; xs < kXS; ++xs) {
            const int ka = xs, kb = xs + kXS;     // the x (re) and x (im) halves
            uint32_t ah_re[4], ah_im[4], al_re[4], al_im[4];
            load_a(ah_re, lh, arow * kKS + ka, lane);
            load_a(ah_im, lh, arow * kKS + kb, lane);
            if (three) {
              load_a(al_re, ll, arow * kKS + ka, lane);
              load_a(al_im, ll, arow * kKS + kb, lane);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int bt = vhalf * 2 + nt;
              const uint2 bh_re = load_b(s_rhs, ka * kNT + bt, lane);
              const uint2 bh_im = load_b(s_rhs, kb * kNT + bt, lane);
              if (three) {
                const uint2 bl_re = load_b(s_rhs + L::rhs, ka * kNT + bt, lane);
                const uint2 bl_im = load_b(s_rhs + L::rhs, kb * kNT + bt, lane);
                complex_step(acc[nt], acc[2 + nt], al_re, al_im, bl_re, bl_im);
                complex_step(acc[nt], acc[2 + nt], ah_re, ah_im, bl_re, bl_im);
                complex_step(acc[nt], acc[2 + nt], al_re, al_im, bh_re, bh_im);
              }
              complex_step(acc[nt], acc[2 + nt], ah_re, ah_im, bh_re, bh_im);
            }
          }
          // stage 2 on this row tile: acc entry (row g + 8·hr, column 2q + e)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int j = vhalf * 16 + nt * 8 + 2 * q + e, y = mt * 16 + g + 8 * hr;
                const float2 ph = s_phy[j * kLdPhy + y];
                const float dr = acc[nt][2 * hr + e], di = acc[2 + nt][2 * hr + e];
                float2& a = sv[nt * 2 + e];
                a.x = fmaf(dr, ph.x, fmaf(di, ph.y, a.x));
                a.y = fmaf(di, ph.x, fmaf(-dr, ph.y, a.y));
              }
        }
        vis = cadd(vis, cmul(reduce_rows(sv, lane), coef));
      }
      if (writer && t < T) out_s[(t * C + c) * kPols + pol] = vis;
      __syncthreads();   // the next tile's Φ overwrites what this one read
    }
  }
}

template <int N>
cudaError_t launch(const float* uvw, const float* mu, const float* k, const float* po_x,
                   const float* po_y, const float* l, const float* m, const float* n,
                   const float* sph, const float2* aterms, const int* aterm_index,
                   const int* station1, const int* station2, const float2* subgrids,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  const size_t bytes = Layout<N>::bytes(w_rank);
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(degridder_polstack_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_polstack_kernel<N><<<S, kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_degridder_polstack(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* subgrids, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float*)mu, (const float*)k, (const float*)po_x,            \
      (const float*)po_y, (const float*)l, (const float*)m, (const float*)n,           \
      (const float*)sph, (const float2*)aterms, (const int*)aterm_index,               \
      (const int*)station1, (const int*)station2, (const float2*)subgrids,             \
      (float2*)out, S, T, C, nr_stations, w_rank, st
  switch (N) {
    case 16: return (int)launch<16>(IDG_ARGS);
    case 32: return (int)launch<32>(IDG_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}
