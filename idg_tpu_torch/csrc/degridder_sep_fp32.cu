// K9b, degridder cuda_v3: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P], stage 1 in float32 FFMA on the CUDA cores.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_separable (launcher
// _degridder_separable_run, degridder.py:307, registered as pallas_v3 with
// "highest" products). Per subgrid and Taylor rank r, as the plain version
// (ops/cuda/degridder_separable.py:degridder_separable_plain) takes it:
//   B[y, (p,x)] = A1 · (sph·P) · A2ᴴ                                     (prologue)
//   D_r[v, (p,x)] = Σ_y conj(Φy[v,y]) · (n^r ⊙ B)[y, (p,x)]             (stage 1)
//   vis[v,p] = Σ_r conj((iμ_v)^r / r!) · Σ_x D_r[v,(p,x)] · conj(Φx[v,x]) (stage 2)
// every product in float32, Φ by exact sincosf; the output is written as
// [S, T, C, P] directly.
//
// What bounds it on an H100: the FP32 FMA rate. Stage 1 is 2 ranks × V × NP
// × N complex multiply-adds a subgrid at the default problem, 3.29e12 FLOP
// over 24,500 subgrids, 49.1 ms at 67 TFLOP/s; stage 2 is about 3% of that,
// the formation (131,072 exact sincosf a subgrid) about 5%. The parent
// kernel took 99 ms: a thread held 4 × 4 complex outputs of one rank, the
// rank loop was outermost (Φ formed again per rank), and stage 2 ran
// through a shared-memory D tile between barriers.
//
// Design: a register-tiled complex outer product. A thread holds a 4 × 4
// tile of D (4 visibilities × 4 consecutive x of one pol) of two ranks at
// once, 64 accumulators: per y it reads 4 Φy and 4 n^r ⊙ B of each rank
// with 16-byte loads (six LDS.128, 24 words) for 128 FFMA, and Φ is read
// once for both ranks of the default rank 2. The lanes of a warp cover the
// N/4 column groups of one pol and 32·4/N visibility groups, so stage 2
// stays in registers: the thread sums its ranks (conj(c_r) = (−i)^r·μ^r/r!,
// a quarter turn and two FMAs an entry), multiplies by conj(Φx) and sums
// its 4 x, and a butterfly over the pol's lanes sums the rest; no D tile
// goes through shared memory. Ranks go in pairs (rank 4: two walks over
// the tiles, each forming n^r ⊙ B of its pair in a prologue and Φ again);
// the later pairs add into the output. Per tile of 32 visibilities the
// block forms Φy (transposed, [y][v]) and Φx into shared memory, then
// multiplies; two barriers a tile. 256 threads at N = 32 with up to 128
// registers and ~81 KB of shared memory, so two blocks share an SM. Warp
// specialization lost here: with 128 producer threads forming the tiles
// beside 256 consumer threads on one 384-thread block an SM, the kernel
// took 94.6 ms against this design's 87.2, where diagnostic builds took
// 81.1 ms without the formation (the FFMA on eight warps alone) and 19.4
// without the products: eight warps an SM leave the FFMA pipes idle.

#include <cuda_runtime.h>

#include "common.cuh"
#include "separable.cuh"

namespace {

using idg::kPols;

constexpr int kTile = 32;   // visibilities a tile

template <int N>
struct Tile {
  static constexpr int kNP = N * kPols;
  static constexpr int kThreads = kTile * kNP / 16;   // a 4 × 4 tile of D each
  static constexpr int kEnt = kTile * N / kThreads;   // Φ entries a thread forms
  static constexpr int kColLanes = N / 4;             // lanes over the x of one pol
  static constexpr int kVisLanes = 32 / kColLanes;    // visibility groups of a warp
  static constexpr int kLdX = N + 1;                  // Φx row stride (float2)
  // n^r ⊙ B of two ranks [2][N][NP], Φyᵀ [N][kTile], Φx [kTile][kLdX], μ [kTile]
  static constexpr size_t kB = (size_t)N * kNP * sizeof(float2);
  static constexpr size_t kPhy = (size_t)N * kTile * sizeof(float2);
  static constexpr size_t kPhx = (size_t)kTile * kLdX * sizeof(float2);
  static constexpr size_t kBytes = 2 * kB + kPhy + kPhx + kTile * sizeof(float);
  static_assert(kTile * N % kThreads == 0 && kColLanes * kVisLanes == 32, "tile shape");
};

// Stage 1 of one tile, both ranks (kTwo) or the first alone, into this
// thread's accumulators: visibilities v0..v0+3, columns c0..c0+3.
template <int N, bool kTwo>
__device__ __forceinline__ void product(const float2* __restrict__ phy,
                                        const float2* __restrict__ b, int v0, int c0,
                                        float2 (&acc)[2][4][4]) {
  constexpr int kNP = N * kPols;
#pragma unroll 1
  for (int y = 0; y < N; ++y) {
    const float4* py4 = reinterpret_cast<const float4*>(phy + y * kTile + v0);
    const float4 pa = py4[0], pb = py4[1];
    const float2 py[4] = {make_float2(pa.x, pa.y), make_float2(pa.z, pa.w),
                          make_float2(pb.x, pb.y), make_float2(pb.z, pb.w)};
#pragma unroll
    for (int r = 0; r < (kTwo ? 2 : 1); ++r) {
      const float4* b4 = reinterpret_cast<const float4*>(b + (r * N + y) * kNP + c0);
      const float4 ba = b4[0], bb = b4[1];
      const float2 bv[4] = {make_float2(ba.x, ba.y), make_float2(ba.z, ba.w),
                            make_float2(bb.x, bb.y), make_float2(bb.z, bb.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // acc += conj(Φy) · B
          float2& d = acc[r][i][j];
          d.x = fmaf(py[i].x, bv[j].x, fmaf(py[i].y, bv[j].y, d.x));
          d.y = fmaf(py[i].x, bv[j].y, fmaf(-py[i].y, bv[j].x, d.y));
        }
    }
  }
}

// The sum over the kLanes lanes of a pol (lane % kLanes apart) of 4
// complex values, one per visibility slot: each lane ends with the full
// sum of slot (lane % kLanes) / (kLanes / 4).
template <int kLanes>
__device__ __forceinline__ float2 reduce_pol(const float2 (&sv)[4], int lane) {
  float2 t[2];
  const bool hi = lane & (kLanes / 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 keep = hi ? sv[i + 2] : sv[i], send = hi ? sv[i] : sv[i + 2];
    t[i] = make_float2(keep.x + __shfl_xor_sync(0xffffffffu, send.x, kLanes / 2),
                       keep.y + __shfl_xor_sync(0xffffffffu, send.y, kLanes / 2));
  }
  const bool mid = lane & (kLanes / 4);
  const float2 keep = mid ? t[1] : t[0], send = mid ? t[0] : t[1];
  float2 u = make_float2(keep.x + __shfl_xor_sync(0xffffffffu, send.x, kLanes / 4),
                         keep.y + __shfl_xor_sync(0xffffffffu, send.y, kLanes / 4));
#pragma unroll
  for (int off = kLanes / 8; off > 0; off /= 2) {
    u.x += __shfl_xor_sync(0xffffffffu, u.x, off);
    u.y += __shfl_xor_sync(0xffffffffu, u.y, off);
  }
  return u;
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, 2) degridder_sep_v3_kernel(
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
  using TL = Tile<N>;
  constexpr int kNP = TL::kNP;
  constexpr int kThreads = TL::kThreads;
  constexpr int kLd = TL::kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* s_b = reinterpret_cast<float2*>(smem);                                // [2][N][NP]
  float2* s_phy = reinterpret_cast<float2*>(smem + 2 * TL::kB);                 // [N][kTile]
  float2* s_phx = reinterpret_cast<float2*>(smem + 2 * TL::kB + TL::kPhy);      // [kTile][kLd]
  float* s_mu = reinterpret_cast<float*>(smem + 2 * TL::kB + TL::kPhy + TL::kPhx);

  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = T * C;
  const int nt = (V + kTile - 1) / kTile;
  const size_t nn = (size_t)N * N;
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float* mu_s = mu + (size_t)s * V;
  const float* pox_s = po_x + (size_t)s * N;
  const float* poy_s = po_y + (size_t)s * N;
  float2* out_s = out + (size_t)s * V * kPols;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;

  // the thread's D tile: warp w covers pol w % 4 and visibility block w / 4;
  // its lanes the pol's column groups × kVisLanes visibility groups
  const int pol = warp % kPols;
  const int cg = lane % TL::kColLanes;
  const int v0 = 4 * ((warp / kPols) * TL::kVisLanes + lane / TL::kColLanes);
  const int x0 = 4 * cg, c0 = pol * N + x0;

  for (int r0 = 0; r0 < w_rank; r0 += 2) {
    const int nr = min(2, w_rank - r0);
    // prologue: n^r ⊙ A1 · (sph·P) · A2ᴴ (math.hpp:79-92) of the pair
    for (int px = tid; px < N * N; px += kThreads) {
      const int y = px / N, x = px % N;
      const float taper = sph[px];
      float2 p[kPols], o[kPols];
#pragma unroll
      for (int i = 0; i < kPols; ++i) {
        const float2 v = sub_s[i * nn + px];
        p[i] = make_float2(v.x * taper, v.y * taper);
      }
      jones_degridder(aterms + (at1 + px) * kPols, aterms + (at2 + px) * kPols, p, o);
      const float npx = n[px];
      float np = power(npx, r0);
      for (int r = 0; r < nr; ++r) {
        if (r) np *= npx;
#pragma unroll
        for (int i = 0; i < kPols; ++i) {
          s_b[(r * N + y) * kNP + i * N + x] = make_float2(o[i].x * np, o[i].y * np);
        }
      }
    }

    for (int j = 0; j < nt; ++j) {
      // Φyᵀ, Φx and μ of tile j (zeros past V, by selects)
      const int vt = j * kTile;
#pragma unroll
      for (int i = 0; i < TL::kEnt; ++i) {
        const int e = tid + i * kThreads, a = e / kTile, kk = e % kTile;
        const bool live = vt + kk < V;
        const int v = min(vt + kk, V - 1), t = v / C, c = v - t * C;
        const float kc = __ldg(k + c);
        float sn, cs;
        sincosf(__ldg(pox_s + a) - __ldg(l + a) * (__ldg(uvw_s + t * 3) * kc), &sn, &cs);
        s_phx[kk * kLd + a] = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
        sincosf(__ldg(poy_s + a) - __ldg(m + a) * (__ldg(uvw_s + t * 3 + 1) * kc), &sn, &cs);
        s_phy[a * kTile + kk] = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
      }
      if (tid < kTile) s_mu[tid] = vt + tid < V ? __ldg(mu_s + vt + tid) : 0.0f;
      __syncthreads();   // also orders the pair's prologue before its first product

      float2 acc[2][4][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[r][i][jj] = make_float2(0.0f, 0.0f);
      if (nr == 2) {
        product<N, true>(s_phy, s_b, v0, c0, acc);
      } else {
        product<N, false>(s_phy, s_b, v0, c0, acc);
      }

      // stage 2: per visibility, Σ_r conj(c_r) · D_r, times conj(Φx), over
      // the thread's 4 x; then the butterfly over the pol's lanes
      float2 part[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = v0 + i;
        const float mv = s_mu[kk];
        float w = 1.0f;
        for (int r = 1; r <= r0; ++r) w *= mv * __fdividef(1.0f, (float)r);
        float2 sum[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // conj(c_r) = (−i)^r · w: a quarter turn per rank, then the scale
          const float a = (r0 & 2) ? -w : w;
          const float2 d = acc[0][i][jj];
          sum[jj] = (r0 & 1) ? make_float2(a * d.y, -a * d.x) : make_float2(a * d.x, a * d.y);
        }
        if (nr == 2) {
          const int r = r0 + 1;
          const float a = ((r & 2) ? -w : w) * (mv * __fdividef(1.0f, (float)r));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 d = acc[1][i][jj];
            sum[jj].x = fmaf(a, (r & 1) ? d.y : d.x, sum[jj].x);
            sum[jj].y = fmaf(a, (r & 1) ? -d.x : d.y, sum[jj].y);
          }
        }
        float2 pv = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) pv = cadd(pv, cmul_by_conj(sum[jj], s_phx[kk * kLd + x0 + jj]));
        part[i] = pv;
      }
      const float2 total = reduce_pol<TL::kColLanes>(part, lane);
      const int slot = cg / (TL::kColLanes / 4), v = vt + v0 + slot;
      if (cg % (TL::kColLanes / 4) == 0 && v < V) {
        float2& dst = out_s[(size_t)v * kPols + pol];
        dst = r0 == 0 ? total : cadd(dst, total);
      }
      __syncthreads();   // the next tile rewrites Φ and μ
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
  using TL = Tile<N>;
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(degridder_sep_v3_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::kBytes);
  if (err != cudaSuccess) return err;
  degridder_sep_v3_kernel<N><<<S, TL::kThreads, TL::kBytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

namespace idg {

cudaError_t degridder_sep_v3(const float* uvw, const float* mu, const float* k,
                             const float* po_x, const float* po_y, const float* l,
                             const float* m, const float* n, const float* sph,
                             const float2* aterms, const int* aterm_index,
                             const int* station1, const int* station2,
                             const float2* subgrids, float2* out, int S, int T, int C, int N,
                             int nr_stations, int w_rank, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<16>(uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                               station1, station2, subgrids, out, S, T, C, nr_stations,
                               w_rank, stream);
    case 32: return launch<32>(uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                               station1, station2, subgrids, out, S, T, C, nr_stations,
                               w_rank, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace idg
