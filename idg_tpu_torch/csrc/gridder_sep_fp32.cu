// K8b, gridder cuda_v3: visibilities -> subgrids c64[S, P, N, N], the
// separable product in float32 FFMA on the CUDA cores.
//
// Replaces idg_tpu/ops/pallas/gridder.py:_kernel_separable (launcher
// _gridder_separable_run, gridder.py:525, registered as pallas_v3 with
// "highest" products). Per subgrid and Taylor rank r, as the plain version
// (ops/cuda/gridder_separable.py:gridder_separable_plain) takes it:
//   pix_r[y, (p,x)] = Σ_v Φy[v,y] · W_r[v,(p,x)],  W_r = Φx[v,x] · (vis[v,p] · (iμ_v)^r / r!)
// then pix = Σ_r n^r ⊙ pix_r, the Jones correction A1ᴴ·P·A2 and the taper,
// with every product in float32 and Φ by exact sincosf.
//
// What bounds it on an H100: the FP32 FMA rate. At the default problem
// (rank 2, N = 32, V = 2048) the complex products are 2 ranks × N × NP × V
// complex multiply-adds a subgrid, 3.29e12 FLOP over 24,500 subgrids, 49.1
// ms at 67 TFLOP/s; the formation (131,072 exact sincosf and 262,144
// entries of W a subgrid) is about a tenth of that. The parent kernel took
// 113 ms: a thread held 2 × 4 complex outputs of one rank, so a visibility
// cost it 12 shared-memory words for 32 FFMA, the rank loop was outermost
// (Φ formed again per rank) and the formation stalled the products on one
// 512-thread block an SM.
//
// Design: a register-tiled complex outer product. A thread holds a 4 × 4
// tile of outputs (4 y × 4 consecutive (p, x) columns) of two ranks at once,
// 64 accumulators: per visibility it reads 4 Φy and 4 W of each rank with
// 16-byte loads (six LDS.128, 24 words) for 128 FFMA, and Φ is read once
// for both ranks of the default rank 2. The lanes of a warp cover 4 row
// groups × 8 column groups, so Φy loads are 4-address broadcasts. Ranks go
// in pairs (rank 4: two walks over the tiles, the second forming Φ again);
// each pair's products, weighted by n^r, are added into a pixel sum in
// shared memory that the Jones/taper epilogue reads. A tile is 32
// visibilities: the block forms vis·c_r of each visibility, pol and rank
// into a small table, then Φy and W_r = Φx · (vis·c_r) of both ranks (one
// exact sincosf pair an entry, the plain version's operation order) into
// shared memory, while the next tile's visibilities and μ arrive by
// cp.async, then multiplies; three barriers a tile. 256 threads at N = 32
// with up to 128 registers and ~108 KB of shared memory, so two blocks
// share an SM. Warp specialization lost here: with 128 producer threads
// forming the tiles beside 256 consumer threads on one 384-thread block an
// SM, the kernel took 150 ms, where diagnostic builds took 86.6 ms without
// the products (the formation on four warps alone) and 72.5 ms without the
// formation (the FFMA on eight warps alone): the formation is too heavy for
// a quarter of the warps, and eight warps an SM leave the FFMA pipes idle.

#include <cuda_runtime.h>

#include "common.cuh"
#include "separable.cuh"
#include "wgmma.cuh"

namespace {

using idg::kPols;

constexpr int kTile = 32;   // visibilities a tile
constexpr int kRawBytes = kTile * kPols * (int)sizeof(float2) + kTile * (int)sizeof(float);

template <int N>
struct Tile {
  static constexpr int kNP = N * kPols;
  static constexpr int kThreads = N * kNP / 16;   // a 4 × 4 output tile each
  static constexpr int kEnt = kTile * N / kThreads;   // Φ entries a thread forms
  // the pixel sum [N][NP], Φy [kTile][N], W of two ranks [2][kTile][NP],
  // vis·c_r of two ranks [2][kTile][P], raw slots
  static constexpr size_t kPix = (size_t)N * kNP * sizeof(float2);
  static constexpr size_t kPhy = (size_t)kTile * N * sizeof(float2);
  static constexpr size_t kW = (size_t)kTile * kNP * sizeof(float2);
  static constexpr size_t kVc = (size_t)kTile * kPols * sizeof(float2);
  static constexpr size_t kBytes = kPix + kPhy + 2 * kW + 2 * kVc + 2 * (size_t)kRawBytes;
  static_assert(kTile * N % kThreads == 0, "whole entries a thread");
};

// The products of one tile, both ranks (kTwo) or the first alone, into
// this thread's accumulators: rows y0..y0+3, columns c0..c0+3.
template <int N, bool kTwo>
__device__ __forceinline__ void product(const float2* __restrict__ phy,
                                        const float2* __restrict__ w, int y0, int c0,
                                        float2 (&acc)[2][4][4]) {
  constexpr int kNP = N * kPols;
#pragma unroll 2
  for (int kk = 0; kk < kTile; ++kk) {
    const float4* py4 = reinterpret_cast<const float4*>(phy + kk * N + y0);
    const float4 pa = py4[0], pb = py4[1];
    const float2 py[4] = {make_float2(pa.x, pa.y), make_float2(pa.z, pa.w),
                          make_float2(pb.x, pb.y), make_float2(pb.z, pb.w)};
#pragma unroll
    for (int r = 0; r < (kTwo ? 2 : 1); ++r) {
      const float4* w4 = reinterpret_cast<const float4*>(w + (r * kTile + kk) * kNP + c0);
      const float4 wa = w4[0], wb = w4[1];
      const float2 wv[4] = {make_float2(wa.x, wa.y), make_float2(wa.z, wa.w),
                            make_float2(wb.x, wb.y), make_float2(wb.z, wb.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) idg::cmac(acc[r][i][j], py[i], wv[j]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, 2) gridder_sep_v3_kernel(
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
  using TL = Tile<N>;
  constexpr int kNP = TL::kNP;
  constexpr int kThreads = TL::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* s_pix = reinterpret_cast<float2*>(smem);                          // [N][NP]
  float2* s_phy = reinterpret_cast<float2*>(smem + TL::kPix);               // [kTile][N]
  float2* s_w = reinterpret_cast<float2*>(smem + TL::kPix + TL::kPhy);      // [2][kTile][NP]
  float2* s_vc = s_w + 2 * kTile * kNP;                                     // [2][kTile][P]
  unsigned char* raw = reinterpret_cast<unsigned char*>(s_vc + 2 * kTile * kPols);

  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = T * C;
  const int nt = (V + kTile - 1) / kTile;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * V * kPols;
  const float* mu_s = mu + (size_t)s * V;
  const float* pox_s = po_x + (size_t)s * N;
  const float* poy_s = po_y + (size_t)s * N;

  // the thread's output tile: a warp covers 4 row groups × 8 column groups
  constexpr int kColWarps = kNP / 32;
  const int y0 = 4 * ((warp / kColWarps) * 4 + lane / 8);
  const int c0 = 4 * ((warp % kColWarps) * 8 + lane % 8);

  auto stage_raw = [&](int tile, int slot) {
    const int v0 = tile * kTile, nv = min(kTile, V - v0);
    unsigned char* dst = raw + slot * kRawBytes;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(vis_s + (size_t)v0 * kPols);
    for (int e = tid; e < nv * 2; e += kThreads) cp_async16(dst + e * 16, src + e * 16);
    float* dmu = reinterpret_cast<float*>(dst + kTile * kPols * sizeof(float2));
    for (int e = tid; e < nv; e += kThreads) cp_async4(dmu + e, mu_s + v0 + e);
    cp_async_commit();
  };

  // Tile `tile` from raw slot `slot` for ranks r0, r0 + 1 (nr of them):
  // first vis·(iμ)^r/r! of each visibility, pol and rank, then, behind a
  // barrier, Φy and W_r = Φx · (vis·c_r) at the thread's entries (tile row
  // kk, axis index a); zeros past V, by selects (a stale slot may hold
  // anything).
  auto form = [&](int tile, int slot, int r0, int nr) {
    const int v0 = tile * kTile, nv = min(kTile, V - v0);
    const float2* rvis = reinterpret_cast<const float2*>(raw + slot * kRawBytes);
    const float* rmu = reinterpret_cast<const float*>(rvis + kTile * kPols);
    for (int e = tid; e < nr * kTile * kPols; e += kThreads) {
      const int kk = (e / kPols) % kTile;
      const float2 c = taylor_coefficient(rmu[kk], r0 + e / (kTile * kPols));
      const float2 w = cmul(rvis[e % (kTile * kPols)], c);
      s_vc[e] = kk < nv ? w : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < TL::kEnt; ++i) {
      const int e = tid + i * kThreads, kk = e / N, a = e % N;
      const bool live = kk < nv;
      const int v = min(v0 + kk, V - 1), t = v / C, c = v - t * C;
      const float kc = __ldg(k + c);
      float sn, cs;
      sincosf(__ldg(pox_s + a) - __ldg(l + a) * (__ldg(uvw_s + t * 3) * kc), &sn, &cs);
      const float2 phx = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
      sincosf(__ldg(poy_s + a) - __ldg(m + a) * (__ldg(uvw_s + t * 3 + 1) * kc), &sn, &cs);
      s_phy[kk * N + a] = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
      for (int r = 0; r < nr; ++r) {
#pragma unroll
        for (int p = 0; p < kPols; ++p) {
          s_w[(r * kTile + kk) * kNP + p * N + a] =
              cmul(phx, s_vc[(r * kTile + kk) * kPols + p]);
        }
      }
    }
  };

  for (int r0 = 0; r0 < w_rank; r0 += 2) {
    const int nr = min(2, w_rank - r0);
    float2 acc[2][4][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][i][j] = make_float2(0.0f, 0.0f);

    stage_raw(0, 0);
    cp_async_wait_all();
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      form(j, j & 1, r0, nr);
      __syncthreads();
      // the next tile's raw data lands in the other slot during the products
      if (j + 1 < nt) stage_raw(j + 1, (j + 1) & 1);
      if (nr == 2) {
        product<N, true>(s_phy, s_w, y0, c0, acc);
      } else {
        product<N, false>(s_phy, s_w, y0, c0, acc);
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // this pair's products, weighted by n^r, into the pixel sum; each
    // (y, column) belongs to one thread, so no barrier until the epilogue
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int y = y0 + i, col = c0 + jj;
        const float nyx = n[y * N + col % N];
        const float n0 = power(nyx, r0), n1 = n0 * nyx;
        float2 v = make_float2(acc[0][i][jj].x * n0, acc[0][i][jj].y * n0);
        if (nr == 2) v = make_float2(fmaf(acc[1][i][jj].x, n1, v.x), fmaf(acc[1][i][jj].y, n1, v.y));
        float2& dst = s_pix[y * kNP + col];
        dst = r0 == 0 ? v : cadd(dst, v);
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
cudaError_t launch(const float* uvw, const float2* vis, const float* mu, const float* k,
                   const float* po_x, const float* po_y, const float* l, const float* m,
                   const float* n, const float* sph, const float2* aterms,
                   const int* aterm_index, const int* station1, const int* station2,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  using TL = Tile<N>;
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(gridder_sep_v3_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::kBytes);
  if (err != cudaSuccess) return err;
  gridder_sep_v3_kernel<N><<<S, TL::kThreads, TL::kBytes, stream>>>(
      uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

namespace idg {

cudaError_t gridder_sep_v3(const float* uvw, const float2* vis, const float* mu,
                           const float* k, const float* po_x, const float* po_y,
                           const float* l, const float* m, const float* n, const float* sph,
                           const float2* aterms, const int* aterm_index, const int* station1,
                           const int* station2, float2* out, int S, int T, int C, int N,
                           int nr_stations, int w_rank, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<16>(uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                               station1, station2, out, S, T, C, nr_stations, w_rank, stream);
    case 32: return launch<32>(uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                               station1, station2, out, S, T, C, nr_stations, w_rank, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace idg
