// Range grid-add: block-rolled pieces c64[S, P, N, N] -> grid c64[P, G, G].
//
// Replaces idg_tpu/ops/grid.py:_grid_add_ranges_tiles_call (the tile path of
// subgrids_to_grid_ranges) and its layout step _blocks_to_grid. With the
// subgrids sorted by home block (ops/grid.py:block_sort_order), the pieces
// that add into grid block b from quadrant q = (qy, qx) are one contiguous
// run [tstarts[q,b], tstarts[q,b] + lens[q,b]) (plan_grid_add_ranges). For
// every N×N grid block b and quadrant q, the kernel sums its run, keeping
// pixel (i, j) of a piece only where (i >= oy) == (qy == 0) and
// (j >= ox) == (qx == 0), with (oy, ox) = oyx[s]: each pixel of a piece lands
// in exactly one of the four blocks its subgrid straddles. Empty blocks are
// written as zeros.
//
// What bounds it on an H100: device-memory bytes. Each piece pixel is read
// once, by the block its quadrant mask sends it to (803 MB at the default
// problem), and the grid is written once (33.5 MB); a handful of integer ops
// per 8-byte load.
//
// Design: one CUDA block per grid block, 256 threads over the P·N² pixels in
// (p, i, j) order, so a warp reads and writes whole rows. The sum is kept in
// registers in run order: deterministic, no atomics, no cross-block
// reduction. Loads are predicated on the mask, so a masked-out sector is
// never fetched. The result is stored straight into [P, G, G] (the block's
// rows at (by·N + i, bx·N + j)), which makes _blocks_to_grid an index. The
// TPU kernel's two W-row windows per quadrant, its window padding
// (tile_pad_rows) and the optimization_barrier fan-out were devices of
// Pallas's block-granular DMA; here the block reads exactly its runs. The
// longest run (plan.w) bounds the slowest block.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) grid_add_kernel(
    const float2* __restrict__ pieces,   // [S, P, N, N] block-rolled pieces
    const int* __restrict__ oyx,         // [S, 2]
    const int* __restrict__ tstarts,     // [4, nbp] run starts
    const int* __restrict__ lens,        // [4, nbp] run lengths
    float2* __restrict__ grid,           // [P, G, G]
    int nbp, int nbx, int G) {
  using namespace idg;
  constexpr int kElems = kPols * N * N;
  static_assert(kElems % kThreads == 0, "pixels must split evenly");
  constexpr int kPer = kElems / kThreads;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float2 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float2(0.0f, 0.0f);

#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const bool lo_y = (q >> 1) == 0, lo_x = (q & 1) == 0;
    const int t0 = tstarts[q * nbp + b];
    const int t1 = t0 + lens[q * nbp + b];
    for (int t = t0; t < t1; ++t) {
      const int oy = oyx[2 * t], ox = oyx[2 * t + 1];
      const float2* src = pieces + (size_t)t * kElems;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + k * kThreads;
        const int i = (e / N) % N, j = e % N;
        if ((i >= oy) == lo_y && (j >= ox) == lo_x) {
          const float2 v = src[e];
          acc[k].x += v.x;
          acc[k].y += v.y;
        }
      }
    }
  }

  const int by = b / nbx, bx = b % nbx;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int p = e / (N * N), i = (e / N) % N, j = e % N;
    grid[((size_t)p * G + by * N + i) * G + bx * N + j] = acc[k];
  }
}

template <int N>
cudaError_t launch(const float2* pieces, const int* oyx, const int* tstarts,
                   const int* lens, float2* grid, int nb, int nbp, int nbx, int G,
                   cudaStream_t stream) {
  grid_add_kernel<N><<<nb, kThreads, 0, stream>>>(pieces, oyx, tstarts, lens, grid, nbp,
                                                  nbx, G);
  return cudaGetLastError();
}

}  // namespace

// nb = (G/N)² grid blocks are written; the plan tables are [4, nbp], nbp ≥ nb.
extern "C" int idg_grid_add(const void* pieces, const void* oyx, const void* tstarts,
                            const void* lens, void* grid, int nb, int nbp, int nbx, int G,
                            int N, void* stream) {
  if (nb <= 0 || nbp < nb || nbx <= 0 || G != nbx * N || nb != nbx * nbx) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pieces);
  const auto* o = static_cast<const int*>(oyx);
  const auto* ts = static_cast<const int*>(tstarts);
  const auto* ln = static_cast<const int*>(lens);
  auto* g = static_cast<float2*>(grid);
  switch (N) {
    case 16: return (int)launch<16>(p, o, ts, ln, g, nb, nbp, nbx, G, st);
    case 32: return (int)launch<32>(p, o, ts, ln, g, nb, nbp, nbx, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
