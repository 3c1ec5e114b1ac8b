// Range extraction: grid c64[P, G, G] -> block-rolled pieces c64[S, P, N, N].
//
// Replaces idg_tpu/ops/grid.py:_grid_extract_ranges (grid_to_subgrids_ranges
// with pieces=True) and its layout step _grid_to_blocks_padded. It computes
// the gather adjoint of the range grid-add (grid_add.cu):
//   piece[s,p,i,j] = grid[p, ((by + (i < oy))·N + i) % G, ((bx + (j < ox))·N + j) % G]
// with (by, bx) = (cy / N, cx / N) the home block and (oy, ox) = (cy % N,
// cx % N), cy = coord_y[s] mod G, cx = coord_x[s] mod G: the subgrid's N×N
// window at (cy, cx), rolled by (oy, ox), with periodic wrap.
//
// What bounds it on an H100: device-memory bytes written, 803 MB of pieces
// at the default problem. The grid (33.5 MB) is read about 24 times over but
// fits in the 50 MB L2.
//
// Design: one CUDA block per subgrid, 256 threads over the P·N² pixels in
// (p, i, j) order, so a warp writes a whole row and reads at most two grid
// row segments. Each block computes its own indices from its coordinate;
// nothing is sorted or planned. The TPU kernel's periodic-padded block copy
// of the grid (_grid_to_blocks_padded) and its chunk plan (qb0, tmeta,
// k_span, wc of plan_grid_extract_ranges) fed Pallas's block-granular
// window DMA; a direct wrapped read needs neither.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) grid_extract_kernel(
    const float2* __restrict__ grid,     // [P, G, G]
    const int* __restrict__ coord_x,     // [S]
    const int* __restrict__ coord_y,     // [S]
    float2* __restrict__ pieces,         // [S, P, N, N]
    int G) {
  using namespace idg;
  constexpr int kElems = kPols * N * N;
  const int s = blockIdx.x;
  const int cy = ((coord_y[s] % G) + G) % G;
  const int cx = ((coord_x[s] % G) + G) % G;
  const int by = cy / N, bx = cx / N, oy = cy % N, ox = cx % N;
  float2* dst = pieces + (size_t)s * kElems;
  for (int e = threadIdx.x; e < kElems; e += kThreads) {
    const int p = e / (N * N), i = (e / N) % N, j = e % N;
    const int row = ((by + (i < oy)) * N + i) % G;
    const int col = ((bx + (j < ox)) * N + j) % G;
    dst[e] = grid[((size_t)p * G + row) * G + col];
  }
}

template <int N>
cudaError_t launch(const float2* grid, const int* coord_x, const int* coord_y,
                   float2* pieces, int S, int G, cudaStream_t stream) {
  grid_extract_kernel<N><<<S, kThreads, 0, stream>>>(grid, coord_x, coord_y, pieces, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_grid_extract(const void* grid, const void* coord_x, const void* coord_y,
                                void* pieces, int S, int G, int N, void* stream) {
  if (S <= 0 || N <= 0 || G <= 0 || G % N != 0) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float2*>(grid);
  const auto* x = static_cast<const int*>(coord_x);
  const auto* y = static_cast<const int*>(coord_y);
  auto* out = static_cast<float2*>(pieces);
  switch (N) {
    case 16: return (int)launch<16>(g, x, y, out, S, G, st);
    case 32: return (int)launch<32>(g, x, y, out, S, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
