// Piece range grid-add: masked quadrant pieces c64[4S, P, N, N] -> one band
// c64[P, rows·N, G] of the grid (the whole grid when rows = G/N).
//
// Replaces idg_tpu/ops/grid.py:_grid_add_ranges_call (launcher
// _grid_add_ranges), the grid-add of the no-FFT path and of each stripe of
// the streamed 16384² path with merging off (the JAX package also takes it
// for sparse plans with the FFT; the port takes K4 there, csrc/grid_add.cu).
// With the subgrids sorted by home
// block, the pieces that add into grid block b from quadrant q are one
// contiguous run [starts[q,b], starts[q,b] + lens[q,b]) of the piece array
// (plan_grid_add_ranges, q·S folded in). The pieces are masked already
// (ops/grid.py:_mask_pieces), so a block's sum is the plain sum of its four
// runs.
//
// What bounds it on an H100: device-memory bytes. Every masked piece is read
// once by the one block it belongs to (920 MB at LOFAR-4096, 3.2 GB at the
// default problem without the FFT), and each occupied block is written once.
//
// Design: one CUDA block per occupied grid block, from a compacted list of
// the blocks with any run (GridAddRangePlan.stripe_tables), so the 18% of
// empty blocks at LOFAR-4096 (69% at 16384²) cost no block at all; the
// wrapper zero-fills the band beforehand (P·rows·N·G·8 bytes of memset)
// unless every block is occupied. The TPU kernel stepped over every block,
// and its per-step cost did not depend on occupancy. 256 threads walk the
// P·N² pixels in (p, i, j) order, so a warp reads and writes whole rows; the
// sum is kept in registers in run order: deterministic, no atomics, no mask.
// The TPU kernel's two W-row windows per quadrant, its window padding and
// the optimization_barrier fan-out were devices of Pallas's block-granular
// DMA; here the block reads exactly its runs. Offsets are 64-bit: a 16384²
// grid holds 1.07e9 complex values.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) grid_add_pieces_kernel(
    const float2* __restrict__ pieces,    // [4S, P, N, N] masked pieces
    const int* __restrict__ starts,       // [4, ncols] run starts (piece rows)
    const int* __restrict__ lens,         // [4, ncols] run lengths
    const int* __restrict__ occupied,     // [n_occ] column ids with any run
    float2* __restrict__ band,            // [P, rows·N, G]
    int ncols, int nbx, int G) {
  using namespace idg;
  constexpr int kElems = kPols * N * N;
  static_assert(kElems % kThreads == 0, "pixels must split evenly");
  constexpr int kPer = kElems / kThreads;

  const int c = occupied[blockIdx.x];
  const int tid = threadIdx.x;
  float2 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float2(0.0f, 0.0f);

#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const long long r0 = starts[q * ncols + c];
    const long long r1 = r0 + lens[q * ncols + c];
    for (long long r = r0; r < r1; ++r) {
      const float2* src = pieces + r * kElems;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float2 v = src[tid + k * kThreads];
        acc[k].x += v.x;
        acc[k].y += v.y;
      }
    }
  }

  const long long band_rows = (long long)(ncols / nbx) * N;
  const int by = c / nbx, bx = c % nbx;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int p = e / (N * N), i = (e / N) % N, j = e % N;
    band[((long long)p * band_rows + by * N + i) * G + bx * N + j] = acc[k];
  }
}

template <int N>
cudaError_t launch(const float2* pieces, const int* starts, const int* lens,
                   const int* occupied, float2* band, int n_occ, int ncols, int nbx, int G,
                   cudaStream_t stream) {
  grid_add_pieces_kernel<N><<<n_occ, kThreads, 0, stream>>>(pieces, starts, lens, occupied,
                                                            band, ncols, nbx, G);
  return cudaGetLastError();
}

}  // namespace

// ncols = rows·nbx columns of the stripe's tables; n_occ of them are listed.
extern "C" int idg_grid_add_pieces(const void* pieces, const void* starts, const void* lens,
                                   const void* occupied, void* band, int n_occ, int ncols,
                                   int nbx, int G, int N, void* stream) {
  if (n_occ <= 0 || n_occ > ncols || nbx <= 0 || ncols % nbx || G != nbx * N) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pieces);
  const auto* s = static_cast<const int*>(starts);
  const auto* l = static_cast<const int*>(lens);
  const auto* o = static_cast<const int*>(occupied);
  auto* b = static_cast<float2*>(band);
  switch (N) {
    case 16: return (int)launch<16>(p, s, l, o, b, n_occ, ncols, nbx, G, st);
    case 32: return (int)launch<32>(p, s, l, o, b, n_occ, ncols, nbx, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
