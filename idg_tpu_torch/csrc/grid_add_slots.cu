// Slot-plan grid-adds: quadrant pieces c64[4S, P, N, N] -> grid c64[P, G, G],
// routed by the host slot plan (ops/grid.py:plan_grid_add), in the two
// formulations of ops/grid.py:subgrids_to_grid_pallas.
//
// K11a, the piece scatter (mode "vmem"), replaces
// idg_tpu/ops/grid.py:_grid_add_vmem_scatter. The TPU kernel kept the whole
// block array resident in VMEM and streamed the pieces through it, adding
// each into its destination block (piece_blocks) by a dynamic read-modify-
// write. Here the pieces stream contiguously, one thread per pixel, and each
// non-zero pixel is added at its place in the zero-filled [P, G, G] grid
// (the wrapper's memset) with two float atomics. At 1024², the problem the
// JAX dispatch sends here, the 33.5 MB grid fits the H100's 50 MB L2, the
// counterpart of the VMEM-resident grid, so the atomics resolve in L2. What
// bounds it: reading the 3.2 GB of pieces, and the L2 atomics, one pair per
// non-zero pixel (a quarter of the pixels: the quadrant masks zero the
// rest, and adding a zero changes no sum). The order of the sums changes
// from run to run.
//
// K11b, the slot gather (mode "gather"), replaces the kernel of
// idg_tpu/ops/grid.py:subgrids_to_grid_pallas (body :2114-2130), which the
// JAX dispatch takes when the block array does not fit VMEM (LOFAR-4096).
// The TPU kernel gathered each block's slot rows through data-dependent
// BlockSpec index maps, 8 rows per grid step, masking the sentinel. Here one
// CUDA block per grid block walks its `cap` slots, skips the sentinel 4S,
// and sums the rows in slot order in registers: deterministic, no atomics,
// stored straight into [P, G, G]. What bounds it: device-memory bytes, each
// piece read once (920 MB at LOFAR-4096) and the grid written once.
// Offsets are 64-bit in both.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) grid_add_scatter_kernel(
    const float2* __restrict__ pieces,       // [M, P, N, N] quadrant pieces
    const int* __restrict__ piece_blocks,    // [M] destination block
    float* __restrict__ grid,                // [P, G, G] float pairs, zero-filled
    long long total, int nbx, int G) {
  using namespace idg;
  constexpr int kElems = kPols * N * N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const float2 v = pieces[e];
  if (v.x == 0.0f && v.y == 0.0f) return;
  const long long t = e / kElems;
  const int r = (int)(e - t * kElems);
  const int p = r / (N * N), i = (r / N) % N, j = r % N;
  const int b = piece_blocks[t];
  const int by = b / nbx, bx = b % nbx;
  const long long dst = ((long long)p * G + by * N + i) * G + bx * N + j;
  atomicAdd(grid + 2 * dst, v.x);
  atomicAdd(grid + 2 * dst + 1, v.y);
}

template <int N>
__global__ void __launch_bounds__(kThreads) grid_add_slots_kernel(
    const float2* __restrict__ pieces,    // [M, P, N, N] quadrant pieces
    const int* __restrict__ slots,        // [nbp, cap] piece ids, sentinel M
    float2* __restrict__ grid,            // [P, G, G]
    int cap, int m, int nbx, int G) {
  using namespace idg;
  constexpr int kElems = kPols * N * N;
  static_assert(kElems % kThreads == 0, "pixels must split evenly");
  constexpr int kPer = kElems / kThreads;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float2 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float2(0.0f, 0.0f);

  const int* row = slots + (long long)b * cap;
  for (int k = 0; k < cap; ++k) {
    const int t = row[k];
    if (t >= m) continue;
    const float2* src = pieces + (long long)t * kElems;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float2 v = src[tid + u * kThreads];
      acc[u].x += v.x;
      acc[u].y += v.y;
    }
  }

  const int by = b / nbx, bx = b % nbx;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int p = e / (N * N), i = (e / N) % N, j = e % N;
    grid[((long long)p * G + by * N + i) * G + bx * N + j] = acc[k];
  }
}

template <int N>
cudaError_t launch_scatter(const float2* pieces, const int* piece_blocks, float* grid, int m,
                           int nbx, int G, cudaStream_t stream) {
  const long long total = (long long)m * idg::kPols * N * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  grid_add_scatter_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      pieces, piece_blocks, grid, total, nbx, G);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_slots(const float2* pieces, const int* slots, float2* grid, int nb, int cap,
                         int m, int nbx, int G, cudaStream_t stream) {
  grid_add_slots_kernel<N><<<nb, kThreads, 0, stream>>>(pieces, slots, grid, cap, m, nbx, G);
  return cudaGetLastError();
}

}  // namespace

// m = 4S pieces; the grid is zero-filled by the caller.
extern "C" int idg_grid_add_scatter(const void* pieces, const void* piece_blocks, void* grid,
                                    int m, int nbx, int G, int N, void* stream) {
  if (m <= 0 || nbx <= 0 || G != nbx * N) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pieces);
  const auto* pb = static_cast<const int*>(piece_blocks);
  auto* g = static_cast<float*>(grid);
  switch (N) {
    case 16: return (int)launch_scatter<16>(p, pb, g, m, nbx, G, st);
    case 32: return (int)launch_scatter<32>(p, pb, g, m, nbx, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// nb = (G/N)² blocks are written; the slot table has at least nb rows of cap.
extern "C" int idg_grid_add_slots(const void* pieces, const void* slots, void* grid, int nb,
                                  int cap, int m, int nbx, int G, int N, void* stream) {
  if (nb <= 0 || cap <= 0 || m < 0 || nbx <= 0 || G != nbx * N || nb != nbx * nbx) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pieces);
  const auto* s = static_cast<const int*>(slots);
  auto* g = static_cast<float2*>(grid);
  switch (N) {
    case 16: return (int)launch_slots<16>(p, s, g, nb, cap, m, nbx, G, st);
    case 32: return (int)launch_slots<32>(p, s, g, nb, cap, m, nbx, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
