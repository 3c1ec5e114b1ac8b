// Merged range grid-add: masked quadrant pieces c64[4S, P, N, N] -> one band
// c64[P, rows·N, G] of the grid, m consecutive blocks per group, before the
// wrap-miss patch.
//
// Replaces idg_tpu/ops/grid.py:_grid_add_ranges_merged_call, the grid-add of
// each stripe of the streamed 16384² path (GridAddMergedPlan, m = 64 there).
// Block-sorted order makes the runs of m adjacent blocks one contiguous span
// per quadrant, so each group g has one window per quadrant,
// [base, base + 2·wm) with base = (gbase[q,g] / wm)·wm. Block c of the group
// sums, per quadrant, the rows of its run [starts[q,c], +lens[q,c]) that lie
// in that window: exactly the rows the TPU kernel's 0/1 selector picked
// (grid.py:827-835). The rows outside it (the periodic-wrap pieces of the
// groups at the row start, GridAddMergedPlan.miss_rows) are added afterwards
// in torch (ops/grid.py:_patch_misses), not here.
//
// What bounds it on an H100: device-memory bytes, as for the per-block
// grid-add (3.2 GB of masked pieces read once at 16384², the band written
// once), and at 16384² the number of groups in flight: a stripe of 16,384
// blocks has 256 groups of 64.
//
// Design: one CUDA block per group with gocc > 0 (a compacted list), which
// writes all m of its blocks; the wrapper zero-fills the band only when some
// group of the stripe is empty (at 16384² none is). The block loops over the
// group's m positions and keeps one position's P·N² sums live at a time, in
// registers, summing each clipped run in row order: deterministic, no
// atomics. The TPU kernel's
// [m, 2·wm] selector matmul was how a Pallas step picked rows out of its two
// window DMAs on the MXU; here the clipped run is a loop bound, so there is
// no selector and no window copy. Offsets are 64-bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) grid_add_merged_kernel(
    const float2* __restrict__ pieces,    // [4S, P, N, N] masked pieces
    const int* __restrict__ starts,       // [4, ncols] run starts (piece rows)
    const int* __restrict__ lens,         // [4, ncols] run lengths
    const int* __restrict__ gbase,        // [4, ng] window anchors
    const int* __restrict__ groups,       // [n_occ] group ids with gocc > 0
    float2* __restrict__ band,            // [P, rows·N, G]
    int ncols, int m, int wm, int nbx, int G) {
  using namespace idg;
  constexpr int kElems = kPols * N * N;
  static_assert(kElems % kThreads == 0, "pixels must split evenly");
  constexpr int kPer = kElems / kThreads;

  const int g = groups[blockIdx.x];
  const int ng = ncols / m;
  const int tid = threadIdx.x;
  const long long band_rows = (long long)(ncols / nbx) * N;

#pragma unroll 1
  for (int jm = 0; jm < m; ++jm) {
    const int c = g * m + jm;
    float2 acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = make_float2(0.0f, 0.0f);
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const long long base = (long long)(gbase[q * ng + g] / wm) * wm;
      const long long r0 = starts[q * ncols + c];
      const long long r1 = r0 + lens[q * ncols + c];
      const long long a = r0 > base ? r0 : base;
      const long long b = r1 < base + 2 * wm ? r1 : base + 2 * wm;
      for (long long r = a; r < b; ++r) {
        const float2* src = pieces + r * kElems;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float2 v = src[tid + k * kThreads];
          acc[k].x += v.x;
          acc[k].y += v.y;
        }
      }
    }
    const int by = c / nbx, bx = c % nbx;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      const int p = e / (N * N), i = (e / N) % N, j = e % N;
      band[((long long)p * band_rows + by * N + i) * G + bx * N + j] = acc[k];
    }
  }
}

template <int N>
cudaError_t launch(const float2* pieces, const int* starts, const int* lens, const int* gbase,
                   const int* groups, float2* band, int n_occ, int ncols, int m, int wm,
                   int nbx, int G, cudaStream_t stream) {
  grid_add_merged_kernel<N><<<n_occ, kThreads, 0, stream>>>(pieces, starts, lens, gbase,
                                                            groups, band, ncols, m, wm, nbx, G);
  return cudaGetLastError();
}

}  // namespace

// ncols = rows·nbx columns of the stripe's tables, ncols / m groups, n_occ of
// them listed; m divides nbx.
extern "C" int idg_grid_add_merged(const void* pieces, const void* starts, const void* lens,
                                   const void* gbase, const void* groups, void* band, int n_occ,
                                   int ncols, int m, int wm, int nbx, int G, int N,
                                   void* stream) {
  if (n_occ <= 0 || m < 2 || wm <= 0 || nbx <= 0 || nbx % m || ncols % nbx ||
      n_occ > ncols / m || G != nbx * N) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pieces);
  const auto* s = static_cast<const int*>(starts);
  const auto* l = static_cast<const int*>(lens);
  const auto* gb = static_cast<const int*>(gbase);
  const auto* gr = static_cast<const int*>(groups);
  auto* b = static_cast<float2*>(band);
  switch (N) {
    case 16: return (int)launch<16>(p, s, l, gb, gr, b, n_occ, ncols, m, wm, nbx, G, st);
    case 32: return (int)launch<32>(p, s, l, gb, gr, b, n_occ, ncols, m, wm, nbx, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
