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
// problem, 230 MB on LOFAR-4096), and the grid is written once (33.6 MB,
// 537 MB); a handful of integer ops a 16-byte load.
//
// Design. The earlier kernel, one CUDA block of 256 threads per grid block
// with 8-byte loads and one piece's loads in flight, used 128 registers, ran
// two blocks an SM and reached 35% of the bound. Here:
// - one CUDA block of 128 threads per (grid block, pol), in block order:
//   4,096 at the default problem, eight resident an SM (at most 64
//   registers a thread). Neighbouring blocks, which split the same pieces'
//   rows and write their rows side by side, run together (heaviest block
//   first measured 1% faster at the default problem, 8% slower on the
//   LOFAR-4096 pieces and 3% slower at N = 16);
// - the block's four runs come in one 32-byte row of the plan's table
//   (block_runs), and its entries, each with its roll, piece and quadrant,
//   are staged once in shared memory, kChunk at a time, so a block starts
//   after two trips and no device-memory load stands between two pieces;
// - a thread holds pixel pairs (float4) of rows tid/(N/2) + k·(128/(N/2)),
//   a half-warp one whole row of a pol plane: 16-byte loads, a row that its
//   quadrant masks out is not loaded, and the pair that an odd ox splits is
//   loaded once and selected;
// - kInFlight loads a thread are issued before their adds (kInFlight/kPer
//   pieces a step), at most 64 registers so that eight blocks share an SM;
// - each output pixel is summed in run order, quadrant by quadrant, in
//   registers: deterministic, no atomics, no cross-block reduction, and the
//   same order as before; the sum is stored once (streaming stores)
//   straight into [P, G, G], zeros for an empty block.
// The TPU kernel's W-row windows, window padding and fan-out were devices of
// Pallas's block-granular DMA; here a block reads exactly its runs.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;     // blocks an SM: at most 64 registers a thread
constexpr int kChunk = 256;       // run entries staged in shared memory at a time
// 16-byte loads a thread issues before their adds: two pieces a step at
// N = 32, four at N = 16 (eight spill under the 64-register cap there)
template <int N>
constexpr int kInFlight = N == 32 ? 8 : 4;

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks) grid_add_kernel(
    const float4* __restrict__ pieces,   // [S, P, N, N/2] pixel pairs
    const int2* __restrict__ oyx,        // [S] (oy, ox)
    const int4* __restrict__ runs,       // [nb, 2]: the four run starts, the four lengths
    float4* __restrict__ grid,           // [P, G, G/2]
    int nbx, int G) {
  using namespace idg;
  constexpr int kRow = N / 2;                  // pixel pairs a row
  constexpr int kPlane = N * kRow;             // pixel pairs a pol plane
  constexpr int kPer = kPlane / kThreads;      // pixel pairs a thread
  constexpr int kRowStep = kThreads / kRow;    // rows between a thread's pairs
  constexpr int kUnroll = kInFlight<N> / kPer;    // pieces a step
  static_assert(kPlane % kThreads == 0 && kInFlight<N> % kPer == 0, "pairs must split evenly");
  __shared__ int2 entry[kChunk];   // (piece, oy | ox << 8 | q << 16)

  const int b = blockIdx.x / kPols, p = blockIdx.x % kPols;
  const int4 start = runs[2 * b], len = runs[2 * b + 1];
  // quadrant q's entries start at eq; the block has `total`
  const int e1 = len.x, e2 = e1 + len.y, e3 = e2 + len.z, total = e3 + len.w;
  const int tid = threadIdx.x;
  const int r0 = tid / kRow, j0 = 2 * (tid % kRow);

  float4 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int c0 = 0; c0 < total; c0 += kChunk) {
    const int m = min(kChunk, total - c0);
    if (c0) __syncthreads();   // the previous chunk is consumed
    for (int x = tid; x < m; x += kThreads) {
      const int e = c0 + x;
      const int q = (e >= e1) + (e >= e2) + (e >= e3);
      const int t = e + (q == 0   ? start.x
                         : q == 1 ? start.y - e1
                         : q == 2 ? start.z - e2
                                  : start.w - e3);
      const int2 o = oyx[t];
      entry[x] = make_int2(t, o.x | (o.y << 8) | (q << 16));
    }
    __syncthreads();
    for (int x = 0; x < m; x += kUnroll) {
      float4 v[kUnroll][kPer];
      bool keep_lo[kUnroll], keep_hi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool valid = x + u < m;
        const int2 en = entry[valid ? x + u : 0];
        const int oy = en.y & 0xff, ox = (en.y >> 8) & 0xff, q = en.y >> 16;
        const bool top = q < 2, left = (q & 1) == 0;
        keep_lo[u] = valid && (j0 >= ox) == left;
        keep_hi[u] = valid && (j0 + 1 >= ox) == left;
        const float4* src = pieces + ((size_t)en.x * kPols + p) * kPlane + tid;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          v[u][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if ((keep_lo[u] || keep_hi[u]) && (r0 + k * kRowStep >= oy) == top) {
            v[u][k] = __ldg(src + k * kThreads);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (keep_lo[u]) {
            acc[k].x += v[u][k].x;
            acc[k].y += v[u][k].y;
          }
          if (keep_hi[u]) {
            acc[k].z += v[u][k].z;
            acc[k].w += v[u][k].w;
          }
        }
      }
    }
  }

  const int by = b / nbx, bx = b % nbx;
  const size_t pitch = G / 2;
  float4* dst = grid + ((size_t)p * G + (size_t)by * N + r0) * pitch + bx * kRow + j0 / 2;
#pragma unroll
  for (int k = 0; k < kPer; ++k) __stcs(dst + k * kRowStep * pitch, acc[k]);
}

template <int N>
cudaError_t launch(const float4* pieces, const int2* oyx, const int4* runs, float4* grid,
                   int nb, int nbx, int G, cudaStream_t stream) {
  grid_add_kernel<N><<<nb * idg::kPols, kThreads, 0, stream>>>(pieces, oyx, runs, grid, nbx, G);
  return cudaGetLastError();
}

}  // namespace

// nb = (G/N)² grid blocks are written, each once; runs is the plan's
// i32[nb, 8] table (ops/grid.py:GridAddRangePlan.block_runs).
extern "C" int idg_grid_add(const void* pieces, const void* oyx, const void* runs, void* grid,
                            int nb, int nbx, int G, int N, void* stream) {
  if (nb <= 0 || nbx <= 0 || G != nbx * N || nb != nbx * nbx) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float4*>(pieces);
  const auto* o = static_cast<const int2*>(oyx);
  const auto* r = static_cast<const int4*>(runs);
  auto* g = static_cast<float4*>(grid);
  switch (N) {
    case 16: return (int)launch<16>(p, o, r, g, nb, nbx, G, st);
    case 32: return (int)launch<32>(p, o, r, g, nb, nbx, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks an SM of the N instance (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int idg_grid_add_occupancy(int N, void* blocks) {
  auto* out = static_cast<int*>(blocks);
  switch (N) {
    case 16:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, grid_add_kernel<16>,
                                                                kThreads, 0);
    case 32:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, grid_add_kernel<32>,
                                                                kThreads, 0);
    default: return (int)cudaErrorInvalidValue;
  }
}
