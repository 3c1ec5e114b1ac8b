// K9d, degridder cuda_v6: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P], the pol-stacked x-first product in split bf16 on the
// tensor cores (`wgmma`), Φ by the channel recurrence.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_polstack (launcher
// _degridder_polstack_one behind _chunked, :821; registered as pallas_v6
// with degridder_precisions). Per subgrid and Taylor rank r, as the plain
// version (ops/cuda/degridder_polstack.py:degridder_polstack_plain) takes it:
//   B = A1·(sph·P)·A2ᴴ                                          (prologue)
//   lhs_r [4N × 2N] = [B_re·n^r | B_im·n^r], rows (p, y)          (pol-stacked)
//   D_r = lhs_r · [[Φx_re, −Φx_im], [Φx_im, Φx_re]]              (the product)
//   vis[v,p] += conj((iμ_v)^r / r!) · Σ_y conj(Φy[v,y]) · D_r,p[y,v]   (stage 2)
// The product takes the plain version's split operands, hi = bf16(x),
// lo = bf16(x − hi) (round to nearest even): "3x2k", all four products with
// lo·lo, for rank 0 and for every rank of an escalated rank, hi·hi alone for
// rank 1 at rank ≤ 2 (ops/precision.py:degridder_precisions). Φx and Φy
// come from the channel recurrence (separable.cuh:phasor<true>: one complex
// multiply a channel, an exact restart from k0 + c·Δk at every c % 16 == 0,
// c > 0; uniform channel spacing assumed, the guard falls back to cuda_v4).
// The output is written as [S, T, C, P] directly.
//
// What bounds it on an H100: the products, 2·4N·2N·64 FLOP a 32-visibility
// tile and pass (5 bf16 passes at the default rank 2: 8.3 ms over the
// default problem at 989 TFLOP/s); around them, on the CUDA cores, the
// recurrence (8 complex multiplies a producer a tile) and stage 2 (~1 M FMA
// a subgrid). The reference's operation model over the bf16 peak gives
// 1.799 ms. Its parent (bf16 mma.sync, 256 threads a subgrid) took 31.1 ms:
// every fragment came by a shared-memory load, and the formation, the
// products and stage 2 ran on the same 8 warps between two barriers a tile.
//
// Design (the degridder K2's, csrc/degridder.cu, in split bf16, with the
// recurrence of K9c, degridder_sep_bf16.cu):
//  - lhs_r is the 64-row wgmma operand: 128 rows at N = 32 (two consumer
//    warpgroups, two pols each), 64 at N = 16 (one). It is formed and split
//    once a subgrid (and rank group), in a prologue, and read by every tile.
//    A tile of 32 visibilities is the 64-column rhs (the real column
//    [Φx_re; Φx_im] of each visibility, then its imaginary column
//    [−Φx_im; Φx_re]), K = 2N, formed once a tile for every rank. wgmma
//    reads B from shared memory, so mma.sync's half-swap of the real column
//    has no counterpart: both columns are stored.
//  - bf16 wgmma m64n64k16 into float32; a "3x2k" k16 step takes lo·lo,
//    lo·hi, hi·lo, then hi·hi (small products first, as the parent did).
//  - Tiles of 32 timesteps of one channel, the t-tiles outer and the
//    channels inner (separable.cuh:tile_span), so that a producer's
//    recurrence carries from one channel to the next.
//  - Stage 2 on the accumulators, as K2: a thread holds D_re and D_im of two
//    rows (p, y), (p, y + 8) at 8 visibilities; the ranks are summed first
//    (common.cuh:rotate_scale, conj(c_r) = (−i)^r·μ^r/r!), Φy multiplies the
//    rank sum once a tile, a butterfly over the 8 lanes of a column group
//    sums the warp's 16 rows, and the warps of a pol (two at N = 32) meet in
//    shared memory, where the producers add them and store the tile's
//    [32, P] outputs. Only the wgmma's own sum over 2N truncates.
//  - Warp specialization: the consumer warpgroups issue the products and run
//    stage 2; 8N producer threads (256 at N = 32, 128 at N = 16) form the
//    next tile. A producer owns one visibility and 4 x and 4 y: Φx and Φy
//    there by the recurrence, the state cur and step of its 8 entries in
//    shared memory (separable.cuh:phasors_shared, the 8 state reads issued
//    together), Φx's split stored 8 bytes at a time with a warp's lanes on
//    8 rows × both halves of a 16-byte chunk (no bank conflicts), Φy into a
//    padded [v][y] table that stage 2 reads without conflicts. The roles come
//    through a warp shuffle (C7520); the recurrence's cases branch on the
//    channel, the same for the whole block. A ragged tile's dead visibility
//    steps too, on the last timestep's coordinates: its Φ is finite, its μ
//    0 and its outputs are never stored. One barrier a tile.
//  - Shared memory: the lhs is 16 KB a rank and split half at N = 32 (4 KB
//    at N = 16), a stage 25 KB (13 KB), the recurrence's state 32 KB
//    (16 KB). Up to rank 2 the lhs (hi of each rank, lo of rank 0) sits
//    beside both stages; above it each rank takes hi and lo, four ranks a
//    group at N = 32 (every rank at N = 16); at rank 5 and 6 the second
//    group forms its lhs and walks every tile again from channel 0, adding
//    its visibilities to the first group's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "separable.cuh"
#include "wgmma.cuh"

namespace {

using idg::kPols;

constexpr int kVT = 32;             // visibilities a tile: timesteps of one channel
constexpr int kCols = 2 * kVT;      // rhs columns: the real column of each visibility, then the imaginary
constexpr uint32_t kLBO = 128;      // the next K chunk's core matrix

template <int N>
struct Tile {
  static constexpr int kK = 2 * N;                  // contraction: x (re) | x (im)
  static constexpr int kKC = kK / 8;                // 8-wide K chunks of an operand row
  static constexpr uint32_t kSBO = kKC * 128;       // the next 8-row group's core matrices
  static constexpr int kRows = kPols * N;           // lhs rows (p, y)
  static constexpr int kGroups = kRows / 64;        // consumer warpgroups, one 64-row slab each
  static constexpr int kConsumers = 128 * kGroups;  // the products and stage 2
  static constexpr int kConsWarps = kConsumers / 32;
  static constexpr int kProducers = kVT * N / 4;    // the formation: one (visibility, 4 x, 4 y) each
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMinBlocks = N == 16 ? 2 : 1;
  static constexpr int kLdPhy = N + 2;              // Φy row stride (float2): conflict-free stage 2
  static constexpr size_t kBytesL = (size_t)kRows * kK * 2;   // one rank's lhs, hi or lo
  static constexpr size_t kBytesR = (size_t)kCols * kK * 2;   // a tile's rhs, hi or lo
  static constexpr size_t kBytesPhy = (size_t)kVT * kLdPhy * sizeof(float2);
  // a stage: rhs hi, rhs lo, Φy [kVT][kLdPhy], μ [kVT]
  static constexpr size_t kStage = 2 * kBytesR + kBytesPhy + kVT * sizeof(float);
  // the warps' stage-2 sums, two tiles: [2][kConsWarps][kVT]
  static constexpr size_t kBytesRed = 2 * (size_t)kConsWarps * kVT * sizeof(float2);
  // the recurrence's state: (cur, step) of a producer's 8 entries
  static constexpr size_t kBytesState = (size_t)8 * kProducers * sizeof(float4);
  // everything but the lhs
  static constexpr size_t kFixed = 2 * kStage + kBytesRed + kBytesState;
  static_assert(kStage % 128 == 0 && kBytesR % 128 == 0 && kBytesPhy % 128 == 0 &&
                    kBytesL % 128 == 0, "regions stay 128-byte aligned");
  static_assert(kProducers >= kVT * kPols, "one producer a tile output");
};

// One k16 step of a "3x2k" product into d: lo·lo, lo·hi, hi·lo, then hi·hi;
// `first` overwrites d.
template <int K>
__device__ __forceinline__ void mma_bf16_step4(float (&d)[K], bool first, uint64_t a_hi,
                                               uint64_t a_lo, uint64_t b_hi, uint64_t b_lo) {
  idg::wgmma_bf16(d, a_lo, b_lo, first ? 0 : 1);
  idg::wgmma_bf16(d, a_lo, b_hi, 1);
  idg::wgmma_bf16(d, a_hi, b_lo, 1);
  idg::wgmma_bf16(d, a_hi, b_hi, 1);
}

// One rank's products over one tile, this warpgroup's slab of the lhs in
// slot `slot` (its lo in slot group + slot) against the stage's rhs, into
// acc ("3x2k", or hi·hi alone), inside the caller's commit group.
template <int N, bool kFour>
__device__ __forceinline__ void mma_rank(const unsigned char* lhs, const unsigned char* stage,
                                         int wg, int slot, int group, float (&acc)[32]) {
  using TL = Tile<N>;
  const unsigned char* a_hi = lhs + (size_t)slot * TL::kBytesL + wg * 8 * TL::kSBO;
  const unsigned char* a_lo = a_hi + (size_t)group * TL::kBytesL;
#pragma unroll
  for (int ks = 0; ks < TL::kK / 16; ++ks) {
    const int off = ks * 2 * 128;   // two K chunks a k16 step
    const uint64_t ah = idg::smem_desc(a_hi + off, kLBO, TL::kSBO);
    const uint64_t bh = idg::smem_desc(stage + off, kLBO, TL::kSBO);
    if constexpr (kFour) {
      mma_bf16_step4(acc, ks == 0, ah, idg::smem_desc(a_lo + off, kLBO, TL::kSBO), bh,
                     idg::smem_desc(stage + TL::kBytesR + off, kLBO, TL::kSBO));
    } else {
      idg::wgmma_bf16(acc, ah, bh, ks == 0 ? 0 : 1);
    }
  }
}

// The flipped sign of the four bf16 values of a split half: exact.
__device__ __forceinline__ uint2 negated(uint2 v) {
  return make_uint2(v.x ^ idg::kNegPair, v.y ^ idg::kNegPair);
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks)
    degridder_polstack_kernel(
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
        int T, int C, int nr_stations, int w_rank, int group) {
  using namespace idg;
  using TL = Tile<N>;
  constexpr int kThreads = TL::kThreads;
  constexpr int kCons = TL::kConsumers;
  constexpr int kLd = TL::kLdPhy;

  // [lhs hi: group slots][lhs lo: group slots, or one up to rank 2][stage 0][stage 1][sums]
  // [state: [8][producers]]
  extern __shared__ __align__(128) unsigned char smem[];
  const int nlo = w_rank > 2 ? group : 1;
  unsigned char* lhs = smem;
  unsigned char* stages = smem + (size_t)(group + nlo) * TL::kBytesL;
  float2* red = reinterpret_cast<float2*>(stages + 2 * TL::kStage);
  float4* state = reinterpret_cast<float4*>(stages + 2 * TL::kStage + TL::kBytesRed);

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int V = T * C;
  const int nt = (T + kVT - 1) / kVT * C;
  const float dk = k[C];   // the recurrence's channel step (common.cuh)
  const size_t nn = (size_t)N * N;
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float* mu_s = mu + (size_t)s * V;
  float2* out_s = out + (size_t)s * V * kPols;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;

  // Roles: the warpgroups first (the consumers), the producers after them;
  // the role comes through a warp shuffle (C7520). A producer owns
  // visibility pv of a tile and the 4 x and 4 y from a0: lanes pair up on
  // the two halves of a 16-byte K chunk, 16 visibilities a warp.
  const bool producer = __shfl_sync(0xffffffffu, tid >= kCons ? 1 : 0, 0) != 0;
  const int ptid = tid - kCons;
  const int pv = (ptid >> 1) % kVT;
  const int a0 = (ptid / (2 * kVT)) * 8 + (ptid & 1) * 4;

  // The prologue of the ranks [r0, r0 + nr): per pixel taper and A1 · P ·
  // A2ᴴ (math.hpp:79-92), then the split lhs of each rank (n^r by r
  // multiplies), rows (p, y), K = (re | im, x). A warp covers 8 rows y × 4
  // columns x of a core matrix per store: no bank conflicts.
  auto prologue = [&](int r0, int nr) {
    for (int q = tid; q < N * N; q += kThreads) {
      const int x = ((q >> 5) % (N / 4)) * 4 + (q & 3);
      const int y = ((q >> 5) / (N / 4)) * 8 + ((q >> 2) & 7);
      const int px = y * N + x;
      const float taper = sph[px];
      float2 p[kPols], o[kPols];
#pragma unroll
      for (int i = 0; i < kPols; ++i) {
        const float2 v = sub_s[i * nn + px];
        p[i] = make_float2(v.x * taper, v.y * taper);
      }
      jones_degridder(aterms + (at1 + px) * kPols, aterms + (at2 + px) * kPols, p, o);
      const float npx = n[px];
      float np = 1.0f;
      for (int r = 0; r < r0; ++r) np *= npx;
      for (int i = 0; i < nr; ++i) {
        if (i) np *= npx;
        __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(lhs + (size_t)i * TL::kBytesL);
        __nv_bfloat16* lo =
            reinterpret_cast<__nv_bfloat16*>(lhs + (size_t)(group + i) * TL::kBytesL);
        const bool four = three_passes(r0 + i, w_rank);
#pragma unroll
        for (int pol = 0; pol < kPols; ++pol) {
          const int row = pol * N + y;
          const int ore = core_index_bf16(row, x, TL::kKC);
          const int oim = core_index_bf16(row, N + x, TL::kKC);
          __nv_bfloat16 h, lw;
          split_bf16(o[pol].x * np, h, lw);
          hi[ore] = h;
          if (four) lo[ore] = lw;
          split_bf16(o[pol].y * np, h, lw);
          hi[oim] = h;
          if (four) lo[oim] = lw;
        }
      }
    }
    fence_async_smem();
    __syncthreads();
  };

  // One producer's share of a tile, timestep t of channel c: Φx (entries
  // 0-3) and Φy (entries 4-7) of its visibility at its 4 x and 4 y by the
  // recurrence. Φx goes split into the visibility's real column
  // [Φx_re | Φx_im] and imaginary column [−Φx_im | Φx_re] of the rhs, Φy
  // into the [v][y] table, μ into its row (0 past the tile's visibilities).
  // The tiles must be formed in order, from tile 0.
  auto form = [&](int tile, int buf) {
    unsigned char* st = stages + buf * TL::kStage;
    __nv_bfloat16* r_hi = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* r_lo = reinterpret_cast<__nv_bfloat16*>(st + TL::kBytesR);
    float2* phy = reinterpret_cast<float2*>(st + 2 * TL::kBytesR);
    float* smu = reinterpret_cast<float*>(st + 2 * TL::kBytesR + TL::kBytesPhy);
    const TileSpan sp = tile_span<true, kVT>(tile, T, C);
    const int c = tile % C, t = min((tile / C) * kVT + pv, T - 1);
    float2 e[8];
    phasors_shared<8>(
        [&](int i, float& po, float& ax, float& coord) {
          const int a = a0 + (i & 3);
          po = __ldg((i < 4 ? po_x : po_y) + (size_t)s * N + a);
          ax = __ldg((i < 4 ? l : m) + a);
          coord = __ldg(uvw_s + t * 3 + (i >> 2));
        },
        k, c, dk, state + ptid, TL::kProducers, e);
    float re[4], im[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      re[i] = e[i].x;
      im[i] = e[i].y;
    }
    uint2 re_hi, re_lo, im_hi, im_lo;
    split_bf16x4(re, re_hi, re_lo);
    split_bf16x4(im, im_hi, im_lo);
    const int col_re = core_index_bf16(pv, a0, TL::kKC);        // real column, x (re) half
    const int col_re2 = core_index_bf16(pv, N + a0, TL::kKC);   // real column, x (im) half
    const int col_im = core_index_bf16(kVT + pv, a0, TL::kKC);
    const int col_im2 = core_index_bf16(kVT + pv, N + a0, TL::kKC);
    *reinterpret_cast<uint2*>(r_hi + col_re) = re_hi;
    *reinterpret_cast<uint2*>(r_hi + col_re2) = im_hi;
    *reinterpret_cast<uint2*>(r_hi + col_im) = negated(im_hi);
    *reinterpret_cast<uint2*>(r_hi + col_im2) = re_hi;
    *reinterpret_cast<uint2*>(r_lo + col_re) = re_lo;
    *reinterpret_cast<uint2*>(r_lo + col_re2) = im_lo;
    *reinterpret_cast<uint2*>(r_lo + col_im) = negated(im_lo);
    *reinterpret_cast<uint2*>(r_lo + col_im2) = re_lo;
    float4* prow = reinterpret_cast<float4*>(phy + pv * kLd + a0);
    prow[0] = make_float4(e[4].x, e[4].y, e[5].x, e[5].y);
    prow[1] = make_float4(e[6].x, e[6].y, e[7].x, e[7].y);
    if (ptid < kVT) smu[ptid] = ptid < sp.nv ? __ldg(mu_s + sp.base + ptid * sp.stride) : 0.0f;
  };

  // A tile's outputs [kVT][P]: the sums of the pol's warps (N / 16 of
  // them), stored (first rank group) or added (the later ones).
  auto store = [&](int tile, int buf, bool first) {
    const float2* rb = red + (size_t)buf * TL::kConsWarps * kVT;
    if (ptid < kVT * kPols) {
      const TileSpan sp = tile_span<true, kVT>(tile, T, C);
      const int vl = ptid / kPols, p = ptid % kPols;
      float2 total = rb[(p * (N / 16)) * kVT + vl];
#pragma unroll
      for (int h = 1; h < N / 16; ++h) total = cadd(total, rb[(p * (N / 16) + h) * kVT + vl]);
      if (vl < sp.nv) {
        float2* o = out_s + (size_t)(sp.base + vl * sp.stride) * kPols + p;
        *o = first ? total : cadd(*o, total);
      }
    }
  };

  // the consumer's rows (p, y0) and (p, y0 + 8) of the lhs, its visibility
  // slots 8j + 2·t4 + e (j < 4, e < 2) and its warpgroup's slab. In the
  // accumulators, entry i < 16 (row y0 + 8·((i >> 1) & 1), slot
  // 2·(i >> 2) + (i & 1)) holds D_re in register i and D_im in 16 + i.
  const int lane = tid & 31, cw = tid / 32, t4 = lane & 3;
  const int y0 = (16 * cw + (lane >> 2)) % N;
  const int wg = tid / 128;
  float sum[32], acc[32];   // Σ_r conj(c_r)·D_r, and one rank's D_r
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = acc[i] = 0.0f;

  // The products of ranks [r0, r0 + nr) on the tile in stage buf, and stage
  // 2: rank r0's product accumulates in `sum` itself, every later rank's in
  // `acc`, added to `sum` times conj(c_r) = (−i)^r·μ^r/r! (two FMAs an
  // entry); Φy then multiplies the rank sum once.
  auto consume = [&](int buf, int r0, int nr) {
    const unsigned char* st = stages + buf * TL::kStage;
    const float2* phy = reinterpret_cast<const float2*>(st + 2 * TL::kBytesR);
    const float* smu = reinterpret_cast<const float*>(st + 2 * TL::kBytesR + TL::kBytesPhy);
    auto issue = [&](int i, float(&d)[32]) {
      fence_regs(d);
      wgmma_fence();
      if (three_passes(r0 + i, w_rank)) {
        mma_rank<N, true>(lhs, st, wg, i, group, d);
      } else {
        mma_rank<N, false>(lhs, st, wg, i, group, d);
      }
      wgmma_commit();
    };
    // the first two ranks' products go in flight together
    issue(0, sum);
    if (nr > 1) issue(1, acc);
    float mu_v[8], w[8];   // μ of each slot, and μ^r / r!
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mu_v[i] = smu[8 * (i >> 1) + 2 * t4 + (i & 1)];
      w[i] = 1.0f;
    }
    for (int r = 1; r <= r0; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] *= mu_v[i] * __fdividef(1.0f, (float)r);
    }
    wgmma_wait<0>();
    fence_regs(sum);
    fence_regs(acc);
    if (r0 > 0) rotate_scale<false>(sum, sum, w, r0);
    for (int i = 1; i < nr; ++i) {
      const int r = r0 + i;
      if (i > 1) {
        issue(i, acc);
        wgmma_wait<0>();
        fence_regs(acc);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] *= mu_v[q] * __fdividef(1.0f, (float)r);
      rotate_scale<true>(sum, acc, w, r);
    }
    // Σ over the thread's two rows of conj(Φy) · sum, per slot
    float2 part[8];
#pragma unroll
    for (int sl = 0; sl < 8; ++sl) {
      const int j = sl >> 1, e = sl & 1, v = 8 * j + 2 * t4 + e;
      const int i0 = 4 * j + e, i1 = i0 + 2;
      part[sl] = cadd(cmul_conj(phy[v * kLd + y0], make_float2(sum[i0], sum[16 + i0])),
                      cmul_conj(phy[v * kLd + y0 + 8], make_float2(sum[i1], sum[16 + i1])));
    }
    const int g = lane >> 2;
    red[((size_t)buf * TL::kConsWarps + cw) * kVT + 8 * (g >> 1) + 2 * t4 + (g & 1)] =
        reduce_slots(part, lane);
  };

  // The ranks in groups that fit shared memory (one group up to rank 4 at
  // N = 32); per group: the prologue, then tile j multiplied while tile
  // j + 1 is formed and tile j − 1 stored, one barrier a tile.
  const int ngroups = (w_rank + group - 1) / group;
  for (int gi = 0; gi < ngroups; ++gi) {
    const int r0 = gi * group, nr = min(group, w_rank - r0);
    prologue(r0, nr);
    if (producer) {
      form(0, 0);
      fence_async_smem();
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      if (producer) {
        if (j > 0) store(j - 1, (j - 1) & 1, gi == 0);
        if (j + 1 < nt) form(j + 1, (j + 1) & 1);
        fence_async_smem();
      } else {
        consume(j & 1, r0, nr);
      }
      __syncthreads();
    }
    if (producer) store(nt - 1, (nt - 1) & 1, gi == 0);
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
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  // up to rank 2 the hi of each rank and the lo of rank 0 beside the two
  // stages; above it every rank takes hi and lo, in groups of as many ranks
  // as fit (four at N = 32, all six at N = 16)
  const int group = w_rank <= 2
      ? w_rank
      : min(w_rank, (int)(((size_t)optin - TL::kFixed) / (2 * TL::kBytesL)));
  const int nlo = w_rank > 2 ? group : 1;
  const size_t bytes = (size_t)(group + nlo) * TL::kBytesL + TL::kFixed;
  if (group < 1 || bytes > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(degridder_polstack_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_polstack_kernel<N><<<S, TL::kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations, w_rank, group);
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
