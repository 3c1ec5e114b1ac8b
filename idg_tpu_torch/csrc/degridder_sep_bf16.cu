// K9b and K9c, degridder cuda_v4 and cuda_v5: subgrids c64[S, P, N, N] ->
// visibilities c64[S, T, C, P], stage 1 in split bf16 on the tensor cores
// (`wgmma`); cuda_v5 (kRecur) makes Φ by the channel recurrence.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_separable (launcher
// _degridder_separable_run, degridder.py:307, registered as pallas_v4 with
// rank_precisions) and :_kernel_sep_recur (launcher _degridder_sep_recur_one
// behind _chunked, degridder.py:559, pallas_v5). Per subgrid and Taylor
// rank r, as the plain version
// (ops/cuda/degridder_separable.py:degridder_separable_plain) takes it:
//   B[y, (p,x)] = A1 · (sph·P) · A2ᴴ                                     (prologue)
//   D_r[v, (p,x)] = Σ_y conj(Φy[v,y]) · (n^r ⊙ B)[y, (p,x)]             (stage 1)
//   vis[v,p] = Σ_r conj((iμ_v)^r / r!) · Σ_x D_r[v,(p,x)] · conj(Φx[v,x]) (stage 2)
// Stage 1's operands are the plain version's: n^r ⊙ B and Φy, each split
// hi = bf16(x), lo = bf16(x − hi) (round to nearest even); "3x" = lo·hi +
// hi·lo + hi·hi for rank 0 and for every rank of an escalated rank, hi·hi
// alone for rank 1 at rank ≤ 2 (ops/precision.py:rank_precisions). Stage 2
// is float32. cuda_v4 takes an exact sincosf for every entry of Φ; cuda_v5
// the channel recurrence (separable.cuh:phasor<true>: one complex multiply
// a channel, an exact restart from k0 + c·Δk at every c % 16 == 0, c > 0;
// uniform channel spacing assumed, the guard falls back to cuda_v4). The
// output is written as [S, T, C, P] directly (the TPU kernels wrote
// [S, P, V] and transposed).
//
// What bounds it on an H100: stage 1's products, 4 bf16 passes × 67.1 MFLOP
// × 24,500 subgrids = 6.6e12 FLOP at the default problem, 6.65 ms at 989
// TFLOP/s; around them, on the CUDA cores, Φ (cuda_v4: 131,072 exact
// sincosf a subgrid; cuda_v5: one complex multiply an entry) and stage 2
// (~1 M FMA a subgrid at rank 2). The parent kernels (bf16 mma.sync) took
// 56 ms (v4) and 53 ms (v5): every fragment came from a 32-bit
// shared-memory load, the rank loop was outermost (Φ formed once per rank,
// v5's prologue too), and the formation, the products and stage 2 ran on
// the same warps between barriers.
//
// Design (the degridder K2's, csrc/degridder.cu, with the contraction over
// y as the plain version takes it):
//  - The 64-row wgmma operand is n^r ⊙ B, [B_re | B_im]ᵀ: 2NP rows (256 at
//    N = 32, four consumer warpgroups; 128 at N = 16, two), rows (q, re |
//    im), q = p·N + x, interleaved by 8-row groups, K = y. It is formed and
//    split once a subgrid and rank, in a prologue, and read by every tile.
//    A tile of 32 visibilities is the 64-column rhs (the Φy_re column of
//    each visibility, then its Φy_im column), formed once a tile for every
//    rank. K = N is two k16 steps at N = 32, one at N = 16.
//  - Tiles: cuda_v4 takes 32 consecutive visibilities v = t·C + c; cuda_v5
//    32 timesteps of one channel, the t-tiles outer and the channels inner,
//    so that a producer's recurrence carries from one channel to the next
//    (separable.cuh:tile_span).
//  - Stage 2 on the accumulators: a thread holds, for one output (p, x),
//    D_r's four real products at 8 visibilities, so conj(Φy)·B comes out
//    complex in its registers. Each rank, as soon as its products land, is
//    multiplied by conj(Φx) and conj(c_r) = (−i)^r·μ^r/r! (a quarter turn
//    and two FMAs an entry) into 8 running partial sums; one butterfly over
//    the 8 lanes of a column group a tile then sums the warp's 8 x, and the
//    N/8 warps of a pol meet in shared memory, where the producers add them
//    and store the tile's [32, P] outputs. Only the wgmma's own sum over y
//    truncates; every other sum is round-to-nearest, and no sum runs across
//    tiles (a visibility lives in one tile).
//  - Warp specialization: the consumer warpgroups issue the products and
//    run stage 2; 8N producer threads form the next tile (768 threads at
//    N = 32, 384 at N = 16). A producer owns one visibility and 4 x and 4
//    y: Φx and Φy there (cuda_v4: eight exact sincosf; cuda_v5: the
//    recurrence, the state cur and step of its 8 entries in shared memory,
//    separable.cuh:phasors_shared, the phase offsets and axis values read at
//    the restarts alone: in registers they spilled),
//    Φy's split stored 8 bytes at a time with the lanes of a warp on 16
//    rows × both halves of a 16-byte chunk (no bank conflicts), Φx into a
//    padded [v][x] table that stage 2 reads without conflicts. The roles come
//    through a warp shuffle and the ragged tile is masked by selects
//    (C7520); the recurrence's three cases branch on the channel, the same
//    for the whole block. One barrier a tile hands the stages over.
//  - Shared memory: n^r ⊙ B is 32 KB a rank at N = 32 (hi and lo), a stage
//    17 KB. Up to five ranks fit beside two stages at N = 32 (four beside
//    cuda_v5's 32 KB of recurrence state; every rank at N = 16); above that
//    the ranks go in two groups, each forming its lhs and walking every tile
//    again (cuda_v5 from channel 0), adding its visibilities to the first's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "separable.cuh"
#include "wgmma.cuh"

namespace {

using idg::kPols;

constexpr int kVT = 32;             // visibilities a tile
constexpr int kCols = 2 * kVT;      // rhs rows: the Φy_re column of each visibility, then Φy_im
constexpr uint32_t kLBO = 128;      // the next K chunk's core matrix

template <int N>
struct Tile {
  static constexpr int kK = N;                      // contraction: y
  static constexpr int kKC = kK / 8;                // 8-wide K chunks of an operand row
  static constexpr uint32_t kSBO = kKC * 128;       // the next 8-row group's core matrices
  static constexpr int kRows = 2 * N * kPols;       // lhs rows (q, re | im)
  static constexpr int kGroups = kRows / 64;        // consumer warpgroups, one 64-row slab each
  static constexpr int kConsumers = 128 * kGroups;  // the products and stage 2
  static constexpr int kConsWarps = kConsumers / 32;
  static constexpr int kProducers = 2 * kVT * kKC;  // the formation: one (visibility, 4 x, 4 y) each
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMinBlocks = N == 16 ? 2 : 1;
  static constexpr int kLdX = N + 4;                // Φx row stride (float2): conflict-free stage 2
  static constexpr size_t kBytesL = (size_t)kRows * kK * 2;   // one rank's lhs, hi or lo
  static constexpr size_t kBytesR = (size_t)kCols * kK * 2;   // a tile's rhs, hi or lo
  static constexpr size_t kBytesPhx = (size_t)kVT * kLdX * sizeof(float2);
  // a stage: rhs hi, rhs lo, Φx [kVT][kLdX], μ [kVT]
  static constexpr size_t kStage = 2 * kBytesR + kBytesPhx + kVT * sizeof(float);
  // the warps' stage-2 sums, two tiles: [2][kConsWarps][kVT]
  static constexpr size_t kBytesRed = 2 * (size_t)kConsWarps * kVT * sizeof(float2);
  // cuda_v5's recurrence state: (cur, step) of a producer's 8 entries
  static constexpr size_t kBytesState = (size_t)8 * kProducers * sizeof(float4);
  __host__ __device__ static constexpr size_t smem_bytes(int group, bool recur) {
    return 2 * (size_t)group * kBytesL + 2 * kStage + kBytesRed + (recur ? kBytesState : 0);
  }
  static_assert(kStage % 128 == 0 && kBytesR % 128 == 0 && kBytesPhx % 128 == 0,
                "regions stay 128-byte aligned");
  static_assert(kProducers >= kVT * kPols, "one producer a tile output");
};

// One rank's products over one tile, this warpgroup's slab of the lhs in
// slot `slot` (its lo in slot group + slot) against the stage's rhs, into
// acc (three bf16 passes, or hi·hi alone), inside the caller's commit group.
template <int N, bool kThree>
__device__ __forceinline__ void mma_rank(const unsigned char* lhs, const unsigned char* stage,
                                         int wg, int slot, int group, float (&acc)[32]) {
  using TL = Tile<N>;
  const unsigned char* a_hi = lhs + (size_t)slot * TL::kBytesL + wg * 8 * TL::kSBO;
  const unsigned char* a_lo = a_hi + (size_t)group * TL::kBytesL;
#pragma unroll
  for (int ks = 0; ks < TL::kK / 16; ++ks) {
    const int off = ks * 2 * 128;   // two K chunks a k16 step
    idg::mma_bf16_step<kThree>(acc, ks == 0, idg::smem_desc(a_hi + off, kLBO, TL::kSBO),
                               idg::smem_desc(a_lo + off, kLBO, TL::kSBO),
                               idg::smem_desc(stage + off, kLBO, TL::kSBO),
                               idg::smem_desc(stage + TL::kBytesR + off, kLBO, TL::kSBO));
  }
}

// The kernel of both rungs (cuda_v5 with kRecur); each rung's __global__
// below calls it.
template <int N, bool kRecur>
__device__ __forceinline__ void degridder_sep(
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
  constexpr int kLd = TL::kLdX;

  // [lhs hi: group slots][lhs lo: group slots][stage 0][stage 1][sums][state: [8][producers]]
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* lhs = smem;
  unsigned char* stages = smem + 2 * (size_t)group * TL::kBytesL;
  float2* red = reinterpret_cast<float2*>(stages + 2 * TL::kStage);
  float4* state = reinterpret_cast<float4*>(stages + 2 * TL::kStage + TL::kBytesRed);

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int V = T * C;
  const int nt = kRecur ? (T + kVT - 1) / kVT * C : (V + kVT - 1) / kVT;
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
  float pox[4], lx[4], poy[4], my[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pox[i] = lx[i] = poy[i] = my[i] = 0.0f;
  if (producer) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pox[i] = po_x[(size_t)s * N + a0 + i];
      lx[i] = l[a0 + i];
      poy[i] = po_y[(size_t)s * N + a0 + i];
      my[i] = m[a0 + i];
    }
  }

  // The prologue of the ranks [r0, r0 + nr): per pixel taper and A1 · P ·
  // A2ᴴ (math.hpp:79-92), then n^r ⊙ B of each rank (n^r by r multiplies)
  // split into its lhs slot, rows (q, re | im), K = y.
  auto prologue = [&](int r0, int nr) {
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
      float np = 1.0f;
      for (int r = 0; r < r0; ++r) np *= npx;
      for (int i = 0; i < nr; ++i) {
        if (i) np *= npx;
        __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(lhs + (size_t)i * TL::kBytesL);
        __nv_bfloat16* lo = reinterpret_cast<__nv_bfloat16*>(lhs + (size_t)(group + i) * TL::kBytesL);
        const bool three = three_passes(r0 + i, w_rank);
#pragma unroll
        for (int pol = 0; pol < kPols; ++pol) {
          const int q = pol * N + x, row = (q >> 3) * 16 + (q & 7);
          const int ore = core_index_bf16(row, y, TL::kKC);
          const int oim = core_index_bf16(row + 8, y, TL::kKC);
          __nv_bfloat16 h, lw;
          split_bf16(o[pol].x * np, h, lw);
          hi[ore] = h;
          if (three) lo[ore] = lw;
          split_bf16(o[pol].y * np, h, lw);
          hi[oim] = h;
          if (three) lo[oim] = lw;
        }
      }
    }
    fence_async_smem();
    __syncthreads();
  };

  // One producer's share of a tile: Φx and Φy of its visibility at its 4 x
  // and 4 y (0 past the tile's visibilities, by selects). Φy goes split
  // into the visibility's rhs rows (re, then im), Φx into the [v][x] table,
  // μ into its row. cuda_v5 must form the tiles in order, from tile 0.
  auto form = [&](int tile, int buf) {
    unsigned char* st = stages + buf * TL::kStage;
    __nv_bfloat16* r_hi = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* r_lo = reinterpret_cast<__nv_bfloat16*>(st + TL::kBytesR);
    float2* phx = reinterpret_cast<float2*>(st + 2 * TL::kBytesR);
    float* smu = reinterpret_cast<float*>(st + 2 * TL::kBytesR + TL::kBytesPhx);
    const TileSpan sp = tile_span<kRecur, kVT>(tile, T, C);
    float2 px[4];
    float py_re[4], py_im[4];
    if constexpr (kRecur) {
      // timestep t of channel c: Φx[a0 + i, t] is entry i, Φy[a0 + i, t]
      // entry 4 + i. A ragged tile's dead visibility steps too, on the last
      // timestep's coordinates, and stays unmasked (no registers beside the
      // state): its Φ is finite and its outputs are never stored.
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        px[i] = e[i];
        py_re[i] = e[4 + i].x;
        py_im[i] = e[4 + i].y;
      }
    } else {
      const bool live = pv < sp.nv;
      const int vc = min(tile * kVT + pv, V - 1), t = vc / C, c = vc - t * C;
      const float kv = __ldg(k + c);
      const float uk = __ldg(uvw_s + t * 3) * kv, vk = __ldg(uvw_s + t * 3 + 1) * kv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sn, cs;
        sincosf(pox[i] - lx[i] * uk, &sn, &cs);
        px[i] = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
        sincosf(poy[i] - my[i] * vk, &sn, &cs);
        py_re[i] = live ? cs : 0.0f;
        py_im[i] = live ? sn : 0.0f;
      }
    }
    const int ore = core_index_bf16(pv, a0, TL::kKC), oim = core_index_bf16(kVT + pv, a0, TL::kKC);
    uint2 hi, lo;
    split_bf16x4(py_re, hi, lo);
    *reinterpret_cast<uint2*>(r_hi + ore) = hi;
    *reinterpret_cast<uint2*>(r_lo + ore) = lo;
    split_bf16x4(py_im, hi, lo);
    *reinterpret_cast<uint2*>(r_hi + oim) = hi;
    *reinterpret_cast<uint2*>(r_lo + oim) = lo;
    float4* prow = reinterpret_cast<float4*>(phx + pv * kLd + a0);
    prow[0] = make_float4(px[0].x, px[0].y, px[1].x, px[1].y);
    prow[1] = make_float4(px[2].x, px[2].y, px[3].x, px[3].y);
    if (ptid < kVT) smu[ptid] = ptid < sp.nv ? __ldg(mu_s + sp.base + ptid * sp.stride) : 0.0f;
  };

  // A tile's outputs [kVT][P]: the sums of the pol's N / 8 warps, stored
  // (first rank group) or added (the later ones).
  auto store = [&](int tile, int buf, bool first) {
    constexpr int kWarpsPol = N / 8;
    const float2* rb = red + (size_t)buf * TL::kConsWarps * kVT;
    if (ptid < kVT * kPols) {
      const TileSpan sp = tile_span<kRecur, kVT>(tile, T, C);
      const int vl = ptid / kPols, p = ptid % kPols;
      float2 total = rb[(p * kWarpsPol) * kVT + vl];
#pragma unroll
      for (int h = 1; h < kWarpsPol; ++h) total = cadd(total, rb[(p * kWarpsPol + h) * kVT + vl]);
      if (vl < sp.nv) {
        float2* o = out_s + (size_t)(sp.base + vl * sp.stride) * kPols + p;
        *o = first ? total : cadd(*o, total);
      }
    }
  };

  // The consumer's output (p, x), q = tid / 4, and its visibility slots
  // 8j + 2·t4 + e (j < 4, e < 2). Its accumulators hold, at column group j,
  // B_re·Φy_re in register 4j + e, B_im·Φy_re in 4j + 2 + e, and at column
  // group j + 4 the same against Φy_im.
  const int lane = tid & 31, cw = tid / 32, t4 = lane & 3;
  const int x_out = (tid >> 2) % N;
  const int wg = tid / 128;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  // The products of ranks [r0, r0 + nr) on the tile in stage buf, each
  // rank's stage 2 folded into the partial sums as soon as it lands.
  auto consume = [&](int buf, int r0, int nr) {
    const unsigned char* st = stages + buf * TL::kStage;
    const float2* phx = reinterpret_cast<const float2*>(st + 2 * TL::kBytesR);
    const float* smu = reinterpret_cast<const float*>(st + 2 * TL::kBytesR + TL::kBytesPhx);
    float2 part[8];
    float w[8];   // μ^r / r! of each slot
#pragma unroll
    for (int sl = 0; sl < 8; ++sl) {
      part[sl] = make_float2(0.0f, 0.0f);
      w[sl] = 1.0f;
    }
    for (int r = 1; r <= r0; ++r) {
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) {
        w[sl] *= smu[8 * (sl >> 1) + 2 * t4 + (sl & 1)] * __fdividef(1.0f, (float)r);
      }
    }
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + i;
      fence_regs(acc);
      wgmma_fence();
      if (three_passes(r, w_rank)) {
        mma_rank<N, true>(lhs, st, wg, i, group, acc);
      } else {
        mma_rank<N, false>(lhs, st, wg, i, group, acc);
      }
      wgmma_commit();
      if (i > 0) {
#pragma unroll
        for (int sl = 0; sl < 8; ++sl) {
          w[sl] *= smu[8 * (sl >> 1) + 2 * t4 + (sl & 1)] * __fdividef(1.0f, (float)r);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      // conj(c_r) = (−i)^r · w: a quarter turn per rank, then the scale
      const float sign = (r & 2) ? -1.0f : 1.0f;
      const bool odd = r & 1;
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) {
        const int j = sl >> 1, e = sl & 1, v = 8 * j + 2 * t4 + e;
        const float2 d = make_float2(acc[4 * j + e] + acc[4 * (j + 4) + 2 + e],
                                     acc[4 * j + 2 + e] - acc[4 * (j + 4) + e]);
        const float2 g = cmul_by_conj(d, phx[v * kLd + x_out]);
        const float a = sign * w[sl];
        part[sl].x = fmaf(a, odd ? g.y : g.x, part[sl].x);
        part[sl].y = fmaf(a, odd ? -g.x : g.y, part[sl].y);
      }
    }
    const int g = lane >> 2;
    red[((size_t)buf * TL::kConsWarps + cw) * kVT + 8 * (g >> 1) + 2 * t4 + (g & 1)] =
        reduce_slots(part, lane);
  };

  // The ranks in groups that fit shared memory (one group up to rank 5 at
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

#define IDG_DEGRIDDER_SEP_PARAMS                                                           \
  const float* __restrict__ uvw, const float* __restrict__ mu, const float* __restrict__ k,   \
      const float* __restrict__ po_x, const float* __restrict__ po_y,                      \
      const float* __restrict__ l, const float* __restrict__ m,                            \
      const float* __restrict__ n, const float* __restrict__ sph,                          \
      const float2* __restrict__ aterms, const int* __restrict__ aterm_index,              \
      const int* __restrict__ station1, const int* __restrict__ station2,                  \
      const float2* __restrict__ subgrids, float2* __restrict__ out, int T, int C,         \
      int nr_stations, int w_rank, int group
#define IDG_DEGRIDDER_SEP_ARGS                                                             \
  uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2, subgrids, \
      out, T, C, nr_stations, w_rank, group

// One __global__ a rung, so that ptxas's report and the SASS name them apart.
template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks)
    degridder_sep_v4_kernel(IDG_DEGRIDDER_SEP_PARAMS) {
  degridder_sep<N, false>(IDG_DEGRIDDER_SEP_ARGS);
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks)
    degridder_sep_v5_kernel(IDG_DEGRIDDER_SEP_PARAMS) {
  degridder_sep<N, true>(IDG_DEGRIDDER_SEP_ARGS);
}

#undef IDG_DEGRIDDER_SEP_PARAMS
#undef IDG_DEGRIDDER_SEP_ARGS

template <int N, bool kRecur>
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
  // as many ranks a group as fit beside the two stages
  int group = w_rank;
  while (group > 1 && TL::smem_bytes(group, kRecur) > (size_t)optin) --group;
  const size_t bytes = TL::smem_bytes(group, kRecur);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  auto* kernel = &degridder_sep_v4_kernel<N>;
  if constexpr (kRecur) kernel = &degridder_sep_v5_kernel<N>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<S, TL::kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations, w_rank, group);
  return cudaGetLastError();
}

}  // namespace

namespace idg {

// cuda_v4, or cuda_v5 with `recurrence`.
cudaError_t degridder_sep_bf16(const float* uvw, const float* mu, const float* k,
                               const float* po_x, const float* po_y, const float* l,
                               const float* m, const float* n, const float* sph,
                               const float2* aterms, const int* aterm_index,
                               const int* station1, const int* station2,
                               const float2* subgrids, float2* out, int S, int T, int C, int N,
                               int nr_stations, int w_rank, bool recurrence,
                               cudaStream_t stream) {
#define IDG_ARGS                                                                           \
  uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2, subgrids, \
      out, S, T, C, nr_stations, w_rank, stream
  switch (N) {
    case 16: return recurrence ? launch<16, true>(IDG_ARGS) : launch<16, false>(IDG_ARGS);
    case 32: return recurrence ? launch<32, true>(IDG_ARGS) : launch<32, false>(IDG_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}

}  // namespace idg
