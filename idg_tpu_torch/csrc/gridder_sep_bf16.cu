// K8b and K8c, gridder cuda_v4 and cuda_v5: visibilities -> subgrids
// c64[S, P, N, N], the separable product in split bf16 on the tensor cores
// (`wgmma`); cuda_v5 (kRecur) makes Φ by the channel recurrence.
//
// Replaces idg_tpu/ops/pallas/gridder.py:_kernel_separable (launcher
// _gridder_separable_run, gridder.py:525, registered as pallas_v4 with
// gridder_precisions) and :_kernel_sep_recur (launcher
// _gridder_sep_recur_run, gridder.py:708, pallas_v5). Per subgrid and
// Taylor rank r, as the plain version
// (ops/cuda/gridder_separable.py:gridder_separable_plain) takes it:
//   pix_r[y, (p,x)] = Σ_v Φy[v,y] · W_r[v,(p,x)],  W_r = Φx[v,x] · (vis[v,p] · (iμ_v)^r / r!)
//   Φx[v,x] = e^{i(po_x[x] − l[x]·u_t·k_c)},  Φy[v,y] = e^{i(po_y[y] − m[y]·v_t·k_c)}
// then pix = Σ_r n^r ⊙ pix_r, the Jones correction A1ᴴ·P·A2 and the taper.
// The operands are the plain version's: Φy and W_r, each split hi = bf16(x),
// lo = bf16(x − hi) (round to nearest even, separable.cuh:split_bf16), with
// the Taylor coefficient on W (gridder.py:466-477); "3x" = lo·hi + hi·lo +
// hi·hi for rank 0 and for every rank of an escalated rank, hi·hi alone for
// rank 1 at rank ≤ 2 (ops/precision.py:rank_precisions). cuda_v4 takes an
// exact sincosf for every entry of Φ; cuda_v5 the channel recurrence
// (separable.cuh:phasor<true>): the channel-0 plane, then one complex
// multiply a channel by the Δk plane, with an exact restart from k0 + c·Δk
// at every c % 16 == 0, c > 0 (uniform channel spacing assumed; the guard
// falls back to cuda_v4).
//
// What bounds it on an H100: the products are 4 bf16 passes × 67.1 MFLOP ×
// 24,500 subgrids = 6.6e12 FLOP at the default problem, 6.65 ms at 989
// TFLOP/s; around them, on the CUDA cores, Φ (cuda_v4: 131,072 exact
// sincosf a subgrid; cuda_v5: one complex multiply an entry, a sincosf at
// the restarts) and W_r of every rank (one complex multiply and a split an
// entry, 262,144 entries a subgrid at rank 2). The parent kernels (bf16
// mma.sync) took 63 ms (v4) and 60 ms (v5): every fragment came from a
// 32-bit shared-memory load, and the formation and the products ran on the
// same warps between barriers; v5 also walked the recurrence once a rank.
//
// Design (the gridder K1's, csrc/gridder.cu, in bf16 with the coefficient
// moved onto W):
//  - The product transposed, outᵀ[2NP × 2N] = W_rᵀ · [Φy_re | Φy_im], so the
//    64-row wgmma operand is W_r (256 rows at N = 32, 128 at N = 16) and
//    each consumer warpgroup owns a 64-row slab: rows (q, re | im),
//    q = p·N + x, interleaved by 8-row groups, so a thread's accumulators
//    hold all four real products of its complex outputs. Φy is the rhs
//    (2N rows, m64n64k16 at N = 32, m64n32k16 at N = 16), formed once a tile
//    for every rank; W_r is formed per rank.
//  - bf16 operands are half the bytes of K1's TF32 ones, and a k16 step
//    takes half K1's instructions for the same tile of 32 visibilities.
//  - Each tile's product starts fresh (accumulate = 0 on its first k step)
//    and is folded, weighted by n^r, into a running complex sum per output
//    in round-to-nearest FMAs: the tensor cores' accumulation truncates,
//    and a running sum over V on them missed the 1e-5 gate (3.2e-5 at V = 768).
//  - Tiles: cuda_v4 takes 32 consecutive visibilities v = t·C + c; cuda_v5
//    32 timesteps of one channel (v = c·T + t, as JAX's kernel orders
//    them), the t-tiles outer and the channels inner, so that a producer's
//    recurrence carries from one channel to the next (separable.cuh:
//    tile_span).
//  - Warp specialization: the consumer warpgroups issue the products and
//    fold them; 8N producer threads form the next tile (768 threads at
//    N = 32, 384 at N = 16). A producer owns one x, one y and 4 visibilities:
//    Φx and Φy there (cuda_v4: two exact sincosf each, no fast math;
//    cuda_v5: the recurrence, the state cur and step of its 8 entries in
//    shared memory, separable.cuh:phasors_shared: in registers they
//    spilled), Φy's split and, for every rank, W_r's split, stored 8 bytes
//    at a time with the lanes of a warp on 16 rows × both halves of a
//    16-byte chunk (no bank conflicts). vis·(iμ)^r/r! is formed once a
//    visibility, pol and rank into a small table first, behind a named
//    barrier of the producers alone. The roles come through a warp shuffle
//    and the ragged tile is masked by selects: ptxas serializes wgmma around
//    a divergent path (C7520); the recurrence's three cases branch on the
//    channel, the same for the whole block. One barrier a tile hands the two
//    stages over; the visibilities and μ arrive by cp.async a tile ahead of
//    the formation (cuda_v5: 32 bytes a timestep, strided by C·P).
//  - Shared memory: a stage is Φy (hi, lo) and W_r (hi, lo) of each rank of
//    a group, 40 KB a rank at N = 32. Two stages take up to three ranks
//    (two beside cuda_v5's 32 KB of recurrence state); above that the ranks
//    go in groups that fit, each walking every tile again (forming Φ again,
//    cuda_v5 from channel 0) and folding into the same running sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "separable.cuh"
#include "wgmma.cuh"

namespace {

using idg::kPols;

constexpr int kKT = 32;                  // visibilities a tile: two k16 steps
constexpr int kKC = kKT / 8;             // 8-wide K chunks of an operand row
constexpr uint32_t kLBO = 128;           // the next K chunk's core matrix
constexpr uint32_t kSBO = kKC * 128;     // the next 8-row group's
constexpr int kRawBytes = kKT * kPols * (int)sizeof(float2) + kKT * (int)sizeof(float);
constexpr int kProdBar = 1;              // the producers' named barrier

template <int N>
struct Tile {
  static constexpr int kRowsW = 2 * N * kPols;      // A = W_rᵀ: (q = p·N + x, re | im)
  static constexpr int kRowsL = 2 * N;              // B = Φy: (re | im)·N + y
  static constexpr int kGroups = kRowsW / 64;       // warpgroups, one 64-row slab each
  static constexpr int kConsumers = 128 * kGroups;  // the products and the fold
  static constexpr int kProducers = 8 * N;          // the formation: (x = y, 4 visibilities) each
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMinBlocks = N == 16 ? 2 : 1;
  static constexpr int kAcc = kRowsL / 2;           // accumulator floats a thread
  static constexpr int kOut = N / 4;                // complex outputs a thread
  static constexpr size_t kBytesW = (size_t)kRowsW * kKT * 2;   // one split of one rank
  static constexpr size_t kBytesL = (size_t)kRowsL * kKT * 2;   // one split
  static constexpr size_t kBytesVc = (size_t)kKT * kPols * sizeof(float2);   // a rank's vis·c_r
  // a stage: Φy hi, Φy lo, then W hi of every rank of the group, then W lo
  __host__ __device__ static constexpr size_t stage_bytes(int group) {
    return 2 * kBytesL + 2 * (size_t)group * kBytesW;
  }
  // cuda_v5's recurrence state: (cur, step) of a producer's 8 entries
  static constexpr size_t kBytesState = (size_t)8 * kProducers * sizeof(float4);
  // two stages, the vis·c_r table, the two raw slots, the recurrence state
  __host__ __device__ static constexpr size_t smem_bytes(int group, bool recur) {
    return 2 * stage_bytes(group) + group * kBytesVc + 2 * (size_t)kRawBytes +
           (recur ? kBytesState : 0);
  }
  static_assert(kPols * N * N * sizeof(float2) <= 2 * kBytesL + 2 * kBytesW,
                "the epilogue's pixels fit a stage");
  static_assert(kProducers >= 64 && kProducers % 64 == 0, "whole producer warps, 16 x a warp");
};

// Rank slot i's products over one tile of the stage at `stage`, this
// warpgroup's slab, into acc (three bf16 passes, or hi·hi alone), inside
// the caller's commit group.
template <int N, bool kThree>
__device__ __forceinline__ void mma_rank(const unsigned char* stage, int slab, int i, int group,
                                         float (&acc)[Tile<N>::kAcc]) {
  using TL = Tile<N>;
  const unsigned char* l_hi = stage;
  const unsigned char* w_hi = stage + 2 * TL::kBytesL + (size_t)i * TL::kBytesW + slab * 8 * kSBO;
#pragma unroll
  for (int ks = 0; ks < kKT / 16; ++ks) {
    const int off = ks * 2 * 128;   // two K chunks a k16 step
    idg::mma_bf16_step<kThree>(
        acc, ks == 0, idg::smem_desc(w_hi + off, kLBO, kSBO),
        idg::smem_desc(w_hi + (size_t)group * TL::kBytesW + off, kLBO, kSBO),
        idg::smem_desc(l_hi + off, kLBO, kSBO),
        idg::smem_desc(l_hi + TL::kBytesL + off, kLBO, kSBO));
  }
}

// The kernel of both rungs (cuda_v5 with kRecur); each rung's __global__
// below calls it.
template <int N, bool kRecur>
__device__ __forceinline__ void gridder_sep(
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
    int T, int C, int nr_stations, int w_rank, int group) {
  using namespace idg;
  using TL = Tile<N>;
  constexpr int kThreads = TL::kThreads;
  constexpr int kCons = TL::kConsumers;
  constexpr int kProd = TL::kProducers;

  // [stage 0][stage 1][vis·c_r: group × [kKT][P]][raw 0][raw 1][state: [8][kProd]]
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t stage_bytes = TL::stage_bytes(group);
  float2* vc = reinterpret_cast<float2*>(smem + 2 * stage_bytes);
  unsigned char* raw = smem + 2 * stage_bytes + group * TL::kBytesVc;
  float4* state = reinterpret_cast<float4*>(raw + 2 * kRawBytes);

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int V = T * C;
  const int nt = kRecur ? (T + kKT - 1) / kKT * C : (V + kKT - 1) / kKT;
  const float dk = k[C];   // the recurrence's channel step (common.cuh)
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * V * kPols;
  const float* mu_s = mu + (size_t)s * V;

  // Roles: the warpgroups first (the consumers), the producers after them.
  // The role comes through a warp shuffle, so the compiler knows it is
  // uniform in a warp (C7520). A producer owns position a (x for W_r, y for
  // Φy) and visibilities [kv, kv + 4) of a tile: lanes pair up on the two
  // halves of a 16-byte K chunk, 16 positions a warp.
  const bool producer = __shfl_sync(0xffffffffu, tid >= kCons ? 1 : 0, 0) != 0;
  const int ptid = tid - kCons;
  const int a = (ptid >> 1) % N;
  const int kv = (ptid / (2 * N)) * 8 + (ptid & 1) * 4;
  float pox = 0.0f, lx = 0.0f, poy = 0.0f, my = 0.0f;
  if (producer) {
    pox = po_x[(size_t)s * N + a];
    lx = l[a];
    poy = po_y[(size_t)s * N + a];
    my = m[a];
  }

  auto stage_raw = [&](int tile, int slot) {
    const TileSpan sp = tile_span<kRecur, kKT>(tile, T, C);
    unsigned char* dst = raw + slot * kRawBytes;
    for (int e = ptid; e < sp.nv * 2; e += kProd) {
      const float2* src = vis_s + (size_t)(sp.base + (e >> 1) * sp.stride) * kPols + (e & 1) * 2;
      cp_async16(dst + e * 16, src);
    }
    float* dmu = reinterpret_cast<float*>(dst + kKT * kPols * sizeof(float2));
    for (int e = ptid; e < sp.nv; e += kProd) cp_async4(dmu + e, mu_s + sp.base + e * sp.stride);
    cp_async_commit();
  };

  // The producers' share of a tile for ranks [r0, r0 + nr): first
  // vis·(iμ)^r/r! of every visibility, pol and rank into the vc table (0
  // past the tile's visibilities, by selects), then, behind the producers'
  // barrier, each producer's Φx and Φy at its 4 visibilities, Φy's split
  // and W_r's. cuda_v5 must form the tiles in order, from tile 0.
  auto form = [&](int tile, int slot, int buf, int r0, int nr) {
    const int nv = tile_span<kRecur, kKT>(tile, T, C).nv;
    const float2* rvis = reinterpret_cast<const float2*>(raw + slot * kRawBytes);
    const float* rmu = reinterpret_cast<const float*>(rvis + kKT * kPols);
    for (int e = ptid; e < nr * kKT * kPols; e += kProd) {
      const int i = e / (kKT * kPols), kk = (e / kPols) % kKT;
      const float2 c = taylor_coefficient(rmu[kk], r0 + i);
      const float2 w = cmul(rvis[e % (kKT * kPols)], c);
      vc[e] = kk < nv ? w : make_float2(0.0f, 0.0f);
    }
    bar_sync(kProdBar, kProd);

    unsigned char* st = smem + buf * stage_bytes;
    float2 phx[4];
    float py_re[4], py_im[4];
    if constexpr (kRecur) {
      // timesteps t0 + i of channel c: Φx[a, t0 + i] is entry i, Φy[a, t0 +
      // i] entry 4 + i. The ragged tile's dead entries step too, on the last
      // timestep's coordinates, and stay unmasked (no registers beside the
      // state): their W is 0 by the vc table, and their Φy is finite.
      const int c = tile % C, t0 = (tile / C) * kKT + kv;
      float2 e[8];
      phasors_shared<8>(
          [&](int i, float& po, float& ax, float& coord) {
            po = i < 4 ? pox : poy;
            ax = i < 4 ? lx : my;
            coord = __ldg(uvw_s + min(t0 + (i & 3), T - 1) * 3 + (i >> 2));
          },
          k, c, dk, state + ptid, kProd, e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        phx[i] = e[i];
        py_re[i] = e[4 + i].x;
        py_im[i] = e[4 + i].y;
      }
    } else {
      const int v0 = tile * kKT;
      int t = (v0 + kv) / C, c = v0 + kv - t * C;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = kv + i < nv;
        const float* uvw_t = uvw_s + min(t, T - 1) * 3;
        const float kc = __ldg(k + c);
        float sn, cs;
        sincosf(pox - lx * (__ldg(uvw_t) * kc), &sn, &cs);
        phx[i] = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
        sincosf(poy - my * (__ldg(uvw_t + 1) * kc), &sn, &cs);
        py_re[i] = live ? cs : 0.0f;
        py_im[i] = live ? sn : 0.0f;
        const bool wrap = ++c == C;
        c = wrap ? 0 : c;
        t += wrap;
      }
    }
    uint2 hi, lo;
    __nv_bfloat16* l_hi = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* l_lo = reinterpret_cast<__nv_bfloat16*>(st + TL::kBytesL);
    const int yre = core_index_bf16(a, kv, kKC), yim = core_index_bf16(N + a, kv, kKC);
    split_bf16x4(py_re, hi, lo);
    *reinterpret_cast<uint2*>(l_hi + yre) = hi;
    *reinterpret_cast<uint2*>(l_lo + yre) = lo;
    split_bf16x4(py_im, hi, lo);
    *reinterpret_cast<uint2*>(l_hi + yim) = hi;
    *reinterpret_cast<uint2*>(l_lo + yim) = lo;

    __nv_bfloat16* w_base = reinterpret_cast<__nv_bfloat16*>(st + 2 * TL::kBytesL);
    for (int i = 0; i < nr; ++i) {
      const bool three = three_passes(r0 + i, w_rank);
      __nv_bfloat16* w_hi = w_base + (size_t)i * TL::kBytesW / 2;
      __nv_bfloat16* w_lo = w_hi + (size_t)group * TL::kBytesW / 2;
      const float2* vci = vc + (size_t)i * kKT * kPols;
#pragma unroll
      for (int p = 0; p < kPols; ++p) {
        float re[4], im[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 w = cmul(phx[j], vci[(kv + j) * kPols + p]);
          re[j] = w.x;
          im[j] = w.y;
        }
        const int q = p * N + a, row = (q >> 3) * 16 + (q & 7);
        const int ore = core_index_bf16(row, kv, kKC), oim = core_index_bf16(row + 8, kv, kKC);
        split_bf16x4(re, hi, lo);
        *reinterpret_cast<uint2*>(w_hi + ore) = hi;
        if (three) *reinterpret_cast<uint2*>(w_lo + ore) = lo;
        split_bf16x4(im, hi, lo);
        *reinterpret_cast<uint2*>(w_hi + oim) = hi;
        if (three) *reinterpret_cast<uint2*>(w_lo + oim) = lo;
      }
    }
  };

  // the consumer's outputs (fold) and its warpgroup's slab
  const int q_out = tid >> 2, t4 = tid & 3;
  const int x_out = q_out % N, p_out = q_out / N;
  const int slab = tid / 128;
  float acc[TL::kAcc];
#pragma unroll
  for (int i = 0; i < TL::kAcc; ++i) acc[i] = 0.0f;
  float2 sum[TL::kOut];
#pragma unroll
  for (int o = 0; o < TL::kOut; ++o) sum[o] = make_float2(0.0f, 0.0f);

  // The ranks in groups that fit two stages (one group up to rank 3 at
  // N = 32); per group, tile j is multiplied and folded while tile j + 1 is
  // formed in the other stage, one barrier a tile.
  const int ngroups = (w_rank + group - 1) / group;
  for (int gi = 0; gi < ngroups; ++gi) {
    const int r0 = gi * group, nr = min(group, w_rank - r0);
    if (producer) {
      stage_raw(0, 0);
      if (nt > 1) stage_raw(1, 1);
      cp_async_wait_all();
      bar_sync(kProdBar, kProd);   // every producer's copies have landed
      form(0, 0, 0, r0, nr);
      fence_async_smem();
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      if (producer) {
        // raw slot j & 1 held tile j's data, formed before the last barrier
        if (j + 2 < nt) stage_raw(j + 2, j & 1);
        if (j + 1 < nt) form(j + 1, (j + 1) & 1, (j + 1) & 1, r0, nr);
        cp_async_wait_all();
        fence_async_smem();
      } else {
        const unsigned char* stage = smem + (j & 1) * stage_bytes;
        for (int i = 0; i < nr; ++i) {
          fence_regs(acc);
          wgmma_fence();
          if (three_passes(r0 + i, w_rank)) {
            mma_rank<N, true>(stage, slab, i, group, acc);
          } else {
            mma_rank<N, false>(stage, slab, i, group, acc);
          }
          wgmma_commit();
          fold_rank<N>(r0 + i, n, x_out, t4, acc, sum);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: the running sums into shared memory as [P][N][N], then per
  // pixel A1ᴴ · P · A2 (math.hpp:64-77) and the taper
  float2* s_pix = reinterpret_cast<float2*>(smem);
  if (!producer) {
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int y = 8 * jj + 2 * t4 + e;
        s_pix[(p_out * N + y) * N + x_out] = sum[2 * jj + e];
      }
    }
  }
  __syncthreads();
  const size_t nn = (size_t)N * N;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  for (int q = tid; q < N * N; q += kThreads) {
    float2 px[kPols], o[kPols];
#pragma unroll
    for (int p = 0; p < kPols; ++p) px[p] = s_pix[p * nn + q];
    jones_gridder(aterms + (at1 + q) * kPols, aterms + (at2 + q) * kPols, px, o);
    const float taper = sph[q];
#pragma unroll
    for (int p = 0; p < kPols; ++p) {
      out[((size_t)s * kPols + p) * nn + q] = make_float2(o[p].x * taper, o[p].y * taper);
    }
  }
}

#define IDG_GRIDDER_SEP_PARAMS                                                             \
  const float* __restrict__ uvw, const float2* __restrict__ vis, const float* __restrict__ mu, \
      const float* __restrict__ k, const float* __restrict__ po_x,                         \
      const float* __restrict__ po_y, const float* __restrict__ l,                         \
      const float* __restrict__ m, const float* __restrict__ n,                            \
      const float* __restrict__ sph, const float2* __restrict__ aterms,                    \
      const int* __restrict__ aterm_index, const int* __restrict__ station1,               \
      const int* __restrict__ station2, float2* __restrict__ out, int T, int C,            \
      int nr_stations, int w_rank, int group
#define IDG_GRIDDER_SEP_ARGS                                                               \
  uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2, out, T, \
      C, nr_stations, w_rank, group

// One __global__ a rung, so that ptxas's report and the SASS name them apart.
template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks)
    gridder_sep_v4_kernel(IDG_GRIDDER_SEP_PARAMS) {
  gridder_sep<N, false>(IDG_GRIDDER_SEP_ARGS);
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks)
    gridder_sep_v5_kernel(IDG_GRIDDER_SEP_PARAMS) {
  gridder_sep<N, true>(IDG_GRIDDER_SEP_ARGS);
}

#undef IDG_GRIDDER_SEP_PARAMS
#undef IDG_GRIDDER_SEP_ARGS

template <int N, bool kRecur>
cudaError_t launch(const float* uvw, const float2* vis, const float* mu, const float* k,
                   const float* po_x, const float* po_y, const float* l, const float* m,
                   const float* n, const float* sph, const float2* aterms,
                   const int* aterm_index, const int* station1, const int* station2,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  using TL = Tile<N>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  // as many ranks a group as two stages hold (every rank up to 3 at N = 32,
  // up to 2 beside cuda_v5's recurrence state)
  int group = w_rank;
  while (group > 1 && TL::smem_bytes(group, kRecur) > (size_t)optin) --group;
  const size_t bytes = TL::smem_bytes(group, kRecur);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  auto* kernel = &gridder_sep_v4_kernel<N>;
  if constexpr (kRecur) kernel = &gridder_sep_v5_kernel<N>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<S, TL::kThreads, bytes, stream>>>(
      uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      out, T, C, nr_stations, w_rank, group);
  return cudaGetLastError();
}

}  // namespace

namespace idg {

// cuda_v4, or cuda_v5 with `recurrence`.
cudaError_t gridder_sep_bf16(const float* uvw, const float2* vis, const float* mu,
                             const float* k, const float* po_x, const float* po_y,
                             const float* l, const float* m, const float* n, const float* sph,
                             const float2* aterms, const int* aterm_index, const int* station1,
                             const int* station2, float2* out, int S, int T, int C, int N,
                             int nr_stations, int w_rank, bool recurrence,
                             cudaStream_t stream) {
#define IDG_ARGS                                                                            \
  uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2, out, S, \
      T, C, nr_stations, w_rank, stream
  switch (N) {
    case 16: return recurrence ? launch<16, true>(IDG_ARGS) : launch<16, false>(IDG_ARGS);
    case 32: return recurrence ? launch<32, true>(IDG_ARGS) : launch<32, false>(IDG_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}

}  // namespace idg
