// K2, degridder cuda_v7: subgrids c64[S, P, N, N] -> visibilities
// c64[S, T, C, P], the pol-stacked separable product on the TF32 tensor
// cores (`wgmma`).
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_polstack_batch (launcher
// _degridder_polstack_batch_run, registered as degridder pallas_v7 and, at
// rank 1, pallas_v8), non-fused 4-D input form, and with kFuse the fused
// grid-stage prologue (the `fuse` branch, degridder.py:1022-1059,
// degridder_pallas_v7_staged with fuse_oyx). Per subgrid and Taylor rank r:
//   B = A1·(sph·P)·A2ᴴ                                          (prologue)
//   lhs_r [4N × 2N] = [B_re·n^r | B_im·n^r], rows (p, y)          (pol-stacked)
//   D_r = lhs_r · [[Φx_re, −Φx_im], [Φx_im, Φx_re]]              (the product)
//   vis[v,p] += conj((iμ_v)^r / r!) · Σ_y conj(Φy[v,y]) · D_r,p[y,v]   (stage 2)
//   Φx[v,x] = e^{i(po_x[x] − l[x]·u_t·k_c)},  Φy[v,y] = e^{i(po_y[y] − m[y]·v_t·k_c)}
// and writes [S, T, C, P] directly (the TPU kernel wrote c-major [S, P, C·T]
// and transposed afterwards). Every Φ entry is an exact sincosf (no fast
// math, no channel recurrence), so non-uniform wavenumbers need no fallback.
//
// What bounds it on an H100: the product, 4N × 2N × 2V real multiply-adds a
// subgrid and pass. At the default problem (rank 2, N = 32, V = 2048) it is
// 4 TF32 passes × 67.1 MFLOP × 24,500 subgrids = 6.6e12 FLOP, 13.3 ms at
// 495 TFLOP/s (2,048 tensor cycles of each 32-visibility tile, 11,879
// tiles an SM), the count of the gridder K1; around it 131,072 exact
// sincosf a subgrid and stage 2 (~1 M FMA a subgrid). Its bytes (2.4 GB)
// take 0.72 ms. The reference's operation model (1.779e12 FLOP a pass) over
// the TF32 peak gives 3.594 ms, fused 3.699. On the card (PERF.md §6) the
// pol-stacked form below took 29.9 ms fused; builds of it that dropped a
// role took 19.9 ms with the producers alone, 24.1 with the consumers alone
// (17.9 without stage 2) and 3.0 with neither: the consumers' products and
// stage 2 ran one after the other, and the formation would hide under them.
//
// Two product forms, chosen by (N, w_rank), inputs the kernel already has:
//  - N = 32 up to rank 2, turned (kTurned): Dᵀ[(v, re | im), (p, y)] =
//    rhsᵀ · lhs_rᵀ. A tile's 32 visibilities, a real and an imaginary row
//    each over K = 2N (x re | x im), in alternating groups of 8, are the
//    m64 operand; the lhs's 128 rows (p, y) the n128 operand, so one
//    warpgroup computes a whole tile in 32 wgmma m64n128k8 (8 k8 steps,
//    three TF32 passes of rank 0 and one of rank 1), where the pol-stacked
//    form took 64 m64n64k8 over two warpgroups: 192 KB of operands a tile
//    instead of 256 KB. Rank 1's weight conj(iμ) = −iμ is folded into its
//    A rows (the producers store μ·[−Φx_im | Φx_re] and −μ·[Φx_re | Φx_im],
//    rows swapped and scaled, TF32 hi), so both ranks sum in the same 64
//    accumulators: a thread holds D_re and D_im of one visibility at 8 y of
//    each pol, and stage 2 is per thread (8 Φy loads, 32 complex MACs) and
//    per quad (two xor-shuffle steps leave lane t pol t, which it stores:
//    a quad writes a visibility's 32 bytes). The two consumer warpgroups
//    take alternate tiles (ping-pong), so one's stage 2 runs while the
//    other's products are on the tensor cores; each has its own slot of
//    the two-slot ring, handed over by named barriers (formed: producers
//    arrive, the warpgroup waits; free again: the warpgroup arrives once
//    its products are done and its Φy read, the producers wait), which
//    also order the tiles. Up to rank 2 the fold fits: above it every rank
//    would need a weighted A, hi and lo, beside the ranks' lhs.
//  - Otherwise pol-stacked: D_r = lhs_r · rhs, lhs_r the 64-row operand,
//    128 rows at N = 32 (two consumer warpgroups, two pols each), 64 at
//    N = 16 (one), so both subgrid sizes fill whole warpgroups; a tile is
//    the 64-column rhs (the real column of each visibility, then its
//    imaginary one), formed once a tile for every rank. Stage 2 on the
//    accumulators: a thread holds D_re and D_im of two rows (p, y),
//    (p, y + 8) at 8 visibilities; Σ_y conj(Φy) and Σ_r conj(c_r) commute,
//    so the ranks are summed first: the first rank's products accumulate in
//    the rank-sum registers themselves, the second's in a second set,
//    issued right behind, and each later rank is added as (−i)^r·μ^r/r!
//    times its D, a quarter turn and two FMAs an entry. Φy multiplies the
//    rank sum once a tile, then a butterfly over the 8 lanes of a column
//    group leaves each lane one visibility's sum over its warp's 16 rows.
//    The warps of one pol (two at N = 32) meet in shared memory once a
//    tile, where the producers add them and store the tile's [32, P]
//    outputs, coalesced. One barrier a tile hands the two stages over.
//
// Common to both:
//  - lhs_r = [B_re·n^r | B_im·n^r], rows (p, y), formed and split once a
//    subgrid, in the prologue, and read by every tile.
//  - TF32 in three passes (wgmma.cuh: lo·hi + hi·lo + hi·hi, ~22 bits of
//    each operand, so degridder_plain, float32 "highest", stays the
//    reference) for rank 0 and for every rank of an escalated rank; hi·hi
//    alone for rank 1 at rank ≤ 2 (ops/precision.py, "3xtf32"). Only the
//    wgmma's own sums truncate (the tensor cores' accumulation: over 2N,
//    and turned over both ranks' 4N); the rank sum (pol-stacked), the y-sum
//    and the pols' halves are round-to-nearest FMAs and FADDs, and no sum
//    runs across tiles (a visibility lives in one tile).
//  - Warp specialization: the consumer warpgroups issue the products and
//    run stage 2; after them 8N producer threads form the tiles (512
//    threads at N = 32, 256 at N = 16). A producer owns one visibility of
//    the tile and 4 x and 4 y: eight exact sincosf, Φx's TF32 split written
//    as 16-byte stores (consecutive lanes on consecutive rows: no bank
//    conflicts; turned, split on the bits, wgmma.cuh:split_tf32_bits), Φy
//    into a [v][y] table that stage 2 reads without conflicts (pol-stacked
//    padded rows, turned a swizzle, phy_unit). The roles come through a
//    warp shuffle and nothing in a warpgroup that issues wgmma branches on
//    the thread (ragged tiles by selects or predicated stores): ptxas
//    serializes wgmma around a divergent path.
//  - Shared memory: the lhs of one rank is 32 KB a split at N = 32 (8 KB at
//    N = 16). Up to rank 2 the lhs (hi of each rank, lo of rank 0) sits
//    beside both stages (pol-stacked: 41 KB a stage, 182 KB at N = 32;
//    turned: 56 KB a slot, 208 KB); at N = 16 every rank up to 6 does. At
//    N = 32 above rank 2 (three passes for each rank, 64 KB a rank) the
//    ranks go in groups of two: each group forms its lhs and walks all
//    tiles, forming Φ again, and adds its visibilities to those of the
//    groups before it (a round-to-nearest FADD on the output).
//  - Registers, no spill: pol-stacked 124 at N = 32, 122 at N = 16; turned
//    105 fused, 100 non-fused (the consumers' 64 accumulators, the Φy of
//    their 8 y and the descriptors, formed each tile).
//  - On the card (default problem, rank 2, PERF.md §6) the turned form
//    takes 21.3 ms fused and 20.4 non-fused, where the pol-stacked one took
//    29.8 and 28.6.
//
// Fused prologue (kFuse): the input is the range extraction's block-rolled
// pieces. The block copies them as they are into the stages' shared memory
// (cp.async, with K3's factors, split on the host, beside them), free until
// the first tile, then splits them un-rolled by (oy, ox) = oyx[s] (an exact
// index permutation, tile[y][x] = piece[(y+oy)%N][(x+ox)%N], in place of the
// TPU kernel's conjugate Fourier phases) into K3's operand (dft.cuh) in the
// lhs slots, free until the lhs is formed; K3 applies the forward
// folded-shift DFT to all four pols at once on the TF32 tensor cores, on the
// consumer warpgroups, and the subgrid lands back in the stages (turned:
// the slots), rows padded, where the taper/Jones prologue reads it in place of device
// memory. The result is the non-fused kernel on
// ops/grid.py:_finish_extract(pieces). At N = 32 above rank 2 each group of
// ranks runs the prologue, and K3, again.
//
// Phase probes (kProbe, the fused form only; probe.cuh): the entry point
// given an accumulator launches the probed instance, which sums each
// block's cycles from entry to exit, in K3 (the fused prologue's copy,
// un-roll, split and forward DFT, to its barrier), in the tile loops, and
// waiting at the loops' barriers, on consumer warp 0 (`tc_wait`: the
// tensor-core warps waiting for the formation; turned, for its slot to be
// formed) and on the first producer warp (`form_wait`; turned, for a slot
// to be free).

#include <cuda_runtime.h>

#include "common.cuh"
#include "dft.cuh"
#include "probe.cuh"
#include "wgmma.cuh"

namespace {

using idg::kPols;

constexpr int kVT = 32;             // visibilities a tile
constexpr int kCols = 2 * kVT;      // rhs columns: the real column of each visibility, then the imaginary
constexpr uint32_t kLBO = 128;      // the next K chunk's core matrix

template <int N>
struct Tile {
  static constexpr int kK = 2 * N;                  // contraction: x (re) | x (im)
  static constexpr int kKC = kK / 4;                // 4-wide K chunks of an operand row
  static constexpr uint32_t kSBO = kKC * 128;       // the next 8-row group's core matrices
  static constexpr int kRows = kPols * N;           // lhs rows (p, y)
  static constexpr int kGroups = kRows / 64;        // consumer warpgroups, one 64-row slab each
  static constexpr int kConsumers = 128 * kGroups;  // the products and stage 2
  static constexpr int kConsWarps = kConsumers / 32;
  static constexpr int kProducers = kVT * N / 4;    // the formation: one (visibility, 4 x, 4 y) each
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMinBlocks = N == 16 ? 2 : 1;
  static constexpr int kLdPhy = N + 2;              // Φy row stride (float2): conflict-free stage 2
  static constexpr size_t kBytesL = (size_t)kRows * kK * 4;   // one rank's lhs, hi or lo
  static constexpr size_t kBytesR = (size_t)kCols * kK * 4;   // a tile's rhs, hi or lo
  static constexpr size_t kBytesPhy = (size_t)kVT * kLdPhy * sizeof(float2);
  // a stage: rhs hi, rhs lo, Φy [kVT][kLdPhy], μ [kVT]
  static constexpr size_t kStage = 2 * kBytesR + kBytesPhy + kVT * sizeof(float);
  // the warps' stage-2 sums, two tiles: [2][kConsWarps][kVT]
  static constexpr size_t kBytesRed = 2 * (size_t)kConsWarps * kVT * sizeof(float2);
  // the fused prologue's subgrid [P][N][kLdSub] (rows padded, so that
  // neither K3's stores nor the Jones prologue's reads meet 4-way bank
  // conflicts) and K3's factors in the stages, K3's operand in the lhs slots
  // (at least two: hi and lo of one rank)
  static constexpr int kLdSub = N + 2;
  static constexpr size_t kBytesSub = (size_t)kPols * N * kLdSub * sizeof(float2);
  static_assert(kBytesSub + 2 * idg::Dft<N>::kBytesW <= 2 * kStage,
                "the fused prologue's subgrid and factors fit the stages");
  static_assert(2 * idg::Dft<N>::kBytesX <= 2 * kBytesL, "K3's operand fits two lhs slots");
  static_assert(idg::Dft<N>::kGroups == kGroups, "K3 runs on the consumer warpgroups");
  static_assert(kBytesSub % 128 == 0, "K3's factors stay 128-byte aligned");
  static_assert(kStage % 128 == 0 && kBytesR % 128 == 0 && kBytesPhy % 128 == 0,
                "regions stay 128-byte aligned");
  static_assert(kProducers >= kVT * kPols, "one producer a tile output");
};

// The turned product (N = 32, rank ≤ 2), Dᵀ = rhsᵀ · lhs_rᵀ. A slot holds
// one tile: its A operand, the 64 rows (v, re | im) in alternating groups
// of 8 over K = (x re | x im), as rank 0 hi, rank 0 lo and rank 1's folded
// rows (hi); then Φy as [v][y pair], 16 bytes a pair, the pair's index
// swizzled (phy_unit). Two slots, one for each consumer warpgroup, handed
// over by named barriers (1 is K3's).
struct Turned {
  using TL = Tile<32>;
  static constexpr size_t kBytesA = (size_t)kCols * TL::kK * 4;          // 16 KB
  static constexpr size_t kBytesPhy = (size_t)kVT * 32 * sizeof(float2);  // 8 KB
  static constexpr size_t kSlot = 3 * kBytesA + kBytesPhy;
  static constexpr int kFull = 2, kEmpty = 4;   // + slot: formed, free again
  static constexpr int kBarCount = TL::kProducers + 128;   // producers and one warpgroup
  static_assert(TL::kGroups == 2, "a slot for each consumer warpgroup");
  static_assert(TL::kBytesSub + 2 * idg::Dft<32>::kBytesW <= 2 * kSlot,
                "the fused prologue's subgrid and factors fit the slots");
  static_assert(kSlot % 128 == 0, "regions stay 128-byte aligned");
};

// The 16-byte unit of Φy[v][2q, 2q + 1] in a turned slot. The swizzle keeps
// both sides free of bank conflicts: the producers' stores (8 consecutive v,
// one q) and stage 2's loads (v and v + 1, four consecutive q).
__device__ __forceinline__ int phy_unit(int v, int q) {
  return v * 16 + (q ^ (((v & 1) << 2) | ((v >> 1) & 3)));
}

// *p = x where live, as a predicated store: no branch in a warpgroup that
// issues wgmma (ptxas serializes wgmma around a divergent path).
__device__ __forceinline__ void store_live(float2* p, float2 x, bool live) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p st.global.v2.f32 [%1], {%2, %3};\n}\n"
               ::"r"((int)live), "l"(p), "f"(x.x), "f"(x.y) : "memory");
}

// One rank's products over one tile, this warpgroup's slab of the lhs in
// slot `slot` (its lo in slot group + slot) against the stage's rhs, into
// acc (three TF32 passes, or hi·hi alone), inside the caller's commit group.
template <int N, bool kThree>
__device__ __forceinline__ void mma_rank(const unsigned char* lhs, const unsigned char* stage,
                                         int wg, int slot, int group, float (&acc)[32]) {
  using TL = Tile<N>;
  const unsigned char* a_hi = lhs + (size_t)slot * TL::kBytesL + wg * 8 * TL::kSBO;
  const unsigned char* a_lo = a_hi + (size_t)group * TL::kBytesL;
#pragma unroll
  for (int ks = 0; ks < TL::kK / 8; ++ks) {
    const int off = ks * 2 * 128;   // two K chunks a k8 step
    idg::mma_tf32_step<kThree>(acc, ks == 0, idg::smem_desc(a_hi + off, kLBO, TL::kSBO),
                               idg::smem_desc(a_lo + off, kLBO, TL::kSBO),
                               idg::smem_desc(stage + off, kLBO, TL::kSBO),
                               idg::smem_desc(stage + TL::kBytesR + off, kLBO, TL::kSBO));
  }
}

template <int N, bool kFuse, bool kProbe, bool kTurned>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks) degridder_kernel(
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
    const float2* __restrict__ subgrids,    // [S, P, N, N] subgrids, or pieces with kFuse
    const int* __restrict__ oyx,            // [S, 2] (kFuse only)
    const float* __restrict__ wr,           // [2, 2N, 2N] K3's split factors, forward (kFuse only)
    float2* __restrict__ out,               // [S, T, C, P]
    unsigned long long* __restrict__ probe, // [kProbeFields] phase cycles (kProbe only)
    int T, int C, int nr_stations, int w_rank, int group) {
  using namespace idg;
  using TL = Tile<N>;
  static_assert(!kTurned || N == 32, "the turned product fills n128 with the lhs's 128 rows");
  constexpr int kThreads = TL::kThreads;
  constexpr int kCons = TL::kConsumers;
  constexpr int kLd = TL::kLdPhy;
  [[maybe_unused]] const uint32_t t_entry = probe_clock<kProbe>();
  [[maybe_unused]] uint32_t loop = 0, waited = 0, k3_cycles = 0;   // kProbe's sums

  // [lhs hi: group slots][lhs lo: group slots, or one up to rank 2][stage 0][stage 1][sums]
  extern __shared__ __align__(128) unsigned char smem[];
  const int nlo = w_rank > 2 ? group : 1;
  unsigned char* lhs = smem;
  unsigned char* stages = smem + (size_t)(group + nlo) * TL::kBytesL;
  float2* red = reinterpret_cast<float2*>(stages + 2 * TL::kStage);

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int V = T * C;
  const int nt = (V + kVT - 1) / kVT;
  const size_t nn = (size_t)N * N;
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float* mu_s = mu + (size_t)s * V;
  float2* out_s = out + (size_t)s * V * kPols;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;

  // Roles: the warpgroups first issue the products and run stage 2 (the
  // consumers); the warps after them form the tiles and store the outputs
  // (the producers). The role comes through a warp shuffle, so the compiler
  // knows it is uniform in a warp (C7520). A producer owns visibility pv of
  // a tile and the 4-wide chunk pc of x and of y.
  const bool producer = __shfl_sync(0xffffffffu, tid >= kCons ? 1 : 0, 0) != 0;
  const int ptid = tid - kCons;
  const int pv = ptid % kVT, pc = ptid / kVT;
  float pox[4], lx[4], poy[4], my[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pox[i] = lx[i] = poy[i] = my[i] = 0.0f;
  if (producer) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = 4 * pc + i;
      pox[i] = po_x[(size_t)s * N + a];
      lx[i] = l[a];
      poy[i] = po_y[(size_t)s * N + a];
      my[i] = m[a];
    }
  }

  // the consumers' accumulators (the fused prologue's K3 takes acc's too)
  float sum[32], acc[32];   // Σ_r conj(c_r)·D_r, and one rank's D_r
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = acc[i] = 0.0f;

  // The prologue of the ranks [r0, r0 + nr): the fused form's subgrid,
  // then per pixel taper and A1 · P · A2ᴴ (math.hpp:79-92), and the split
  // lhs of each rank (n^r by r multiplies). A warp covers one core matrix
  // (8 rows y × 4 columns x) per store: no bank conflicts.
  auto prologue = [&](int r0, int nr) {
    float2* s_sub = reinterpret_cast<float2*>(stages);
    if constexpr (kFuse) {
      [[maybe_unused]] const uint32_t t_k3 = probe_clock<kProbe>();
      // K3 (dft.cuh): the pieces as they are into s_sub's padded rows and
      // K3's factors beside them, by cp.async (every copy in flight at
      // once, no registers); then the pieces un-rolled from there and split
      // into its operand X [(p, y)][(re | im, x)] in the lhs slots (a warp
      // on 8 y × 4 x of a pol: no bank conflicts on the stores); then the
      // forward DFT of all four pols on the consumer warpgroups into s_sub
      using D = Dft<N>;
      // the thread index through an empty asm, so that nothing derived
      // from it below is hoisted out of the rank groups' loop and kept
      // live beside the consumers' accumulators
      int ktid = tid;
      asm volatile("" : "+r"(ktid));
      float* x_hi = reinterpret_cast<float*>(lhs);
      unsigned char* w = stages + TL::kBytesSub;
      for (int i = ktid; i < kPols * N * N / 2; i += kThreads) {   // two complex values a copy
        const int row = i / (N / 2), x2 = 2 * (i % (N / 2));      // row (p, y)
        cp_async16(s_sub + row * TL::kLdSub + x2, sub_s + (size_t)row * N + x2);
      }
      dft_load_factors<N, kThreads>(wr, w, ktid);
      cp_async_wait_all();
      __syncthreads();
      // the roll is taken mod N, as the plain version takes it: no index leaves the tile
      const int oy = (oyx[2 * s] % N + N) % N, ox = (oyx[2 * s + 1] % N + N) % N;
      for (int e = ktid; e < kPols * N * N; e += kThreads) {
        const int p = e / (N * N), q = e % (N * N);
        const int x = ((q >> 5) % (N / 4)) * 4 + (q & 3);
        const int y = ((q >> 5) / (N / 4)) * 8 + ((q >> 2) & 7);
        dft_store_x<N>(x_hi, x_hi + D::kBytesX / 4, p, y, x,
                       s_sub[(p * N + ((y + oy) & (N - 1))) * TL::kLdSub + ((x + ox) & (N - 1))]);
      }
      fence_async_smem();
      __syncthreads();
      // sum's and acc's values are dead here (the next tile's first product
      // of each overwrites it): zeros instead, so that neither set's values
      // stay live beside K3's and the lhs formation's registers
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = 0.0f;
      if (!producer) {
        dft2_products<N>(lhs, w, ktid / 128, ktid % 128, acc, [&](int p, int y, int x, float2 v) {
          s_sub[(p * N + y) * TL::kLdSub + x] = v;
        });
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      __syncthreads();
      if constexpr (kProbe) k3_cycles += probe_clock<kProbe>() - t_k3;
    }
    for (int q = tid; q < N * N; q += kThreads) {
      const int x = ((q >> 5) % (N / 4)) * 4 + (q & 3);
      const int y = ((q >> 5) / (N / 4)) * 8 + ((q >> 2) & 7);
      const int px = y * N + x;
      const float taper = sph[px];
      float2 p[kPols], o[kPols];
#pragma unroll
      for (int i = 0; i < kPols; ++i) {
        const float2 v = kFuse ? s_sub[(i * N + y) * TL::kLdSub + x] : sub_s[i * nn + px];
        p[i] = make_float2(v.x * taper, v.y * taper);
      }
      jones_degridder(aterms + (at1 + px) * kPols, aterms + (at2 + px) * kPols, p, o);
      const float npx = n[px];
      float np = 1.0f;
      for (int r = 0; r < r0; ++r) np *= npx;
      for (int i = 0; i < nr; ++i) {
        if (i) np *= npx;
        float* hi = reinterpret_cast<float*>(lhs + (size_t)i * TL::kBytesL);
        float* lo = reinterpret_cast<float*>(lhs + (size_t)(group + i) * TL::kBytesL);
        const bool three = three_passes(r0 + i, w_rank);
#pragma unroll
        for (int pol = 0; pol < kPols; ++pol) {
          const int row = pol * N + y;
          const int ore = core_index(row, x, TL::kKC), oim = core_index(row, N + x, TL::kKC);
          float h, lw;
          split_tf32(o[pol].x * np, h, lw);
          hi[ore] = h;
          if (three) lo[ore] = lw;
          split_tf32(o[pol].y * np, h, lw);
          hi[oim] = h;
          if (three) lo[oim] = lw;
        }
      }
    }
    fence_async_smem();
    __syncthreads();
  };

  // One producer's share of a tile: Φx and Φy of its visibility at its 4 x
  // and 4 y (0 past V, by selects). Φx goes split into the visibility's real
  // column [Φx_re | Φx_im] and imaginary column [−Φx_im | Φx_re] of the rhs,
  // Φy into the [v][y] table, μ into its row.
  auto form = [&](int tile, int buf) {
    unsigned char* st = stages + buf * TL::kStage;
    float* r_hi = reinterpret_cast<float*>(st);
    float* r_lo = reinterpret_cast<float*>(st + TL::kBytesR);
    float2* phy = reinterpret_cast<float2*>(st + 2 * TL::kBytesR);
    float* smu = reinterpret_cast<float*>(st + 2 * TL::kBytesR + TL::kBytesPhy);
    const int v = tile * kVT + pv;
    const bool live = v < V;
    const int vc = min(v, V - 1), t = vc / C, c = vc - t * C;
    const float kv = __ldg(k + c);
    const float uk = __ldg(uvw_s + t * 3) * kv, vk = __ldg(uvw_s + t * 3 + 1) * kv;
    float rh[4], rl[4], ih[4], il[4];
    float2 py[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sn, cs;
      sincosf(pox[i] - lx[i] * uk, &sn, &cs);
      split_tf32(live ? cs : 0.0f, rh[i], rl[i]);
      split_tf32(live ? sn : 0.0f, ih[i], il[i]);
      sincosf(poy[i] - my[i] * vk, &sn, &cs);
      py[i] = live ? make_float2(cs, sn) : make_float2(0.0f, 0.0f);
    }
    const int re_x = core_index(pv, 4 * pc, TL::kKC), re_y = core_index(pv, N + 4 * pc, TL::kKC);
    const int im_x = core_index(kVT + pv, 4 * pc, TL::kKC);
    const int im_y = core_index(kVT + pv, N + 4 * pc, TL::kKC);
    *reinterpret_cast<float4*>(r_hi + re_x) = make_float4(rh[0], rh[1], rh[2], rh[3]);
    *reinterpret_cast<float4*>(r_hi + re_y) = make_float4(ih[0], ih[1], ih[2], ih[3]);
    *reinterpret_cast<float4*>(r_hi + im_x) = make_float4(-ih[0], -ih[1], -ih[2], -ih[3]);
    *reinterpret_cast<float4*>(r_hi + im_y) = make_float4(rh[0], rh[1], rh[2], rh[3]);
    *reinterpret_cast<float4*>(r_lo + re_x) = make_float4(rl[0], rl[1], rl[2], rl[3]);
    *reinterpret_cast<float4*>(r_lo + re_y) = make_float4(il[0], il[1], il[2], il[3]);
    *reinterpret_cast<float4*>(r_lo + im_x) = make_float4(-il[0], -il[1], -il[2], -il[3]);
    *reinterpret_cast<float4*>(r_lo + im_y) = make_float4(rl[0], rl[1], rl[2], rl[3]);
    float4* prow = reinterpret_cast<float4*>(phy + pv * kLd + 4 * pc);
    prow[0] = make_float4(py[0].x, py[0].y, py[1].x, py[1].y);
    prow[1] = make_float4(py[2].x, py[2].y, py[3].x, py[3].y);
    if (pc == 0) smu[pv] = live ? __ldg(mu_s + vc) : 0.0f;
  };

  // A tile's outputs [kVT][P]: the sums of the pol's warps (N / 16 of
  // them), stored (first rank group) or added (the later ones).
  auto store = [&](int tile, int buf, bool first) {
    const float2* rb = red + (size_t)buf * TL::kConsWarps * kVT;
    if (ptid < kVT * kPols) {
      const int vl = ptid / kPols, p = ptid % kPols, v = tile * kVT + vl;
      float2 total = rb[(p * (N / 16)) * kVT + vl];
#pragma unroll
      for (int h = 1; h < N / 16; ++h) total = cadd(total, rb[(p * (N / 16) + h) * kVT + vl]);
      if (v < V) {
        float2* o = out_s + (size_t)v * kPols + p;
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
      for (int k = 0; k < 8; ++k) w[k] *= mu_v[k] * __fdividef(1.0f, (float)r);
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

  if constexpr (kTurned) {
    // the turned product (header): the prologue of every rank, then the
    // producers form tile j in slot j & 1 while consumer warpgroup j & 1
    // multiplies it and the other warpgroup runs stage 2 of tile j − 1
    using TT = Turned;
    prologue(0, w_rank);
    unsigned char* ring = stages;
    auto wait_bar = [&](int id) {
      const uint32_t t = probe_clock<kProbe>();
      bar_sync(id, TT::kBarCount);
      if constexpr (kProbe) waited += probe_clock<kProbe>() - t;
    };

    if (producer) {
      // One producer's share of a tile: Φx and Φy of its visibility at its 4
      // x and 4 y. A's rows of rank 0, split on the bits (split_tf32's
      // values): the real row [Φx_re | Φx_im], the imaginary row
      // [−Φx_im | Φx_re]. Rank 1's rows carry its weight conj(iμ) = −iμ,
      // which turns (D_re, D_im) into (μ·D_im, −μ·D_re): μ·[−Φx_im | Φx_re]
      // and −μ·[Φx_re | Φx_im], hi alone. Past V the tile repeats the last
      // visibility, whose outputs stage 2 does not store.
      auto form_turned = [&](int tile, unsigned char* st) {
        // the slot through an empty asm, so that the addresses of the 14
        // stores into each of the two slots are not hoisted out of the loop
        asm volatile("" : "+l"(st));
        float* a0h = reinterpret_cast<float*>(st);
        float* a0l = a0h + TT::kBytesA / 4;
        float* a1h = a0l + TT::kBytesA / 4;
        float4* phy = reinterpret_cast<float4*>(st + 3 * TT::kBytesA);
        const int vc = min(tile * kVT + pv, V - 1), t = vc / C, c = vc - t * C;
        const float kv = __ldg(k + c), muv = __ldg(mu_s + vc);
        const float uk = __ldg(uvw_s + t * 3) * kv, vk = __ldg(uvw_s + t * 3 + 1) * kv;
        float rh[4], rl[4], ih[4], il[4], ms[4], mc[4];
        float2 py[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sn, cs;
          sincosf(pox[i] - lx[i] * uk, &sn, &cs);
          split_tf32_bits(cs, rh[i], rl[i]);
          split_tf32_bits(sn, ih[i], il[i]);
          ms[i] = tf32_rn_bits(-muv * sn);
          mc[i] = tf32_rn_bits(muv * cs);
          sincosf(poy[i] - my[i] * vk, &sn, &cs);
          py[i] = make_float2(cs, sn);
        }
        // rows (v, re) and (v, im): 8 visibilities' real rows, then their imaginary ones
        const int re = (pv >> 3) * 16 + (pv & 7), im = re + 8;
        const int re0 = core_index(re, 4 * pc, TL::kKC), re1 = core_index(re, N + 4 * pc, TL::kKC);
        const int im0 = core_index(im, 4 * pc, TL::kKC), im1 = core_index(im, N + 4 * pc, TL::kKC);
        const auto put = [](float* p, const float(&x)[4], float sign) {
          *reinterpret_cast<float4*>(p) = make_float4(sign * x[0], sign * x[1], sign * x[2], sign * x[3]);
        };
        put(a0h + re0, rh, 1.0f);
        put(a0h + re1, ih, 1.0f);
        put(a0h + im0, ih, -1.0f);
        put(a0h + im1, rh, 1.0f);
        put(a0l + re0, rl, 1.0f);
        put(a0l + re1, il, 1.0f);
        put(a0l + im0, il, -1.0f);
        put(a0l + im1, rl, 1.0f);
        if (w_rank > 1) {
          put(a1h + re0, ms, 1.0f);
          put(a1h + re1, mc, 1.0f);
          put(a1h + im0, mc, -1.0f);
          put(a1h + im1, ms, 1.0f);
        }
        phy[phy_unit(pv, 2 * pc)] = make_float4(py[0].x, py[0].y, py[1].x, py[1].y);
        phy[phy_unit(pv, 2 * pc + 1)] = make_float4(py[2].x, py[2].y, py[3].x, py[3].y);
      };
      for (int j = 0; j < nt; ++j) {
        const int slot = j & 1;
        if (j >= 2) wait_bar(TT::kEmpty + slot);
        form_turned(j, ring + slot * TT::kSlot);
        fence_async_smem();
        bar_arrive(TT::kFull + slot, TT::kBarCount);
      }
      if constexpr (kProbe) probe_add(probe, tid, kCons, 0, 0, 0, waited);
      return;
    }

    // A consumer warpgroup takes every other tile: its 32 wgmma m64n128k8
    // (A its slot's rows, B the lhs's 128 rows (p, y)), rank 0 in three
    // passes and rank 1 hi·hi into the same accumulators. Accumulator
    // 4j + 2h + e holds A's row 16·warp + g + 8h, (v, re | im) with
    // v = 8·warp + g, and column 8j + 2t + e, (p, y) = (j / 4,
    // 8(j % 4) + 2t + e): D_re and D_im of one visibility at 8 y of each pol.
    const int ws = __shfl_sync(0xffffffffu, wg, 0);   // wg, warp-uniform: its slot and tiles
    const int vl = 8 * ((tid & 127) / 32) + (lane >> 2);
    const unsigned char* slot = ring + ws * TT::kSlot;
    const uint64_t a0h = smem_desc(slot, kLBO, TL::kSBO);
    const uint64_t a0l = smem_desc(slot + TT::kBytesA, kLBO, TL::kSBO);
    const uint64_t a1h = smem_desc(slot + 2 * TT::kBytesA, kLBO, TL::kSBO);
    const uint64_t b0h = smem_desc(lhs, kLBO, TL::kSBO);
    const uint64_t b0l = smem_desc(lhs + (size_t)group * TL::kBytesL, kLBO, TL::kSBO);
    const uint64_t b1h = smem_desc(lhs + TL::kBytesL, kLBO, TL::kSBO);
    const float4* phy = reinterpret_cast<const float4*>(slot + 3 * TT::kBytesA);
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    loop = probe_clock<kProbe>();
    for (int j = ws; j < nt; j += 2) {
      wait_bar(TT::kFull + ws);
      // the descriptors through an empty asm each tile, so that the k8
      // steps' 48 are not hoisted out of the loop beside the accumulators
      uint64_t da[3] = {a0h, a0l, a1h}, db[3] = {b0h, b0l, b1h};
#pragma unroll
      for (int i = 0; i < 3; ++i) asm volatile("" : "+l"(da[i]), "+l"(db[i]));
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TL::kK / 8; ++ks) {
        const uint64_t off = ks * 2 * 128 / 16;   // two K chunks a k8 step
        mma_tf32_step<true>(d, ks == 0, da[0] + off, da[1] + off, db[0] + off, db[1] + off);
      }
      if (w_rank > 1) {
#pragma unroll
        for (int ks = 0; ks < TL::kK / 8; ++ks) {
          const uint64_t off = ks * 2 * 128 / 16;
          wgmma_tf32(d, da[2] + off, db[2] + off, 1);
        }
      }
      wgmma_commit();
      // Φy at the thread's y = 8jj + 2·t4 and + 1, read while the products run
      float4 f[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) f[jj] = phy[phy_unit(vl, 4 * jj + t4)];
      wgmma_wait<0>();
      fence_regs(d);
      if (j + 2 < nt) bar_arrive(TT::kEmpty + ws, TT::kBarCount);
      // stage 2: Σ over the thread's 8 y of conj(Φy) · D, per pol
      float2 part[kPols];
#pragma unroll
      for (int p = 0; p < kPols; ++p) {
        float re = 0.0f, im = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* dj = d + 4 * (4 * p + jj);
          re = fmaf(f[jj].x, dj[0], fmaf(f[jj].y, dj[2], re));
          im = fmaf(f[jj].x, dj[2], fmaf(-f[jj].y, dj[0], im));
          re = fmaf(f[jj].z, dj[1], fmaf(f[jj].w, dj[3], re));
          im = fmaf(f[jj].z, dj[3], fmaf(-f[jj].w, dj[1], im));
        }
        part[p] = make_float2(re, im);
      }
      // the quad's sum over its 32 y: lanes t4 and t4 ^ 2 trade two pols,
      // then t4 and t4 ^ 1 one, which leaves lane t4 pol t4
      const bool b2 = t4 & 2, b1 = t4 & 1;
      float2 k0 = b2 ? part[2] : part[0], k1 = b2 ? part[3] : part[1];
      const float2 s0 = b2 ? part[0] : part[2], s1 = b2 ? part[1] : part[3];
      k0 = cadd(k0, make_float2(__shfl_xor_sync(0xffffffffu, s0.x, 2),
                                __shfl_xor_sync(0xffffffffu, s0.y, 2)));
      k1 = cadd(k1, make_float2(__shfl_xor_sync(0xffffffffu, s1.x, 2),
                                __shfl_xor_sync(0xffffffffu, s1.y, 2)));
      const float2 s = b1 ? k0 : k1;
      const float2 total = cadd(b1 ? k1 : k0, make_float2(__shfl_xor_sync(0xffffffffu, s.x, 1),
                                                          __shfl_xor_sync(0xffffffffu, s.y, 1)));
      const int v = j * kVT + vl;
      store_live(out_s + (size_t)v * kPols + t4, total, v < V);
    }
    loop = probe_clock<kProbe>() - loop;
  } else {
    // The ranks in groups that fit shared memory (one group up to rank 2);
    // per group: the prologue, then tile j multiplied while tile j + 1 is
    // formed and tile j − 1 stored, one barrier a tile.
    const int ngroups = (w_rank + group - 1) / group;
    for (int gi = 0; gi < ngroups; ++gi) {
      const int r0 = gi * group, nr = min(group, w_rank - r0);
      prologue(r0, nr);
      if (producer) {
        form(0, 0);
        fence_async_smem();
      }
      __syncthreads();
      [[maybe_unused]] const uint32_t t_loop = probe_clock<kProbe>();
      for (int j = 0; j < nt; ++j) {
        if (producer) {
          if (j > 0) store(j - 1, (j - 1) & 1, gi == 0);
          if (j + 1 < nt) form(j + 1, (j + 1) & 1);
          fence_async_smem();
        } else {
          consume(j & 1, r0, nr);
        }
        probed_sync<kProbe>(waited);
      }
      if constexpr (kProbe) loop += probe_clock<kProbe>() - t_loop;
      if (producer) store(nt - 1, (nt - 1) & 1, gi == 0);
    }
  }
  if constexpr (kProbe) {
    probe_add(probe, tid, kCons, probe_clock<kProbe>() - t_entry, k3_cycles, loop, waited);
  }
}

template <int N, bool kFuse, bool kProbe, bool kTurned>
cudaError_t launch(const float* uvw, const float* mu, const float* k, const float* po_x,
                   const float* po_y, const float* l, const float* m, const float* n,
                   const float* sph, const float2* aterms, const int* aterm_index,
                   const int* station1, const int* station2, const float2* subgrids,
                   const int* oyx, const float* wr, float2* out, unsigned long long* probe,
                   int S, int T, int C, int nr_stations, int w_rank, cudaStream_t stream) {
  using TL = Tile<N>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  // up to rank 2 the hi of each rank and the lo of rank 0 beside the two
  // stages (turned: the two slots); above it every rank takes hi and lo, in
  // groups of as many ranks as fit (all six at N = 16, two at N = 32)
  const size_t fixed = kTurned ? 2 * Turned::kSlot : 2 * TL::kStage + TL::kBytesRed;
  const int group = w_rank <= 2
      ? w_rank
      : min(w_rank, (int)(((size_t)optin - fixed) / (2 * TL::kBytesL)));
  const int nlo = w_rank > 2 ? group : 1;
  const size_t bytes = (size_t)(group + nlo) * TL::kBytesL + fixed;
  if (group < 1 || bytes > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(degridder_kernel<N, kFuse, kProbe, kTurned>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_kernel<N, kFuse, kProbe, kTurned><<<S, TL::kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, oyx, wr, out, probe, T, C, nr_stations, w_rank, group);
  return cudaGetLastError();
}

// The probed instance only for the fused form, and only given an accumulator;
// the turned product at N = 32 up to rank 2.
template <bool kFuse>
int dispatch(const void* uvw, const void* mu, const void* k, const void* po_x,
             const void* po_y, const void* l, const void* m, const void* n, const void* sph,
             const void* aterms, const void* aterm_index, const void* station1,
             const void* station2, const void* subgrids, const void* oyx, const void* wr,
             void* out, void* probe, int S, int T, int C, int N, int nr_stations, int w_rank,
             void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float*)mu, (const float*)k, (const float*)po_x,            \
      (const float*)po_y, (const float*)l, (const float*)m, (const float*)n,           \
      (const float*)sph, (const float2*)aterms, (const int*)aterm_index,               \
      (const int*)station1, (const int*)station2, (const float2*)subgrids,             \
      (const int*)oyx, (const float*)wr, (float2*)out,                                 \
      (unsigned long long*)probe, S, T, C, nr_stations, w_rank, st
  const bool probed = kFuse && probe != nullptr;
  switch (N) {
    case 16: return (int)(probed ? launch<16, kFuse, kFuse, false>(IDG_ARGS)
                                 : launch<16, kFuse, false, false>(IDG_ARGS));
    case 32:
      if (w_rank <= 2) {
        return (int)(probed ? launch<32, kFuse, kFuse, true>(IDG_ARGS)
                            : launch<32, kFuse, false, true>(IDG_ARGS));
      }
      return (int)(probed ? launch<32, kFuse, kFuse, false>(IDG_ARGS)
                          : launch<32, kFuse, false, false>(IDG_ARGS));
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}

}  // namespace

extern "C" int idg_degridder_v7(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* subgrids, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, void* stream) {
  return dispatch<false>(uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                         station1, station2, subgrids, nullptr, nullptr, out, nullptr, S, T,
                         C, N, nr_stations, w_rank, stream);
}

// The fused form: `pieces` are the range extraction's block-rolled pieces;
// a non-null `probe` (u64[kProbeFields], zeroed once by the caller)
// launches the probed instance, which adds the launch's phase cycles into it.
extern "C" int idg_degridder_v7_fused(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* pieces, const void* oyx, const void* wr, void* out, void* probe, int S,
    int T, int C, int N, int nr_stations, int w_rank, void* stream) {
  return dispatch<true>(uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                        station1, station2, pieces, oyx, wr, out, probe, S, T, C, N,
                        nr_stations, w_rank, stream);
}
