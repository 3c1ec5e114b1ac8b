// K1, gridder cuda_v6: visibilities -> subgrids c64[S, P, N, N], the
// separable product on the TF32 tensor cores (`wgmma`).
//
// Replaces idg_tpu/ops/pallas/gridder.py:_kernel_sep_recur_batch (launcher
// _gridder_sep_recur_batch_run, registered as gridder pallas_v6), non-fused
// form, and with kFuse the fused grid-stage epilogue (the `fuse` branch,
// gridder.py:942-992, registered as gridder_pallas_v6_pieces). It computes
// the same separable-phasor function:
//   pixel[y,x,p] = Σ_r n[y,x]^r · Σ_v lhs_r[v,y] · W[v,x,p]
//   lhs_r = Φy ⊛ (iμ)^r / r!,  W = Φx ⊛ vis
//   Φx[v,x] = e^{i(po_x[x] − l[x]·u_t·k_c)},  Φy[v,y] = e^{i(po_y[y] − m[y]·v_t·k_c)}
// then the Jones correction A1ᴴ·P·A2 and the spheroidal taper.
//
// What bounds it on an H100: the product, 4 real GEMMs of 2N × V × 2NP per
// subgrid and pass. At the default problem (rank 2, N = 32, V = 2048) it is
// 4 TF32 passes × 67.1 MFLOP × 24,500 subgrids = 6.6e12 FLOP, 13.3 ms at
// 495 TFLOP/s (2,050 cycles of each 32-visibility tile, 11,879 tiles an
// SM); around it ~5.8 M CUDA-core instructions a subgrid (131,072 exact
// sincosf, W, the lhs and their split), ~4 ms if alone. Its bytes (2.4 GB)
// take 0.72 ms. The reference's operation model (1.779e12 FLOP a pass) over
// the TF32 peak gives 3.594 ms, fused 3.699. On the card neither binds:
// builds of the transposed kernel that dropped a role (PERF.md §6) took,
// of its 46.6 ms fused, 42.1 with the producers alone, 32.4 with the
// consumers alone and 16.0 with neither (the barriers and the folds). The
// formation, on 8 producer warps that wait on their own latencies, set the
// pace (~7,710 cycles a tile), not the shared-memory data path.
//
// Design:
//  - At N = 32 the product is turned around, out[2N × 2NP] = lhs_rᵀ · W:
//    the lhs (64 rows (y, re | im)) is the m64 operand A, and W's 256 rows
//    (q = p·N + x, re | im) are B's columns, 128 for each of two consumer
//    warpgroups, m64n128k8: 32 wgmma a tile at rank 2 where the transposed
//    form took 64 m64n64k8 (four warpgroups, each reading all of the lhs).
//    The tensor cores read 192 KB of operands a tile instead of 256 KB; the
//    producers store the same 88 KB; the fold's weights n[y][x], 8 a thread,
//    stay in registers instead of 512 L1 wavefronts a tile, so a tile moves
//    ~280 KB through the L1/shared data path where it moved ~420 KB. Both
//    operands keep W's layout (wgmma.cuh's core matrices), A's and B's
//    8-row groups alternating between the real and the imaginary parts, so
//    a thread's accumulators hold all four real products of its outputs.
//    N = 16 keeps the transposed form, outᵀ = Wᵀ · lhs_r (a 64-row slab of
//    W a warpgroup, lhs rows (re | im)·N + y): its lhs has 32 rows and
//    cannot fill an m64 operand. wgmma.cuh's helpers for it:
//    wgmma_tf32 on D 64×128, the m64n128k8 step, and split_tf32_bits,
//    split_tf32's values on the integer pipe (below).
//  - TF32 in three passes: x = hi + lo, hi = tf32(x), lo = tf32(x − hi),
//    and lo·hi + hi·lo + hi·hi into float32 (~22 bits of each operand, so
//    gridder_plain, float32 "highest", stays the reference), or hi·hi
//    alone for a Taylor term small enough (2^-10 of it): the ranks below
//    the host's `three_ranks` (ops/precision.py:gridder_three_pass_ranks)
//    take three. Rank 0 always does; rank 1 at rank ≤ 2 does not (|μ·n| <
//    2.5e-3 of the signal); above rank 2 the highest ranks take one pass
//    while the staged rows' |μ·n| bound keeps their summed error under the
//    guard's 3e-6 (at |μ·n| 0.169 and rank 5, ranks 3 and 4: 11 passes a
//    tile instead of 15). The producers store lo by wgmma.cuh's
//    three_passes (every rank of an escalated product), whether the
//    consumers read it or not: with k1_three_passes there, the fused
//    N = 32 instance took 128 registers and spilled 20 B.
//  - The tensor cores' float32 accumulation truncates, so each tile's sum
//    (32 visibilities) is folded into a running sum in round-to-nearest
//    FADDs, with the rank combine Σ_r n^r folded in: the running sum is one
//    complex value per output pixel and pol (16 a thread at N = 32, 4 at
//    N = 16, in registers), whatever the rank. One rank's accumulators (64
//    or 16 registers) are live at a time: ranks are issued, waited for and
//    folded one after another.
//  - The phasors without control flow: CUDA's sincosf is a fast path and a
//    Payne–Hanek branch for |x| ≥ 105,615, so each call was a branch
//    diamond that ptxas does not schedule across, and a producer's 8 a tile
//    ran one after another. A producer loads uvw and k and forms the phases
//    of its 4 visibilities first, then evaluates Φx's four with
//    common.cuh:sincosf_block (sincosf's own fast path as straight-line
//    code, the same values bit for bit, then one warp-uniform branch to
//    sincosf for a phase it cannot take: never in the problems run, whose
//    phases stay below ~1.3e4 rad), then Φy's four the same way. Eight in
//    one block pushed the fused form to 128 registers and a spill (or, with
//    the spill cured, ran slower); four at a time, none.
//  - Warp specialization, so that the formation of the next tile overlaps
//    the products of this one: one block per subgrid holds the consumer
//    warpgroups, which issue the products and fold them, and after them
//    N·8 producer threads, which form the tiles (512 threads at N = 32, 128
//    registers and no spill; 384 at N = 16, 80 registers). A producer owns
//    one x and one y and 4 visibilities: two exact sincosf each (no fast
//    math), W = Φx · vis for the four pols, the lhs of every rank, and
//    their split (at N = 32 on the bits, wgmma.cuh:split_tf32_bits: the
//    same values in five instructions instead of nine). At N = 32
//    each role runs its own tile loop and the producers leave after theirs,
//    so that the consumers' 64 accumulators, 32 running sums and 8 weights
//    fit ptxas's 128 registers: setmaxnreg cannot lend them the producers'
//    (ptxas keeps every instruction under the launch bound's registers),
//    which keeps both a third producer warpgroup and wgmma's A from
//    registers (32 more) out. The roles come through a warp shuffle and the
//    formation branches on nothing else of the thread (selects mask the
//    ragged tile): ptxas serializes wgmma around a divergent path. One
//    barrier a tile hands the stages over: two stages fit 227 KB of shared
//    memory up to rank 3 at N = 32; above that the formation follows the
//    products. The visibilities and μ arrive by cp.async into a two-slot
//    ring a tile ahead of the formation; uvw and k (< 2 KB a subgrid) are
//    read through L1.
//  - Operands in shared memory as unswizzled 8×16 B core matrices
//    (wgmma.cuh), written by 16-byte stores with consecutive lanes on
//    consecutive rows, so neither the formation nor the tensor cores meet
//    bank conflicts.
//  - On the card (default problem, H100, PERF.md §6) the fused form takes
//    32.9 ms, ~5,480 cycles a tile, non-fused 31.8 (with a branch in each
//    sincosf: 36.4 and 34.8; transposed: 46.3 fused, ~7,710 cycles). Builds
//    of the turned form with its branchy sincosf that dropped a role took
//    29.5 ms with the producers alone, 23.9 with the consumers alone and
//    10.8 with neither, so the formation set the pace, though the phase
//    probes read the tensor-core warps waiting only 0.78% of the tile loop
//    at its barriers (0.25% transposed).

// Fused epilogue (kFuse): the Jones/taper epilogue writes the subgrid split
// into K3's operand (dft.cuh), and K3 applies the inverse folded-shift DFT
// to all four pols at once on the TF32 tensor cores, on the first two
// warpgroups (one at N = 16) while the others are done; its store rolls the
// result by (oy, ox) = oyx[s] as an exact index permutation,
// piece[(y+oy)%N][(x+ox)%N] = idft[y][x]. The TPU kernel put the roll on the
// tile as Fourier phases for its layout's sake (grid.py:389-397); an index
// on the store is exact and free here. The epilogue's pixels (rows padded),
// K3's operand and its factors take 130 KB at N = 32: the smallest block
// (rank 4, one stage and the raw slots, both free by then) has that. K3's
// factors come split from the host by cp.async, started before the
// epilogue's pixels are formed. At N = 32 the consumers alone run the
// epilogue and K3, meeting at a named barrier.
//
// Phase probes (kProbe, the fused form only; probe.cuh): the entry point
// given an accumulator launches the probed instance, which sums each
// block's cycles from entry to exit, in K3 (from the barrier before its
// products to the end of its stores), in the tile loop, and waiting at the
// loop's barriers, on consumer warp 0 (`tc_wait`: the tensor-core warps
// waiting for the formation) and on the first producer warp (`form_wait`).

#include <cuda_runtime.h>

#include "common.cuh"
#include "dft.cuh"
#include "probe.cuh"
#include "wgmma.cuh"

namespace {

using idg::kPols;

constexpr int kKT = 32;                  // visibilities a tile: four k8 steps
constexpr int kKC = kKT / 4;             // 4-wide K chunks of an operand row
constexpr uint32_t kLBO = 128;           // the next K chunk's core matrix
constexpr uint32_t kSBO = kKC * 128;     // the next 8-row group's
constexpr int kRawBytes = kKT * kPols * (int)sizeof(float2) + kKT * (int)sizeof(float);

template <int N>
struct Tile {
  // At N = 32 the product is turned around, out = lhs_rᵀ · W: the lhs is the
  // 64-row operand and W the 256 columns, split over two warpgroups. At
  // N = 16 the lhs has 32 rows and W stays the 64-row operand (outᵀ = Wᵀ ·
  // lhs_r, a 64-row slab of W a warpgroup).
  static constexpr bool kTurned = N == 32;
  static constexpr int kRowsW = 2 * N * kPols;   // W: (q = p·N + x, re | im)
  static constexpr int kRowsL = 2 * N;           // lhs_r: (re | im)·N + y, or (y, re | im) turned
  static constexpr int kGroups = kTurned ? 2 : kRowsW / 64;   // consumer warpgroups
  static constexpr int kConsumers = 128 * kGroups;  // the products and the fold
  static constexpr int kProducers = N * kKC;        // the formation: one (a, K chunk) each
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMinBlocks = N == 16 ? 2 : 1;
  static constexpr int kColsW = kRowsW / kGroups;   // W's columns a warpgroup, turned
  // accumulator floats a thread, a rank
  static constexpr int kAcc = kTurned ? 64 * kColsW / 128 : 64 * kRowsL / 128;
  static constexpr int kOut = N * N * kPols / kConsumers;   // complex outputs a thread
  static_assert(!kTurned || kRowsL == 64, "the turned product's lhs fills one m64 operand");
  static constexpr int kBytesW = kRowsW * kKT * 4;  // one of hi, lo
  static constexpr int kBytesL = kRowsL * kKT * 4;  // one of hi, lo, a rank
  // a stage: W hi, W lo, then the lhs hi of every rank, then their lo
  __host__ __device__ static constexpr size_t stage_bytes(int rank) {
    return 2 * (size_t)kBytesW + 2 * (size_t)rank * kBytesL;
  }
  // the fused epilogue's pixels [P][N][kLdPix] (rows padded, so that
  // neither the consumers' stores nor the epilogue's reads meet 4-way bank
  // conflicts), then K3's operand and factors
  static constexpr int kLdPix = N + 2;
  static constexpr size_t kBytesPix = (size_t)kPols * N * kLdPix * sizeof(float2);
  static constexpr size_t kEpilogueBytes = kBytesPix + idg::Dft<N>::kBytes;
  // the smallest block at N = 32: rank 4, one stage and the raw slots
  static_assert(kEpilogueBytes <= 2 * (size_t)kBytesW + 2 * 4 * (size_t)kBytesL + 2 * kRawBytes,
                "the fused epilogue fits one stage");
  static_assert(kBytesPix % 128 == 0, "K3's operand stays 128-byte aligned");
  static_assert(idg::Dft<N>::kGroups * 128 <= kConsumers, "K3 runs on consumer warpgroups");
};

// Whether Taylor rank r takes three TF32 passes (else hi·hi alone): the
// host's rule (ops/precision.py:gridder_three_pass_ranks) gives three to
// the lowest ranks, so K1 takes their count. The consumers' rule; K2 and the
// bf16 rungs keep wgmma.cuh:three_passes.
__device__ __forceinline__ bool k1_three_passes(int r, int three_ranks) {
  return r < three_ranks;
}

// Rank r's products over one tile of the stage at `stage`, this
// warpgroup's slab, into acc (three TF32 passes, or hi·hi alone), inside the
// caller's commit group.
template <int N, bool kThree>
__device__ __forceinline__ void mma_rank(const unsigned char* stage, int slab, int r,
                                         int w_rank, float (&acc)[Tile<N>::kAcc]) {
  using TL = Tile<N>;
  const unsigned char* w_hi = stage + slab * 8 * kSBO;
  const unsigned char* l_hi = stage + 2 * TL::kBytesW + (size_t)r * TL::kBytesL;
#pragma unroll
  for (int ks = 0; ks < kKT / 8; ++ks) {
    const int off = ks * 2 * 128;   // two K chunks a k8 step
    idg::mma_tf32_step<kThree>(
        acc, ks == 0, idg::smem_desc(w_hi + off, kLBO, kSBO),
        idg::smem_desc(w_hi + TL::kBytesW + off, kLBO, kSBO), idg::smem_desc(l_hi + off, kLBO, kSBO),
        idg::smem_desc(l_hi + (size_t)w_rank * TL::kBytesL + off, kLBO, kSBO));
  }
}

// The same turned around (Tile<N>::kTurned): A = lhs_r, B = warpgroup wg's
// half of W's rows as its columns, m64n128k8. The steps' descriptors are the
// first ones plus the steps' offsets (the address field is the byte address
// / 16 and stays below 2^14).
template <int N, bool kThree>
__device__ __forceinline__ void mma_rank_turned(const unsigned char* stage, int wg, int r,
                                                int w_rank, float (&acc)[Tile<N>::kAcc]) {
  using TL = Tile<N>;
  const unsigned char* l_hi = stage + 2 * TL::kBytesW + (size_t)r * TL::kBytesL;
  const unsigned char* w_hi = stage + wg * (TL::kColsW / 8) * kSBO;
  const uint64_t ah = idg::smem_desc(l_hi, kLBO, kSBO);
  const uint64_t al = idg::smem_desc(l_hi + (size_t)w_rank * TL::kBytesL, kLBO, kSBO);
  const uint64_t bh = idg::smem_desc(w_hi, kLBO, kSBO);
  const uint64_t bl = idg::smem_desc(w_hi + TL::kBytesW, kLBO, kSBO);
#pragma unroll
  for (int ks = 0; ks < kKT / 8; ++ks) {
    const uint64_t off = ks * 2 * 128 / 16;   // two K chunks a k8 step
    idg::mma_tf32_step<kThree>(acc, ks == 0, ah + off, al + off, bh + off, bl + off);
  }
}

// The turned fold: wait for this warpgroup's products of rank r and add
// them into the running sum, weighted by n^r. A's rows (y, re | im) and B's
// columns (q, re | im) both alternate by groups of 8, so accumulator
// 4j + 2h + e holds row y = 8·warp + g (h: re | im), column 8j + 2t + e:
// q = 64·wg + 8(j / 2) + 2t + e (j & 1: re | im). out = (AreBre − AimBim) +
// i(AreBim + AimBre) lands in sum[2i + e], q = 64·wg + 8i + 2t + e, and
// nw[2(i % 4) + e] is n[y][x] of its x = q % 32, held through the tile loop.
__device__ __forceinline__ void fold_rank_turned(int r, const float (&nw)[8], float (&acc)[64],
                                                 float2 (&sum)[16]) {
  float w[8];   // n^r, formed while the products run
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = 1.0f;
    for (int q = 0; q < r; ++q) w[i] *= nw[i];
  }
  idg::wgmma_wait<0>();
  idg::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float re = acc[8 * i + e] - acc[8 * i + 6 + e];
      const float im = acc[8 * i + 4 + e] + acc[8 * i + 2 + e];
      sum[2 * i + e].x = fmaf(w[2 * (i & 3) + e], re, sum[2 * i + e].x);
      sum[2 * i + e].y = fmaf(w[2 * (i & 3) + e], im, sum[2 * i + e].y);
    }
  }
}

template <int N, bool kFuse, bool kProbe>
__global__ void __launch_bounds__(Tile<N>::kThreads, Tile<N>::kMinBlocks) gridder_kernel(
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
    const int* __restrict__ oyx,            // [S, 2] (kFuse only)
    const float* __restrict__ wr,           // [2, 2N, 2N] K3's split factors, inverse (kFuse only)
    float2* __restrict__ out,               // [S, P, N, N] subgrids, or pieces with kFuse
    unsigned long long* __restrict__ probe, // [kProbeFields] phase cycles (kProbe only)
    int T, int C, int nr_stations, int w_rank, int three_ranks, int stages) {
  using namespace idg;
  using TL = Tile<N>;
  constexpr int kThreads = TL::kThreads;
  constexpr int kCons = TL::kConsumers;
  constexpr int kProd = TL::kProducers;
  [[maybe_unused]] const uint32_t t_entry = probe_clock<kProbe>();
  [[maybe_unused]] uint32_t loop = 0, waited = 0, k3_cycles = 0;   // kProbe's sums
  [[maybe_unused]] uint32_t form_tiles = 0, form_fast = 0;          // and counts (producers)

  extern __shared__ __align__(128) unsigned char smem[];
  const size_t stage_bytes = TL::stage_bytes(w_rank);
  unsigned char* raw = smem + stages * stage_bytes;   // two slots: vis [kKT][P], μ [kKT]

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int V = T * C;
  const int nt = (V + kKT - 1) / kKT;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float2* vis_s = vis + (size_t)s * V * kPols;
  const float* mu_s = mu + (size_t)s * V;

  // Roles: the warpgroups first issue the products and fold them (the
  // consumers); the warps after them form the tiles (the producers), so no
  // warp that issues a wgmma has the formation in its way. The role comes
  // through a warp shuffle, so the compiler knows it is uniform in a warp:
  // ptxas serializes wgmma around a divergent path (C7520). A producer owns
  // one row position a (x for W, y for the lhs) and one K chunk.
  const bool producer = __shfl_sync(0xffffffffu, tid >= kCons ? 1 : 0, 0) != 0;
  const int ptid = tid - kCons;
  const int a = ptid % N, kc = ptid / N;
  float pox = 0.0f, lx = 0.0f, poy = 0.0f, my = 0.0f;
  if (producer) {
    pox = po_x[(size_t)s * N + a];
    lx = l[a];
    poy = po_y[(size_t)s * N + a];
    my = m[a];
  }

  auto stage_raw = [&](int tile, int slot) {
    const int v0 = tile * kKT, nv = min(kKT, V - v0);
    unsigned char* dst = raw + slot * kRawBytes;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(vis_s + (size_t)v0 * kPols);
    for (int e = ptid; e < nv * 2; e += kProd) cp_async16(dst + e * 16, src + e * 16);
    float* dmu = reinterpret_cast<float*>(dst + kKT * kPols * sizeof(float2));
    for (int e = ptid; e < nv; e += kProd) cp_async4(dmu + e, mu_s + v0 + e);
    cp_async_commit();
  };

  // One producer's share of a tile: Φx and Φy of its a at its 4
  // visibilities (0 past V, by selects), W = Φx · vis for the 4 pols, rows
  // (q = p·N + a, re | im), and the lhs of every rank, Φy · (iμ)^r/r!, rows
  // (re | im)·N + a, or turned (a, re | im).
  auto form = [&](int tile, int slot, int buf) {
    // turned, the split on the bits (the same values in fewer instructions)
    const auto split = [](float x, float& hi, float& lo) {
      if constexpr (TL::kTurned) {
        split_tf32_bits(x, hi, lo);
      } else {
        split_tf32(x, hi, lo);
      }
    };
    const int v0 = tile * kKT, nv = min(kKT, V - v0);
    float* base = reinterpret_cast<float*>(smem + buf * stage_bytes);
    const float2* rvis = reinterpret_cast<const float2*>(raw + slot * kRawBytes);
    const float* rmu = reinterpret_cast<const float*>(rvis + kKT * kPols);
    float2 phx[4], phy[4], coef[4];
    float mu_i[4], ax[4], ay[4], sx[4], cx[4], sy[4], cy[4];
    bool live[4];
    int t = (v0 + kc * 4) / C, c = v0 + kc * 4 - t * C;
    // the phases of all four first, then their phasors: Φx's four, then
    // Φy's, each as one straight block with one branch after it (above)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      live[i] = kc * 4 + i < nv;
      const float* uvw_t = uvw_s + min(t, T - 1) * 3;
      const float kv = __ldg(k + c);
      ax[i] = pox - lx * (__ldg(uvw_t) * kv);
      ay[i] = poy - my * (__ldg(uvw_t + 1) * kv);
      mu_i[i] = live[i] ? rmu[kc * 4 + i] : 0.0f;
      coef[i] = make_float2(1.0f, 0.0f);
      const bool wrap = ++c == C;
      c = wrap ? 0 : c;
      t += wrap;
    }
    [[maybe_unused]] const bool fallback_x = sincosf_block(ax, sx, cx);
    [[maybe_unused]] const bool fallback_y = sincosf_block(ay, sy, cy);
    if constexpr (kProbe) {
      ++form_tiles;
      form_fast += fallback_x || fallback_y ? 0u : 1u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      phx[i] = live[i] ? make_float2(cx[i], sx[i]) : make_float2(0.0f, 0.0f);
      phy[i] = live[i] ? make_float2(cy[i], sy[i]) : make_float2(0.0f, 0.0f);
    }
    float* w_hi = base;
    float* w_lo = base + TL::kBytesW / 4;
#pragma unroll
    for (int p = 0; p < kPols; ++p) {
      float rh[4], rl[4], ih[4], il[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // past V: zeros, whatever the stale slot held (turned, by one select
        // of the visibility: Φx is 0 there, so the product is +0 as well)
        const float2 v = rvis[(kc * 4 + i) * kPols + p];
        const float2 w = cmul(phx[i], TL::kTurned && !live[i] ? make_float2(0.0f, 0.0f) : v);
        split(w.x, rh[i], rl[i]);
        split(w.y, ih[i], il[i]);
        if constexpr (!TL::kTurned) {
          rh[i] = live[i] ? rh[i] : 0.0f;
          rl[i] = live[i] ? rl[i] : 0.0f;
          ih[i] = live[i] ? ih[i] : 0.0f;
          il[i] = live[i] ? il[i] : 0.0f;
        }
      }
      const int q = p * N + a, row = (q >> 3) * 16 + (q & 7);
      const int re = core_index(row, kc * 4, kKC), im = core_index(row + 8, kc * 4, kKC);
      *reinterpret_cast<float4*>(w_hi + re) = make_float4(rh[0], rh[1], rh[2], rh[3]);
      *reinterpret_cast<float4*>(w_lo + re) = make_float4(rl[0], rl[1], rl[2], rl[3]);
      *reinterpret_cast<float4*>(w_hi + im) = make_float4(ih[0], ih[1], ih[2], ih[3]);
      *reinterpret_cast<float4*>(w_lo + im) = make_float4(il[0], il[1], il[2], il[3]);
    }
    float* l_hi = base + 2 * TL::kBytesW / 4;
    float* l_lo = l_hi + (size_t)w_rank * TL::kBytesL / 4;
    // turned: 8 y of the real part, then the same 8 y of the imaginary
    const int row = TL::kTurned ? (a >> 3) * 16 + (a & 7) : a;
    const int re = core_index(row, kc * 4, kKC);
    const int im = core_index(TL::kTurned ? row + 8 : N + a, kc * 4, kKC);
#pragma unroll
    for (int r = 0; r < kMaxWRank; ++r) {
      if (r < w_rank) {
        float rh[4], rl[4], ih[4], il[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 lv = cmul(phy[i], coef[i]);
          split(lv.x, rh[i], rl[i]);
          split(lv.y, ih[i], il[i]);
          // (iμ)^{r+1}/(r+1)! = (iμ)^r/r! · iμ/(r+1), by a constant
          // reciprocal: a division would branch on the data
          const float g = mu_i[i] * (1.0f / (r + 1));
          coef[i] = make_float2(-coef[i].y * g, coef[i].x * g);
        }
        float* hi = l_hi + (size_t)r * TL::kBytesL / 4;
        *reinterpret_cast<float4*>(hi + re) = make_float4(rh[0], rh[1], rh[2], rh[3]);
        *reinterpret_cast<float4*>(hi + im) = make_float4(ih[0], ih[1], ih[2], ih[3]);
        if (idg::three_passes(r, w_rank)) {   // not k1_three_passes: see the header
          float* lo = l_lo + (size_t)r * TL::kBytesL / 4;
          *reinterpret_cast<float4*>(lo + re) = make_float4(rl[0], rl[1], rl[2], rl[3]);
          *reinterpret_cast<float4*>(lo + im) = make_float4(il[0], il[1], il[2], il[3]);
        }
      }
    }
  };

  // the consumer's outputs (fold) and its warpgroup's slab; turned, the
  // accumulators and running sums live in the consumers' branch alone
  const int q_out = tid >> 2, t4 = tid & 3;
  const int x_out = q_out % N, p_out = q_out / N;
  const int slab = tid / 128;
  float acc[TL::kAcc];
  float2 sum[TL::kOut];
  if constexpr (!TL::kTurned) {
#pragma unroll
    for (int i = 0; i < TL::kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int o = 0; o < TL::kOut; ++o) sum[o] = make_float2(0.0f, 0.0f);
  }
  constexpr int kLdPix = kFuse ? TL::kLdPix : N;
  float2* s_pix = reinterpret_cast<float2*>(smem);   // the epilogue's pixels, over stage 0

  // prologue: the raw data of tiles 0 and 1, then tile 0 formed in stage 0
  if (producer) {
    stage_raw(0, 0);
    if (nt > 1) stage_raw(1, 1);
    cp_async_wait_all();
  }
  __syncthreads();
  if (producer) {
    form(0, 0, 0);
    fence_async_smem();
  }
  __syncthreads();

  // Tile j: the consumers multiply and fold it while the producers form
  // tile j + 1 in the other stage (after it, with one stage). Turned, each
  // role runs its own loop and the producers leave after theirs: the
  // consumers alone run the epilogue, and their accumulators, running sums
  // and weights live in their branch alone, so that they fit ptxas's 128
  // registers without a spill.
  if constexpr (TL::kTurned) {
    if (producer) {
      for (int j = 0; j < nt; ++j) {
        if (j + 2 < nt) stage_raw(j + 2, j & 1);
        if (stages == 2 && j + 1 < nt) form(j + 1, (j + 1) & 1, (j + 1) & 1);
        cp_async_wait_all();
        fence_async_smem();
        probed_sync<kProbe>(waited);
        if (stages == 1 && j + 1 < nt) {
          form(j + 1, (j + 1) & 1, 0);
          fence_async_smem();
          probed_sync<kProbe>(waited);
        }
      }
      if constexpr (kProbe) {
        probe_add(probe, tid, kCons, probe_clock<kProbe>() - t_entry, 0, 0, waited);
        probe_add_form(probe, tid, form_tiles, form_fast);
      }
      return;
    }
    {
      // this thread's outputs: y, and x = 8(i % 4) + 2·t4 + e of pol
      // 2·slab + i / 4 in sum[2i + e]; nw[2(i % 4) + e] = n[y][x]
      const int y = (tid & 127) / 32 * 8 + (tid & 31) / 4;
      float nw[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) nw[i] = n[y * N + 8 * (i / 2) + 2 * t4 + i % 2];
#pragma unroll
      for (int i = 0; i < TL::kAcc; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int o = 0; o < TL::kOut; ++o) sum[o] = make_float2(0.0f, 0.0f);
      loop = probe_clock<kProbe>();
      for (int j = 0; j < nt; ++j) {
        const unsigned char* stage = smem + (j % stages) * stage_bytes;
        for (int r = 0; r < w_rank; ++r) {
          fence_regs(acc);
          wgmma_fence();
          if (k1_three_passes(r, three_ranks)) {
            mma_rank_turned<N, true>(stage, slab, r, w_rank, acc);
          } else {
            mma_rank_turned<N, false>(stage, slab, r, w_rank, acc);
          }
          wgmma_commit();
          fold_rank_turned(r, nw, acc, sum);
        }
        probed_sync<kProbe>(waited);
        if (stages == 1 && j + 1 < nt) probed_sync<kProbe>(waited);
      }
      loop = probe_clock<kProbe>() - loop;
      // every stage is free: the running sums into the epilogue's pixels
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 2 * slab + i / 4, x = 8 * (i & 3) + 2 * t4 + e;
          s_pix[(p * N + y) * kLdPix + x] = sum[2 * i + e];
        }
      }
    }
  } else {
    loop = probe_clock<kProbe>();
    for (int j = 0; j < nt; ++j) {
      if (producer) {
        // raw slot j & 1 held tile j's data, formed before the last barrier
        if (j + 2 < nt) stage_raw(j + 2, j & 1);
        if (stages == 2 && j + 1 < nt) form(j + 1, (j + 1) & 1, (j + 1) & 1);
        cp_async_wait_all();
        fence_async_smem();
      } else {
        const unsigned char* stage = smem + (j % stages) * stage_bytes;
        for (int r = 0; r < w_rank; ++r) {
          fence_regs(acc);
          wgmma_fence();
          if (k1_three_passes(r, three_ranks)) {
            mma_rank<N, true>(stage, slab, r, w_rank, acc);
          } else {
            mma_rank<N, false>(stage, slab, r, w_rank, acc);
          }
          wgmma_commit();
          fold_rank<N>(r, n, x_out, t4, acc, sum);
        }
      }
      probed_sync<kProbe>(waited);
      if (stages == 1 && j + 1 < nt) {
        if (producer) {
          form(j + 1, (j + 1) & 1, 0);
          fence_async_smem();
        }
        probed_sync<kProbe>(waited);
      }
    }
    loop = probe_clock<kProbe>() - loop;
  }

  // epilogue: the running sums into shared memory as [P][N][N] (rows of
  // kLdPix with kFuse; turned, the consumers stored them), then per pixel
  // A1ᴴ · P · A2 (math.hpp:64-77) and the taper, on kEpi threads: turned,
  // the consumers alone, which meet at a named barrier. The fused form
  // first starts the copy of K3's factors.
  constexpr int kEpi = TL::kTurned ? kCons : kThreads;
  auto epi_sync = [] {
    if constexpr (TL::kTurned) {
      bar_sync(2, kCons);
    } else {
      __syncthreads();
    }
  };
  if constexpr (kFuse) {
    dft_load_factors<N, kEpi>(wr, smem + TL::kBytesPix + 2 * Dft<N>::kBytesX, tid);
  }
  if constexpr (!TL::kTurned) {
    if (!producer) {
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int y = 8 * jj + 2 * t4 + e;
          s_pix[(p_out * N + y) * kLdPix + x_out] = sum[2 * jj + e];
        }
      }
    }
  }
  epi_sync();
  const size_t nn = (size_t)N * N;
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  if constexpr (!kFuse) {
    for (int q = tid; q < N * N; q += kEpi) {
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
  } else {
    // K3 (dft.cuh): the epilogue's pixels split into its operand X [(p, y)]
    // [(re | im, x)] after them, a warp on 8 y × 4 x (no bank conflicts),
    // while its factors arrive beside it; then the inverse DFT of all four
    // pols on the first Dft<N>::kGroups warpgroups, stored rolled
    using D = Dft<N>;
    float* x_hi = reinterpret_cast<float*>(smem + TL::kBytesPix);
    float* x_lo = x_hi + D::kBytesX / 4;
    const float* w_hi = x_lo + D::kBytesX / 4;
    for (int e = tid; e < N * N; e += kEpi) {
      const int x = ((e >> 5) % (N / 4)) * 4 + (e & 3);
      const int y = ((e >> 5) / (N / 4)) * 8 + ((e >> 2) & 7);
      const int q = y * N + x;
      float2 px[kPols], o[kPols];
#pragma unroll
      for (int p = 0; p < kPols; ++p) px[p] = s_pix[(p * N + y) * kLdPix + x];
      jones_gridder(aterms + (at1 + q) * kPols, aterms + (at2 + q) * kPols, px, o);
      const float taper = sph[q];
#pragma unroll
      for (int p = 0; p < kPols; ++p) {
        dft_store_x<N>(x_hi, x_lo, p, y, x, make_float2(o[p].x * taper, o[p].y * taper));
      }
    }
    cp_async_wait_all();
    fence_async_smem();
    epi_sync();
    k3_cycles = probe_clock<kProbe>();
    const bool k3 = __shfl_sync(0xffffffffu, tid < 128 * D::kGroups ? 1 : 0, 0) != 0;
    if (k3) {
      // the roll is taken mod N, as the plain version takes it: no index leaves the tile
      const int oy = (oyx[2 * s] % N + N) % N, ox = (oyx[2 * s + 1] % N + N) % N;
      float2* out_s = out + (size_t)s * kPols * nn;
      if constexpr (TL::kTurned) {
        // K3's accumulators: the first of acc, dead since the loop
#pragma unroll
        for (int i = 0; i < Dft<N>::kAcc; ++i) acc[i] = 0.0f;
      }
      dft2_products<N>(reinterpret_cast<unsigned char*>(x_hi),
                       reinterpret_cast<const unsigned char*>(w_hi), tid / 128, tid % 128,
                       acc, [&](int p, int y, int x, float2 v) {
                         out_s[p * nn + ((y + oy) & (N - 1)) * N + ((x + ox) & (N - 1))] = v;
                       });
    }
    k3_cycles = probe_clock<kProbe>() - k3_cycles;
  }
  if constexpr (kProbe) {
    probe_add(probe, tid, kCons, probe_clock<kProbe>() - t_entry, k3_cycles, loop, waited);
    if (producer) probe_add_form(probe, tid, form_tiles, form_fast);
  }
}

template <int N, bool kFuse, bool kProbe>
cudaError_t launch(const float* uvw, const float2* vis, const float* mu, const float* k,
                   const float* po_x, const float* po_y, const float* l, const float* m,
                   const float* n, const float* sph, const float2* aterms,
                   const int* aterm_index, const int* station1, const int* station2,
                   const int* oyx, const float* wr, float2* out, unsigned long long* probe,
                   int S, int T, int C, int nr_stations, int w_rank, int three_ranks,
                   cudaStream_t stream) {
  using TL = Tile<N>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  // two stages where they fit (up to rank 3 at N = 32), else one
  const size_t stage = TL::stage_bytes(w_rank), raw = 2 * (size_t)kRawBytes;
  const int stages = 2 * stage + raw <= (size_t)optin ? 2 : 1;
  size_t bytes = stages * stage + raw;
  // the fused epilogue reuses the stages (and, past them, the raw slots)
  if (kFuse && bytes < TL::kEpilogueBytes) bytes = TL::kEpilogueBytes;
  err = cudaFuncSetAttribute(gridder_kernel<N, kFuse, kProbe>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  gridder_kernel<N, kFuse, kProbe><<<S, TL::kThreads, bytes, stream>>>(
      uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1,
      station2, oyx, wr, out, probe, T, C, nr_stations, w_rank, three_ranks, stages);
  return cudaGetLastError();
}

// The probed instance only for the fused form, and only given an accumulator.
template <bool kFuse>
int dispatch(const void* uvw, const void* vis, const void* mu, const void* k,
             const void* po_x, const void* po_y, const void* l, const void* m,
             const void* n, const void* sph, const void* aterms, const void* aterm_index,
             const void* station1, const void* station2, const void* oyx, const void* wr,
             void* out, void* probe, int S, int T, int C, int N, int nr_stations, int w_rank,
             int three_ranks, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank ||
      three_ranks < 1 || three_ranks > w_rank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float2*)vis, (const float*)mu, (const float*)k,            \
      (const float*)po_x, (const float*)po_y, (const float*)l, (const float*)m,        \
      (const float*)n, (const float*)sph, (const float2*)aterms,                       \
      (const int*)aterm_index, (const int*)station1, (const int*)station2,             \
      (const int*)oyx, (const float*)wr, (float2*)out,                                 \
      (unsigned long long*)probe, S, T, C, nr_stations, w_rank, three_ranks, st
  const bool probed = kFuse && probe != nullptr;
  switch (N) {
    case 16: return (int)(probed ? launch<16, kFuse, kFuse>(IDG_ARGS)
                                 : launch<16, kFuse, false>(IDG_ARGS));
    case 32: return (int)(probed ? launch<32, kFuse, kFuse>(IDG_ARGS)
                                 : launch<32, kFuse, false>(IDG_ARGS));
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}

}  // namespace

extern "C" int idg_gridder_v6(
    const void* uvw, const void* vis, const void* mu, const void* k, const void* po_x,
    const void* po_y, const void* l, const void* m, const void* n, const void* sph,
    const void* aterms, const void* aterm_index, const void* station1,
    const void* station2, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, int three_ranks, void* stream) {
  return dispatch<false>(uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                         station1, station2, nullptr, nullptr, out, nullptr, S, T, C, N,
                         nr_stations, w_rank, three_ranks, stream);
}

// The fused form: `out` receives the block-rolled image-domain pieces; a
// non-null `probe` (u64[kProbeFields], zeroed once by the caller) launches
// the probed instance, which adds the launch's phase cycles into it.
extern "C" int idg_gridder_v6_pieces(
    const void* uvw, const void* vis, const void* mu, const void* k, const void* po_x,
    const void* po_y, const void* l, const void* m, const void* n, const void* sph,
    const void* aterms, const void* aterm_index, const void* station1,
    const void* station2, const void* oyx, const void* wr, void* out, void* probe, int S,
    int T, int C, int N, int nr_stations, int w_rank, int three_ranks, void* stream) {
  return dispatch<true>(uvw, vis, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                        station1, station2, oyx, wr, out, probe, S, T, C, N, nr_stations,
                        w_rank, three_ranks, stream);
}
