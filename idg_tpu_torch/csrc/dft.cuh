// K3: the folded-shift 2-D (i)DFT of the four pols of one subgrid on the
// TF32 tensor cores (`wgmma`), inside the fused gridder K1 (the epilogue,
// gridder.cu) and the fused degridder K2 (the prologue, degridder.cu):
//   out_p[k1][k2] = Σ_y Σ_x wf[y][k1] · x_p[y][x] · wf[x][k2]      (Wfᵀ·X·Wf)
// with wf = ops/grid.py:dft_shift_factors(N, inverse), both fftshifts folded
// into it as index permutations and, for the inverse, 1/N per axis.
//
// Replaces idg_tpu/ops/pallas/gridder.py:_fused_dft_apply (:118), shared by
// the gridder's fused epilogue and the degridder's fused prologue; the roll
// of _roll_phase_outer (:227) is an exact index permutation on the caller's
// store or load. What bounds it on an H100: its operations, 2·P·8·N³ FLOP a
// subgrid (4 real products of N³ multiply-adds per pol and pass), 0.104 ms
// over the default problem at the TF32 peak and 0.311 ms in the three
// passes below; it moves no bytes of its own (its input and output never
// leave shared memory or the caller's own stores). Its predecessor, two
// FP32 passes of complex MACs through shared memory per pol with 8 block
// barriers, took +3.5 ms in each fused kernel on the card, above one
// torch.fft.fft2 over the same subgrids (0.73 ms, PERF.md).
//
// Design: both passes as real products over all four pols at once.
//  - Pass 1 (rows): T[(p, y)][(c, k2)] = [X_re | X_im] · Wr, M = 4N rows
//    (p, y), K = 2N (x re | x im), N = 2N columns (k2 re | k2 im), with
//    Wr = [[W_re, W_im], [−W_im, W_re]] the real form of wf.
//  - Pass 2 (columns): the same product on Tᵀ per pol, rows (p, k2) and
//    K = (c, y): Tᵀ·Wr = outᵀ, so the caller gets out_p[k1][k2] with the two
//    indices swapped. The accumulators' store of T writes it transposed into
//    the region X held, so one operand, Wr's split, serves both passes.
//  - Each 64-row slab is two pols at N = 32 (two warpgroups) and all four at
//    N = 16 (one), in both passes: a warpgroup's T lands in its own slab, so
//    the passes meet at two named barriers of the K3 warpgroups, not of the
//    block (the block's: one before pass 1, where the caller writes X).
//  - The accumulators are the caller's own, dead at that point: in K2 its
//    consumers' stay live through the prologue, and a third set spilled.
//  - wgmma from shared memory at both sizes, m64n64k8 at N = 32 and m64n32k8
//    at N = 16, in the unswizzled core-matrix layout of K1/K2 (wgmma.cuh).
//    mma.sync would take its fragments by shared-memory loads, the path that
//    bound the parent of K9d (PERF.md); one code path serves both sizes.
//  - "3xtf32" (wgmma.cuh:mma_tf32_step, lo·hi + hi·lo + hi·hi), as K1 and
//    K2 take their products: X, T and Wr each split hi = tf32(x),
//    lo = tf32(x − hi), so the float32 two-matmul plain version
//    (ops/grid.py:pieces_from_subgrids, _finish_extract) stays the reference
//    (tests/test_torch_k3.py models these products).
//  - Shared memory: X (then T) hi and lo, 4N × 2N floats each (64 KB at
//    N = 32, 16 KB at N = 16), and Wr hi and lo, 2N × 2N each (32 KB, 8 KB).
//    Wr comes split from the host (L2-resident, 32 KB) by cp.async, issued
//    before the caller forms X so that the copy's latency hides behind it.
//  - One branch-free path per warpgroup: ptxas serializes wgmma around a
//    divergent path (C7520), so the caller selects the warpgroups by a
//    warp-uniform flag and nothing inside depends on the thread but indices.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace idg {

template <int N>
struct Dft {
  static constexpr int kRows = kPols * N;        // X rows (p, y), then Tᵀ rows (p, k2)
  static constexpr int kGroups = kRows / 64;     // warpgroups, one 64-row slab each
  static constexpr int kK = 2 * N;               // contraction: (re | im, x), then (re | im, y)
  static constexpr int kKC = kK / 4;             // 4-wide K chunks of an operand row
  static constexpr uint32_t kSBO = kKC * 128;    // the next 8-row group's core matrices
  static constexpr int kCols = 2 * N;            // output columns (re | im, k)
  static constexpr int kAcc = 64 * kCols / 128;  // accumulator floats a thread
  static constexpr size_t kBytesX = (size_t)kRows * kK * 4;   // X (or T), hi or lo
  static constexpr size_t kBytesW = (size_t)kCols * kK * 4;   // Wr, hi or lo
  // the region K3 takes: X hi, X lo, Wr hi, Wr lo
  static constexpr size_t kBytes = 2 * kBytesX + 2 * kBytesW;
};

// Float index of X[(p, y)][(c, x)] (c = 0 real, 1 imaginary) in the
// operand's core-matrix layout. A warp that stores 8 consecutive y × 4
// consecutive x of one pol meets no bank conflict.
template <int N>
__device__ __forceinline__ int dft_x_index(int p, int y, int c, int x) {
  return core_index(p * N + y, c * N + x, Dft<N>::kKC);
}

// The caller's input value v of X[p][y][x], split into X hi and lo.
template <int N>
__device__ __forceinline__ void dft_store_x(float* x_hi, float* x_lo, int p, int y, int x,
                                            float2 v) {
  const int re = dft_x_index<N>(p, y, 0, x), im = dft_x_index<N>(p, y, 1, x);
  split_tf32(v.x, x_hi[re], x_lo[re]);
  split_tf32(v.y, x_hi[im], x_lo[im]);
}

// Wr's split from the host, f32[2][2N][2N] = [hi | lo][(c_out, k)][(c_in,
// j)] (ops/grid.py:dft_split_factors, the real form of wf and its "3xtf32"
// split), copied into the B operand's core-matrix layout at w (hi, then lo
// kBytesW on) by cp.async, 16 bytes a copy, a warp on consecutive global
// chunks. Every thread of the block calls it; the caller waits
// (cp_async_wait_all), fences (fence_async_smem) and synchronises the block
// before the products read it, and lets other work run in between.
template <int N, int kThreads>
__device__ __forceinline__ void dft_load_factors(const float* __restrict__ wr, unsigned char* w,
                                                 int tid) {
  using D = Dft<N>;
  constexpr int kChunks = D::kCols * D::kKC;   // 16-byte chunks of one half
  for (int i = tid; i < 2 * kChunks; i += kThreads) {
    const int half = i / kChunks, row = i % kChunks / D::kKC, kc = i % D::kKC;
    cp_async16(w + half * D::kBytesW + core_index(row, 4 * kc, D::kKC) * 4,
               wr + ((size_t)half * D::kCols + row) * D::kK + 4 * kc);
  }
  cp_async_commit();
}

// The K3 warpgroups' own barrier (named barrier 1, which K1 and K2 use for
// nothing else).
template <int N>
__device__ __forceinline__ void dft_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * Dft<N>::kGroups) : "memory");
}

// One pass of warpgroup wg: its 64-row slab of the operand at x (hi, then lo
// kBytesX on) times Wr at w, three TF32 passes, waited for. The k8 steps'
// descriptors are the first ones plus the steps' offsets (their address
// field is the byte address / 16 and stays below 2^14).
template <int N>
__device__ __forceinline__ void dft_pass(const unsigned char* x, const unsigned char* w, int wg,
                                         float (&acc)[Dft<N>::kAcc]) {
  using D = Dft<N>;
  constexpr uint32_t kLBO = 128;   // the next K chunk's core matrix
  const unsigned char* a_hi = x + wg * 8 * D::kSBO;
  const uint64_t ah = smem_desc(a_hi, kLBO, D::kSBO);
  const uint64_t al = smem_desc(a_hi + D::kBytesX, kLBO, D::kSBO);
  const uint64_t bh = smem_desc(w, kLBO, D::kSBO);
  const uint64_t bl = smem_desc(w + D::kBytesW, kLBO, D::kSBO);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D::kK / 8; ++ks) {
    const uint64_t off = ks * 2 * 128 / 16;   // two K chunks a k8 step
    mma_tf32_step<true>(acc, ks == 0, ah + off, al + off, bh + off, bl + off);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Both passes of warpgroup wg (thread wt of its 128) on X at x (hi, lo) and
// Wr at w (hi, lo), which the block wrote, fenced for the async proxy
// (fence_async_smem) and synchronised before the call; then
// emit(p, k1, k2, out_p[k1][k2]) for the outputs this thread holds. The
// call overwrites X with T. Only the Dft<N>::kGroups warpgroups call it,
// each with accumulator registers of its own whose values are dead (the
// first Dft<N>::kAcc of `regs` are overwritten).
template <int N, int K, typename Emit>
__device__ __forceinline__ void dft2_products(unsigned char* x, const unsigned char* w, int wg,
                                              int wt, float (&regs)[K], Emit emit) {
  using D = Dft<N>;
  static_assert(K >= D::kAcc, "the caller's accumulators hold one pass");
  constexpr int J = D::kCols / 8;   // 8-column groups of the accumulators
  // Accumulator 4j + 2h + e holds row 16·warp + g + 8h of the slab, column
  // 8j + 2t + e: the warp's 16 rows are rows yb + 8h of pol p (the same in
  // both passes), the column is (c, k) = (8j / N, (8j) % N + 2t + e).
  const int g = (wt & 31) >> 2, t = wt & 3;
  const int p = (64 * wg + 16 * (wt >> 5)) / N, yb = (16 * (wt >> 5)) % N + g;
  // Tᵀ[(p, k2)][(c, y)]'s index: this thread's part, plus a constant for
  // each (j, h, e) (neither part carries into the other's bits)
  const int t_base = dft_x_index<N>(p, 2 * t, 0, yb);
  float(&acc)[D::kAcc] = *reinterpret_cast<float(*)[D::kAcc]>(&regs[0]);
  dft_pass<N>(x, w, wg, acc);
  // the warpgroups' reads of X are done before their T overwrites them
  dft_bar<N>();
  float* t_hi = reinterpret_cast<float*>(x);
  float* t_lo = reinterpret_cast<float*>(x + D::kBytesX);
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // T_c[(p, y)][k2] → Tᵀ[(p, k2)][(c, y)]
        const int o = t_base + core_index(8 * j % N + e, 8 * j / N * N + 8 * h, D::kKC);
        split_tf32(acc[4 * j + 2 * h + e], t_hi[o], t_lo[o]);
      }
    }
  }
  fence_async_smem();
  dft_bar<N>();
  dft_pass<N>(x, w, wg, acc);
  // outᵀ[(p, k2)][(c, k1)]: the real column group j, the imaginary j + J/2
#pragma unroll
  for (int j = 0; j < J / 2; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        emit(p, 8 * j + 2 * t + e, yb + 8 * h,
             make_float2(acc[4 * j + 2 * h + e], acc[4 * (j + J / 2) + 2 * h + e]));
      }
    }
  }
}

}  // namespace idg
