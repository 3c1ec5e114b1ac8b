// Hopper helpers of the tensor-core kernels: the TF32 gridder and degridder
// (gridder.cu, degridder.cu), the direct rungs (gridder_direct.cu,
// degridder_direct.cu) and the bf16 separable rungs (gridder_sep_bf16.cu,
// degridder_sep_bf16.cu): the TF32 split of a float32 value (by cvt.rna,
// or on the bits), TF32 `mma.sync`, shared-memory matrix descriptors,
// `wgmma` on TF32 (m64n32k8, m64n64k8, m64n128k8) and on bf16 operands with
// its fences and its three-pass split product, and `cp.async` copies into
// shared memory.
//
// Operand layout (both operands K-major, the only layout TF32 `wgmma`
// takes, and the one the bf16 kernels use too; no swizzle): a [rows][K]
// tile is stored as 8×16 B core matrices, each 8 rows × 16 bytes of
// consecutive K values (4 TF32 or 8 bf16), 128 contiguous bytes. The core
// matrix of row group g and K chunk c sits at (g·kc + c)·128 bytes, kc the
// chunks of a row, so a descriptor takes LBO = 128 (the next K chunk) and
// SBO = kc·128 (the next row group), and one k8 TF32 step or one k16 bf16
// step spans two chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace idg {

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, in one instruction: ops/precision.py:round_tf32 rounds the
// same way, and the tensor cores read the value exactly.
__device__ __forceinline__ float tf32_rn(float x) {
  uint32_t b;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  return __uint_as_float(b);
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - hi);
}

// split_tf32 of a finite x in five instructions (split_tf32's two cvt.rna
// take four each, with their check for Inf and NaN): the same rounding (to
// nearest, ties away from zero) done on the bits, adding half of the 13
// dropped bits' unit and clearing them (ops/precision.py:round_tf32), so hi
// and lo are split_tf32's, bit for bit. tf32_rn_bits is its hi alone.
__device__ __forceinline__ float tf32_rn_bits(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32_bits(float x, float& hi, float& lo) {
  hi = tf32_rn_bits(x);
  lo = tf32_rn_bits(x - hi);
}

// d += a · b on one 16×8×8 TF32 tile (mma.sync, the direct rungs K8a and
// K9a): a row-major 16×8 (4 registers), b column-major 8×8 (2), d 16×8
// float32 (4). Ownership, with g = lane / 4 and t = lane % 4:
//   a: {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}         (row, k)
//   b: {(t, g), (t+4, g)}                                (k, col)
//   d: {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}      (row, col)
// The tensor cores read 19 bits of each operand register (sign, exponent and
// 10 mantissa bits) and drop the rest.
__device__ __forceinline__ void mma_tf32_16x8(float (&d)[4], const float (&a)[4], float b0,
                                              float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// The "3xtf32" product of one 16×8×8 tile into d: lo·hi + hi·lo + hi·hi, with
// b = (b0 hi, b1 hi, b0 lo, b1 lo).
__device__ __forceinline__ void mma3_tf32_16x8(float (&d)[4], const float (&a_hi)[4],
                                               const float (&a_lo)[4], float4 b) {
  mma_tf32_16x8(d, a_lo, b.x, b.y);
  mma_tf32_16x8(d, a_hi, b.z, b.w);
  mma_tf32_16x8(d, a_hi, b.x, b.y);
}

// The TF32 split of a finite x in three instructions: hi = x rounded to TF32
// (to nearest, ties away from zero, as tf32_rn, whose cvt.rna takes four
// with its check for Inf and NaN), lo = x − hi exactly, left in float32:
// mma.sync reads 19 bits of each register, so lo counts as lo with its 13
// low bits dropped (|lo| ≤ 2^-11·|x|, so within 2^-21·|x|).
__device__ __forceinline__ void split_tf32_raw(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

// The TF32 split of a phasor's component, |x| ≤ 1, on the FP32 pipe alone:
// hi = x rounded to a multiple of 2^-11 by the float32 rounding of
// x + 1.5·2^12 (at most 11 significant bits, so exactly TF32), lo = x − hi
// exactly (|lo| ≤ 2^-12), read by mma.sync with its 13 low bits dropped:
// within 2^-22 of the phasor's unit magnitude. Three FP32 instructions,
// where split_tf32_raw takes two on the INT32 pipe, half as wide on Hopper.
__device__ __forceinline__ void split_unit_tf32(float x, float& hi, float& lo) {
  constexpr float kRound = 6144.0f;   // 1.5·2^12: its ulp is 2^-11
  hi = __fsub_rn(__fadd_rn(x, kRound), kRound);
  lo = __fsub_rn(x, hi);
}

// The split A fragment of two phasors of one k-column pair, as the direct
// kernels lay Φ out: a = {re(row g), re(row g+8), im(row g), im(row g+8)},
// each split into TF32 hi and lo (split_unit_tf32).
__device__ __forceinline__ void split_phasors(float2 top, float2 bottom, float (&hi)[4],
                                              float (&lo)[4]) {
  split_unit_tf32(top.x, hi[0], lo[0]);
  split_unit_tf32(bottom.x, hi[1], lo[1]);
  split_unit_tf32(top.y, hi[2], lo[2]);
  split_unit_tf32(bottom.y, hi[3], lo[3]);
}

// Float index of (row, k) in a core-matrix tile of kc 4-wide K chunks.
__device__ __forceinline__ int core_index(int row, int k, int kc) {
  return (((row >> 3) * kc + (k >> 2)) * 8 + (row & 7)) * 4 + (k & 3);
}

// The wgmma descriptor of a K-major, unswizzled tile at p.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Order this thread's generic-proxy shared-memory writes before the async
// proxy (wgmma, bulk copies) reads them; a barrier must follow.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma's issue or wait.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a · b over one k8 step, D 64×32 float32 (16 registers a thread).
// Ownership, warp w of the warpgroup, g = lane / 4, t = lane % 4:
//   d[4j + e] = D[16w + g][8j + 2t + e], d[4j + 2 + e] = D[16w + g + 8][8j + 2t + e]
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same on D 64×64 (32 registers a thread).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same on D 64×128 (64 registers a thread), the width K1 takes at
// N = 32 (gridder.cu): B's 128 columns read once a step against 64 rows of A.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The gridders' fold (K1, gridder.cu; cuda_v4, gridder_sep_bf16.cu): wait
// for this warpgroup's products of rank r, outᵀ = A · B with A's rows
// (q, re | im) interleaved by 8-row groups and B's rows (re | im)·N + y, and
// fold them into the running sum, out = (AreBre − AimBim) + i(AreBim +
// AimBre), weighted by n^r. The thread's outputs: pixel (y, x) of pol p,
// q = p·N + x = tid / 4, y = 8j + 2(tid % 4) + e, in sum[2j + e].
template <int N>
__device__ __forceinline__ void fold_rank(int r, const float* __restrict__ n, int x, int t4,
                                          float (&acc)[N], float2 (&sum)[N / 4]) {
  constexpr int J = N / 8;   // 8-column groups of B's real rows
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = 2 * j + e;
      float w = 1.0f;
      if (r > 0) {
        const float nn = __ldg(n + (8 * j + 2 * t4 + e) * N + x);
        for (int q = 0; q < r; ++q) w *= nn;
      }
      const float re = acc[4 * j + e] - acc[4 * (j + J) + 2 + e];
      const float im = acc[4 * (j + J) + e] + acc[4 * j + 2 + e];
      sum[o].x = fmaf(w, re, sum[o].x);
      sum[o].y = fmaf(w, im, sum[o].y);
    }
  }
}

// Whether Taylor rank r of a rank-w_rank product takes three passes (else
// hi·hi alone): rank 0 always, every rank of an escalated rank
// (ops/precision.py: "3xtf32" and "3x", one pass for rank 1 at rank ≤ 2).
__device__ __forceinline__ bool three_passes(int r, int w_rank) {
  return r == 0 || w_rank > 2;
}

// One k8 step of a split product into d: lo·hi + hi·lo + hi·hi (kThree),
// or hi·hi alone; `first` overwrites d.
template <bool kThree, int K>
__device__ __forceinline__ void mma_tf32_step(float (&d)[K], bool first, uint64_t a_hi,
                                              uint64_t a_lo, uint64_t b_hi, uint64_t b_lo) {
  if constexpr (kThree) {
    wgmma_tf32(d, a_lo, b_hi, first ? 0 : 1);
    wgmma_tf32(d, a_hi, b_lo, 1);
    wgmma_tf32(d, a_hi, b_hi, 1);
  } else {
    wgmma_tf32(d, a_hi, b_hi, first ? 0 : 1);
  }
}

// Element index of (row, k) in a bf16 core-matrix tile of kc 8-wide K chunks.
__device__ __forceinline__ int core_index_bf16(int row, int k, int kc) {
  return (((row >> 3) * kc + (k >> 3)) * 8 + (row & 7)) * 8 + (k & 7);
}

// The bf16 hi/lo splits of four values (separable.cuh:split_bf16, round to
// nearest even), each as 8 bytes with the lowest K first: two paired
// conversions (cvt.rn.bf16x2.f32) a half.
__device__ __forceinline__ void split_bf16x4(const float (&x)[4], uint2& hi, uint2& lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(x[2], x[3]);
  const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
  const __nv_bfloat162 l01 = __floats2bfloat162_rn(x[0] - f01.x, x[1] - f01.y);
  const __nv_bfloat162 l23 = __floats2bfloat162_rn(x[2] - f23.x, x[3] - f23.y);
  hi = make_uint2(reinterpret_cast<const uint32_t&>(h01), reinterpret_cast<const uint32_t&>(h23));
  lo = make_uint2(reinterpret_cast<const uint32_t&>(l01), reinterpret_cast<const uint32_t&>(l23));
}

// d (+)= a · b over one k16 step of bf16 operands, both K-major in shared
// memory, D 64×32 float32 (16 registers a thread, the ownership of
// wgmma_tf32 above). accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same on D 64×64 (32 registers a thread).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One k16 step of a bf16 split product into d: lo·hi + hi·lo + hi·hi
// (kThree, "3x"), or hi·hi alone ("default"); `first` overwrites d.
template <bool kThree, int K>
__device__ __forceinline__ void mma_bf16_step(float (&d)[K], bool first, uint64_t a_hi,
                                              uint64_t a_lo, uint64_t b_hi, uint64_t b_lo) {
  if constexpr (kThree) {
    wgmma_bf16(d, a_lo, b_hi, first ? 0 : 1);
    wgmma_bf16(d, a_hi, b_lo, 1);
    wgmma_bf16(d, a_hi, b_hi, 1);
  } else {
    wgmma_bf16(d, a_hi, b_hi, first ? 0 : 1);
  }
}

// Named barrier `id` over the first `count` threads that reach it (a
// multiple of 32): the producers' own hand-over inside a tile.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` of `count` threads without waiting: the
// producing side of a hand-over whose consuming side calls bar_sync.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Asynchronous copies of 16 and 4 bytes, global → shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace idg
