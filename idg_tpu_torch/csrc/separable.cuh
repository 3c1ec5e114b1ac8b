// Helpers of the separable kernels (gridder_separable.cu,
// degridder_separable.cu, degridder_polstack.cu and the rungs' *_sep_*.cu):
// the bf16 hi/lo split of a float32 value, a 32-bit shared-memory load of
// two bf16 values, one bf16 mma.sync into float32 accumulators, the Taylor
// terms of the w correction and the phasors with their channel recurrence.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace idg {

constexpr int kResync = 16;   // the recurrence restarts exactly every kResync channels

// x = hi + lo + O(2^-17 |x|): hi = bf16(x), lo = bf16(x − hi), both rounded to
// nearest even, as torch's bf16 cast and ops/precision.py:split_bf16 round.
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// Two consecutive bf16 values as one fragment register (the lower address in
// the lower half).
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Flips the sign of both bf16 halves of a fragment register: exact.
constexpr uint32_t kNegPair = 0x80008000u;

// d += a · b on one 16×8×16 tile: a row-major 16×16 bf16 (4 registers),
// b column-major 16×8 bf16 (2 registers), d 16×8 float32 (4 registers).
// Fragment ownership, with g = lane / 4 and q = lane % 4:
//   a: {(g, 2q..2q+1), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..)}  (row, k)
//   b: {(2q..2q+1, g), (2q+8.., g)}                                (k, col)
//   d: {(g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1)}                (row, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (iμ)^r / r!, or its conjugate, by r steps of ·(±iμ/q) in the operation
// order of the TPU kernels (gridder.py:469, degridder.py:274).
template <bool kConj>
__device__ __forceinline__ float2 taylor_coefficient(float mu, int r) {
  float cr = 1.0f, ci = 0.0f;
  for (int q = 1; q <= r; ++q) {
    const float ncr = kConj ? ci * mu / q : -ci * mu / q;
    ci = kConj ? -cr * mu / q : cr * mu / q;
    cr = ncr;
  }
  return make_float2(cr, ci);
}

// n^r by r multiplies, as the TPU kernels raise n (gridder.py:497-503).
__device__ __forceinline__ float power(float n, int r) {
  float p = 1.0f;
  for (int q = 0; q < r; ++q) p *= n;
  return p;
}

// e^{i·phase} of one Φ entry, phase = po − ax·(coord·k_c). With kRecur,
// the channel recurrence of the TPU kernels (gridder.py:626-650): c == 0
// sets the state from k0, c % kResync == 0 restarts it exactly from
// k0 + c·Δk, any other channel steps it by one complex multiply.
template <bool kRecur>
__device__ __forceinline__ float2 phasor(float po, float ax, float coord, const float* k,
                                         int c, float dk, float2& cur, float2& step) {
  float s, co;
  if constexpr (!kRecur) {
    sincosf(po - ax * (coord * k[c]), &s, &co);
    return make_float2(co, s);
  } else {
    if (c == 0) {
      sincosf(-(ax * (coord * dk)), &s, &co);
      step = make_float2(co, s);
      sincosf(po - ax * (coord * k[0]), &s, &co);
      cur = make_float2(co, s);
    } else if (c % kResync == 0) {
      const float kc = __fadd_rn(k[0], __fmul_rn((float)c, dk));
      sincosf(po - ax * (coord * kc), &s, &co);
      cur = make_float2(co, s);
    } else {
      cur = cmul(cur, step);
    }
    return cur;
  }
}

}  // namespace idg
