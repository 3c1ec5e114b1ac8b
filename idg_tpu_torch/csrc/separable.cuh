// Helpers of the separable kernels (degridder_polstack.cu and the rungs'
// *_sep_*.cu): the bf16 hi/lo split of a float32 value, one bf16 mma.sync
// into float32 accumulators, the Taylor terms of the w correction, the
// phasors with their channel recurrence and the visibility tiles of the
// bf16 rungs.
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

// (iμ)^r / r! by r steps of ·(iμ/q) in the operation order of the TPU
// kernels (gridder.py:469).
__device__ __forceinline__ float2 taylor_coefficient(float mu, int r) {
  float cr = 1.0f, ci = 0.0f;
  for (int q = 1; q <= r; ++q) {
    const float ncr = -ci * mu / q;
    ci = cr * mu / q;
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

// The channel recurrence of the kE entries of one producer of the bf16
// rungs at channel c, e[i] = entry i's phasor, with each entry's state
// (cur, step) in shared memory at state[i·stride]: 8 entries' state in
// registers spilled beside the formation's own (80 registers a thread at
// 768 threads a block). Where the recurrence restarts (c % kResync == 0,
// c == 0 too) each entry takes phasor<true>, with its phase offset, axis
// value and coordinate from geo(i, po, ax, coord); at any other channel
// every entry takes phasor<true>'s step, one complex multiply, in a branch
// of its own with no other path, so that the state reads are all issued
// before the first multiply.
template <int kE, typename Geo>
__device__ __forceinline__ void phasors_shared(Geo geo, const float* k, int c, float dk,
                                               float4* state, int stride, float2 (&e)[kE]) {
  if (c % kResync == 0) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const float4 st = state[i * stride];   // not used at c == 0
      float po, ax, coord;
      geo(i, po, ax, coord);
      float2 cur = make_float2(st.x, st.y), step = make_float2(st.z, st.w);
      e[i] = phasor<true>(po, ax, coord, k, c, dk, cur, step);
      state[i * stride] = make_float4(cur.x, cur.y, step.x, step.y);
    }
  } else {
    float4 st[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) st[i] = state[i * stride];
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      e[i] = cmul(make_float2(st[i].x, st[i].y), make_float2(st[i].z, st[i].w));
      reinterpret_cast<float2*>(state + i * stride)[0] = e[i];
    }
  }
}

// The visibilities of tile j of the bf16 rungs (*_sep_bf16.cu): the kk-th,
// kk < nv, sits at base + kk·stride of the [T, C] layout. cuda_v4 takes
// kTile consecutive v = t·C + c; cuda_v5 (kRecur) kTile timesteps of one
// channel, c-major as JAX's pallas_v5 orders them, with the t-tiles outer
// and the channels inner (j = t-tile·C + c), so that the recurrence's state
// carries from one channel to the next.
struct TileSpan {
  int base, stride, nv;
};

template <bool kRecur, int kTile>
__device__ __forceinline__ TileSpan tile_span(int j, int T, int C) {
  if constexpr (kRecur) {
    const int t0 = (j / C) * kTile;
    return {t0 * C + j % C, C, min(kTile, T - t0)};
  } else {
    return {j * kTile, 1, min(kTile, T * C - j * kTile)};
  }
}

}  // namespace idg
