// The check of K1's phasors: common.cuh's sincosf_block, as the gridder's
// producers call it (gridder.cu, `form`), against CUDA's sincosf, bit for
// bit. It replaces no TPU kernel; tests/test_torch_cuda.py runs it.
//
// A warp takes 128 arguments at a time, 4 a lane (lane + 32·i, so that the
// loads coalesce), evaluates them with sincosf_block<4> as K1 does its Φx
// and its Φy (the straight path for all four, one warp-uniform fallback to
// sincosf), then each by sincosf, and compares the bits of both sines and
// cosines. The arguments are x[i] = args[i], or with args null the float32
// of bit pattern first + i, so that one launch walks every pattern (count
// up to 2^32). counts gets, per launch: [0] the arguments whose sine or
// cosine differ in any bit, [1] the arguments sincosf_straight flags
// (sincosf_slow), [2] the 128-argument blocks whose warp took the
// fallback. With got and want given, each argument's (s, c) of both is
// stored there.
//
// Bound: the fallback's Payne–Hanek reduction on a walk of every pattern
// (flagged: |x| ≥ 105,615, 44% of them); not timed.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 4;
constexpr int kPerWarp = 32 * kPerLane;

__global__ void __launch_bounds__(kThreads) phasor_check_kernel(
    const float* __restrict__ args, uint32_t first, long long n, float2* __restrict__ got,
    float2* __restrict__ want, unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  uint32_t differ = 0, flagged = 0, fallbacks = 0;
  for (long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32; w * kPerWarp < n;
       w += warps) {
    float x[kPerLane], s[kPerLane], c[kPerLane];
    long long idx[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      idx[i] = w * kPerWarp + 32 * i + lane;
      const bool in = idx[i] < n;
      x[i] = !in ? 0.0f : args ? args[idx[i]] : __uint_as_float(first + (uint32_t)idx[i]);
    }
    const bool fallback = idg::sincosf_block(x, s, c);
    fallbacks += fallback && lane == 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (idx[i] >= n) continue;
      float ws, wc;
      sincosf(x[i], &ws, &wc);
      differ += __float_as_uint(s[i]) != __float_as_uint(ws) ||
                __float_as_uint(c[i]) != __float_as_uint(wc);
      flagged += idg::sincosf_slow(x[i]);
      if (got != nullptr) {
        got[idx[i]] = make_float2(s[i], c[i]);
        want[idx[i]] = make_float2(ws, wc);
      }
    }
  }
  differ = __reduce_add_sync(0xffffffffu, differ);
  flagged = __reduce_add_sync(0xffffffffu, flagged);
  if (lane == 0) {
    atomicAdd(counts + 0, (unsigned long long)differ);
    atomicAdd(counts + 1, (unsigned long long)flagged);
    atomicAdd(counts + 2, (unsigned long long)fallbacks);
  }
}

}  // namespace

extern "C" int idg_phasor_check(const void* args, unsigned int first, long long n, void* got,
                                void* want, void* counts, void* stream) {
  if (n <= 0 || n > (1ll << 32) || (got == nullptr) != (want == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long blocks_needed = (n + (long long)kThreads / 32 * kPerWarp - 1) /
                                  ((long long)kThreads / 32 * kPerWarp);
  const int blocks = (int)(blocks_needed < 8ll * sms ? blocks_needed : 8ll * sms);
  phasor_check_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(args), first, n, static_cast<float2*>(got),
      static_cast<float2*>(want), static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}
