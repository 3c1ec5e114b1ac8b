// K10, vadd: z = x + y over n floats, the memory-bandwidth smoke kernel.
//
// Replaces idg_tpu/ops/vadd.py:vadd_pallas. What bounds it on an H100:
// device memory, 12 bytes per element (two reads, one write). Design: a
// grid-stride loop over 16-byte (float4) loads and stores, 8 blocks per SM,
// and a scalar tail for n % 4 in block 0. Inputs that are not 16-byte
// aligned (a sliced tensor) take the scalar loop throughout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// kVec: float4 over the first n / 4 quads, then block 0 adds the n % 4 tail
template <bool kVec>
__global__ void __launch_bounds__(kThreads) vadd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ z,
    long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* z4 = reinterpret_cast<float4*>(z);
    for (long long i = first; i < n4; i += stride) {
      const float4 a = x4[i], b = y4[i];
      z4[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    const long long done = n4 * 4;
    if (blockIdx.x == 0 && done + threadIdx.x < n) {
      z[done + threadIdx.x] = x[done + threadIdx.x] + y[done + threadIdx.x];
    }
  } else {
    for (long long i = first; i < n; i += stride) z[i] = x[i] + y[i];
  }
}

}  // namespace

extern "C" int idg_vadd(const void* x, const void* y, void* z, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)z) % sizeof(float4)) == 0;
  const long long items = aligned ? (n + 3) / 4 : n;
  const long long max_blocks = (long long)sms * kBlocksPerSM;
  const long long wanted = (items + kThreads - 1) / kThreads;
  const int blocks = (int)(wanted < max_blocks ? wanted : max_blocks);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  auto* zf = static_cast<float*>(z);
  if (aligned) {
    vadd_kernel<true><<<blocks, kThreads, 0, st>>>(xf, yf, zf, n);
  } else {
    vadd_kernel<false><<<blocks, kThreads, 0, st>>>(xf, yf, zf, n);
  }
  return (int)cudaGetLastError();
}
