// K10, vadd: z = x + y over n floats, the memory-bandwidth smoke kernel.
//
// Replaces idg_tpu/ops/vadd.py:vadd_pallas. What bounds it on an H100:
// device memory, 12 bytes per element (two reads, one write): 0.962 ms at
// n = 2^28 and 3.35 TB/s.
//
// Design: a one-shot grid with no grid-stride loop, one float4 of each
// operand a thread, 128 threads a block, the shape of torch.add's own
// kernel; the loads go through the non-coherent path with a 256-byte L2
// prefetch hint (ld.global.nc.L2::256B), so each warp's 512-byte request
// brings its neighbours' lines into L2 with it. It was held in one call on
// the card against two other designs, both slower (PERF.md): a ring of
// shared-memory stages filled by cp.async.bulk (TMA) copies under
// mbarriers, walked by three persistent blocks a SM, and four float4 a
// thread with evict-first loads and stores. The n % 4 tail is added by
// block 0 with scalar loads. Inputs that are not 16-byte aligned (a sliced
// tensor) take a scalar grid-stride loop.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kScalarThreads = 256;
constexpr int kBlocksPerSM = 8;   // the scalar path's grid

__device__ __forceinline__ float4 load_l2_256(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads) vadd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ z,
    long long n) {
  const long long n4 = n / 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 a = load_l2_256(reinterpret_cast<const float4*>(x) + i);
    const float4 b = load_l2_256(reinterpret_cast<const float4*>(y) + i);
    reinterpret_cast<float4*>(z)[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  const long long done = n4 * 4;
  if (blockIdx.x == 0 && done + threadIdx.x < n) {
    z[done + threadIdx.x] = x[done + threadIdx.x] + y[done + threadIdx.x];
  }
}

__global__ void __launch_bounds__(kScalarThreads) vadd_scalar(
    const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ z,
    long long n) {
  const long long stride = (long long)gridDim.x * kScalarThreads;
  for (long long i = (long long)blockIdx.x * kScalarThreads + threadIdx.x; i < n;
       i += stride) {
    z[i] = x[i] + y[i];
  }
}

}  // namespace

extern "C" int idg_vadd(const void* x, const void* y, void* z, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  auto* zf = static_cast<float*>(z);
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)z) % sizeof(float4)) == 0;
  if (aligned) {
    const long long n4 = n / 4;
    const long long blocks = n4 > 0 ? (n4 + kThreads - 1) / kThreads : 1;
    vadd_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(xf, yf, zf, n);
  } else {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    const long long wanted = (n + kScalarThreads - 1) / kScalarThreads;
    const long long most = (long long)sms * kBlocksPerSM;
    vadd_scalar<<<(int)(wanted < most ? wanted : most), kScalarThreads, 0, st>>>(xf, yf, zf, n);
  }
  return (int)cudaGetLastError();
}
