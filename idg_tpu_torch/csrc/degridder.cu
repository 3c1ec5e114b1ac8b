// Degridder: subgrids c64[S, P, N, N] -> visibilities c64[S, T, C, P], FP32
// on the CUDA cores.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_polstack_batch (launcher
// _degridder_polstack_batch_run, registered as degridder pallas_v7),
// non-fused 4-D input form. It computes the adjoint of the gridder:
//   pix'[y,x,p] = A1 · (sph·P) · A2ᴴ                      (prologue)
//   vis[v,p] = Σ_{y,x} pix'[y,x,p] · conj(Φx[v,x] · Φy[v,y] · Σ_{r<w_rank} (iμ_v·n[y,x])^r / r!)
// and writes [S, T, C, P] directly (the TPU kernel wrote c-major [S, P, C·T]
// and transposed afterwards).
//
// What bounds it on an H100: FP32 arithmetic, as in the gridder: ~22 FMAs
// per pixel and visibility against 32 B of input per visibility.
//
// Design: one block per subgrid, 256 threads. The prologue writes the
// prepared pixels (P·N²·8 B = 32 KB at N=32) and n into shared memory. Each
// thread then owns one visibility at a time: every visibility is an
// independent sum over N² pixels, so no reduction crosses threads. The
// thread computes its Φx row once into its own column of shared memory
// (layout [x][thread], so a warp's loads are conflict-free), then walks y,
// computing Φy with one sincosf per row, while the pixels and n come as
// warp-wide broadcasts. That is O(V·N) sincosf per subgrid, as in the
// gridder. The TPU kernel's K-merged bf16 split products (kmerge, cfold),
// pol stacking and software pipelining served its bf16 matrix unit and
// in-order scheduler and have no counterpart here.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
constexpr size_t smem_bytes() {
  return (size_t)N * N * idg::kPols * sizeof(float2)  // prepared pixels
         + (size_t)N * kThreads * sizeof(float2)      // Φx, one column per thread
         + (size_t)N * N * sizeof(float);             // n
}

template <int N>
__global__ void __launch_bounds__(kThreads) degridder_kernel(
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
    const float2* __restrict__ subgrids,    // [S, P, N, N]
    float2* __restrict__ out,               // [S, T, C, P]
    int T, int C, int nr_stations, int w_rank) {
  using namespace idg;
  extern __shared__ float4 smem[];
  float4* s_pix = smem;                                       // [N·N][2] (4 pols)
  float2* s_phx = reinterpret_cast<float2*>(smem + N * N * 2);  // [N][kThreads]
  float* s_n = reinterpret_cast<float*>(s_phx + N * kThreads);  // [N·N]

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = (size_t)N * N;

  // prologue: taper, then A1 · P · A2ᴴ (math.hpp:79-92)
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;
  for (int q = tid; q < N * N; q += kThreads) {
    const float taper = sph[q];
    float2 p[kPols];
#pragma unroll
    for (int i = 0; i < kPols; ++i) {
      const float2 v = sub_s[i * nn + q];
      p[i] = make_float2(v.x * taper, v.y * taper);
    }
    const float2* a = aterms + (at1 + q) * kPols;
    const float2* b = aterms + (at2 + q) * kPols;
    const float2 a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
    const float2 b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3];
    const float2 t0 = cadd(cmul(a0, p[0]), cmul(a1, p[2]));
    const float2 t1 = cadd(cmul(a0, p[1]), cmul(a1, p[3]));
    const float2 t2 = cadd(cmul(a2, p[0]), cmul(a3, p[2]));
    const float2 t3 = cadd(cmul(a2, p[1]), cmul(a3, p[3]));
    const float2 o0 = cadd(cmul_by_conj(t0, b0), cmul_by_conj(t1, b1));
    const float2 o1 = cadd(cmul_by_conj(t0, b2), cmul_by_conj(t1, b3));
    const float2 o2 = cadd(cmul_by_conj(t2, b0), cmul_by_conj(t3, b1));
    const float2 o3 = cadd(cmul_by_conj(t2, b2), cmul_by_conj(t3, b3));
    s_pix[2 * q + 0] = make_float4(o0.x, o0.y, o1.x, o1.y);
    s_pix[2 * q + 1] = make_float4(o2.x, o2.y, o3.x, o3.y);
    s_n[q] = n[q];
  }
  __syncthreads();

  const int V = T * C;
  const float* uvw_s = uvw + (size_t)s * T * 3;
  const float* pox_s = po_x + (size_t)s * N;
  const float* poy_s = po_y + (size_t)s * N;
  float2* phx = s_phx + tid;  // this thread's column, stride kThreads
  // no barrier inside this loop: each thread reads only its own column
  for (int v = tid; v < V; v += kThreads) {
    const int t = v / C, c = v % C;
    const float kc = k[c];
    const float uk = uvw_s[t * 3 + 0] * kc;
    const float vk = uvw_s[t * 3 + 1] * kc;
    const float mu_v = mu[(size_t)s * V + v];
#pragma unroll 4
    for (int x = 0; x < N; ++x) {
      float sx, cx;
      sincosf(pox_s[x] - l[x] * uk, &sx, &cx);
      phx[x * kThreads] = make_float2(cx, sx);
    }
    float2 acc[kPols];
#pragma unroll
    for (int p = 0; p < kPols; ++p) acc[p] = make_float2(0.0f, 0.0f);
    for (int y = 0; y < N; ++y) {
      float sy, cy;
      sincosf(poy_s[y] - m[y] * vk, &sy, &cy);
      const float2 phy = make_float2(cy, sy);
#pragma unroll 8
      for (int x = 0; x < N; ++x) {
        const int q = y * N + x;
        float2 ph = cmul(phx[x * kThreads], phy);
        ph = cmul(ph, taylor_expi(mu_v * s_n[q], w_rank));
        const float4 pa = s_pix[2 * q + 0];
        const float4 pb = s_pix[2 * q + 1];
        // acc += pix · conj(ph)
        const float2 cph = make_float2(ph.x, -ph.y);
        cmac(acc[0], make_float2(pa.x, pa.y), cph);
        cmac(acc[1], make_float2(pa.z, pa.w), cph);
        cmac(acc[2], make_float2(pb.x, pb.y), cph);
        cmac(acc[3], make_float2(pb.z, pb.w), cph);
      }
    }
    float4* o = reinterpret_cast<float4*>(out + ((size_t)s * V + v) * kPols);
    o[0] = make_float4(acc[0].x, acc[0].y, acc[1].x, acc[1].y);
    o[1] = make_float4(acc[2].x, acc[2].y, acc[3].x, acc[3].y);
  }
}

template <int N>
cudaError_t launch(const float* uvw, const float* mu, const float* k, const float* po_x,
                   const float* po_y, const float* l, const float* m, const float* n,
                   const float* sph, const float2* aterms, const int* aterm_index,
                   const int* station1, const int* station2, const float2* subgrids,
                   float2* out, int S, int T, int C, int nr_stations, int w_rank,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<N>();
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(
      degridder_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_kernel<N><<<S, kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

}  // namespace

extern "C" int idg_degridder_v7(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* subgrids, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float*)mu, (const float*)k, (const float*)po_x,            \
      (const float*)po_y, (const float*)l, (const float*)m, (const float*)n,           \
      (const float*)sph, (const float2*)aterms, (const int*)aterm_index,               \
      (const int*)station1, (const int*)station2, (const float2*)subgrids,             \
      (float2*)out, S, T, C, nr_stations, w_rank, st
  switch (N) {
    case 16: return (int)launch<16>(IDG_ARGS);
    case 32: return (int)launch<32>(IDG_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}
