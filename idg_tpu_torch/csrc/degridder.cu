// Degridder: subgrids c64[S, P, N, N] -> visibilities c64[S, T, C, P], FP32
// on the CUDA cores.
//
// Replaces idg_tpu/ops/pallas/degridder.py:_kernel_polstack_batch (launcher
// _degridder_polstack_batch_run, registered as degridder pallas_v7),
// non-fused 4-D input form, and with kFuse the fused grid-stage prologue
// (the `fuse` branch, degridder.py:1022-1059, degridder_pallas_v7_staged
// with fuse_oyx). It computes the adjoint of the gridder:
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
//
// Fused prologue (kFuse): the input is the range extraction's block-rolled
// pieces. Per pol, the block reads its piece un-rolled by (oy, ox) = oyx[s]
// (an exact index permutation, tile[y][x] = piece[(y+oy)%N][(x+ox)%N], in
// place of the TPU kernel's conjugate Fourier phases), K3
// (common.cuh:dft2_tile) applies the forward folded-shift DFT, and the
// subgrid lands in shared memory, where the taper/Jones prologue reads it in
// place of device memory. The result is exactly the non-fused kernel on
// ops/grid.py:_finish_extract(pieces). The subgrid and K3's workspace use
// the Φx region, which is free until the main loop, so shared memory and
// occupancy stay those of the non-fused kernel.

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

template <int N, bool kFuse>
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
    const float2* __restrict__ subgrids,    // [S, P, N, N] subgrids, or pieces with kFuse
    const int* __restrict__ oyx,            // [S, 2] (kFuse only)
    const float2* __restrict__ wf,          // [N, N] forward DFT factors (kFuse only)
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
  const float2* sub_s = subgrids + (size_t)s * kPols * nn;

  // fused prologue: pieces → subgrid [P][N·N] in the Φx region
  float2* s_sub = s_phx;
  if constexpr (kFuse) {
    static_assert((kPols + 3) * N * N <= N * kThreads, "K3's workspace fits in s_phx");
    float2* s_x = s_sub + kPols * N * N;
    float2* s_tmp = s_x + N * N;
    float2* s_wf = s_tmp + N * N;
    for (int e = tid; e < N * N; e += kThreads) s_wf[e] = wf[e];
    // the roll is taken mod N, as the plain version takes it: no index leaves the tile
    const int oy = (oyx[2 * s] % N + N) % N, ox = (oyx[2 * s + 1] % N + N) % N;
#pragma unroll 1
    for (int p = 0; p < kPols; ++p) {
      for (int e = tid; e < N * N; e += kThreads) {
        const int y = e / N, x = e % N;
        s_x[e] = sub_s[p * nn + ((y + oy) % N) * N + (x + ox) % N];
      }
      __syncthreads();
      float2* sub_p = s_sub + p * nn;
      dft2_tile<N, kThreads>(s_x, s_tmp, s_wf,
                             [&](int k1, int k2, float2 v) { sub_p[k1 * N + k2] = v; });
    }
    __syncthreads();
  }

  // prologue: taper, then A1 · P · A2ᴴ (math.hpp:79-92)
  const size_t at1 = ((size_t)aterm_index[s] * nr_stations + station1[s]) * nn;
  const size_t at2 = ((size_t)aterm_index[s] * nr_stations + station2[s]) * nn;
  for (int q = tid; q < N * N; q += kThreads) {
    const float taper = sph[q];
    float2 p[kPols];
#pragma unroll
    for (int i = 0; i < kPols; ++i) {
      const float2 v = kFuse ? s_sub[i * nn + q] : sub_s[i * nn + q];
      p[i] = make_float2(v.x * taper, v.y * taper);
    }
    float2 o[kPols];
    jones_degridder(aterms + (at1 + q) * kPols, aterms + (at2 + q) * kPols, p, o);
    s_pix[2 * q + 0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
    s_pix[2 * q + 1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
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

template <int N, bool kFuse>
cudaError_t launch(const float* uvw, const float* mu, const float* k, const float* po_x,
                   const float* po_y, const float* l, const float* m, const float* n,
                   const float* sph, const float2* aterms, const int* aterm_index,
                   const int* station1, const int* station2, const float2* subgrids,
                   const int* oyx, const float2* wf, float2* out, int S, int T, int C,
                   int nr_stations, int w_rank, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<N>();
  // above 48 KB a block's dynamic shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(
      degridder_kernel<N, kFuse>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  degridder_kernel<N, kFuse><<<S, kThreads, bytes, stream>>>(
      uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index, station1, station2,
      subgrids, oyx, wf, out, T, C, nr_stations, w_rank);
  return cudaGetLastError();
}

template <bool kFuse>
int dispatch(const void* uvw, const void* mu, const void* k, const void* po_x,
             const void* po_y, const void* l, const void* m, const void* n, const void* sph,
             const void* aterms, const void* aterm_index, const void* station1,
             const void* station2, const void* subgrids, const void* oyx, const void* wf,
             void* out, int S, int T, int C, int N, int nr_stations, int w_rank,
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
      (const int*)oyx, (const float2*)wf, (float2*)out, S, T, C, nr_stations, w_rank, st
  switch (N) {
    case 16: return (int)launch<16, kFuse>(IDG_ARGS);
    case 32: return (int)launch<32, kFuse>(IDG_ARGS);
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
                         station1, station2, subgrids, nullptr, nullptr, out, S, T, C, N,
                         nr_stations, w_rank, stream);
}

// The fused form: `pieces` are the range extraction's block-rolled pieces.
extern "C" int idg_degridder_v7_fused(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* pieces, const void* oyx, const void* wf, void* out, int S, int T, int C,
    int N, int nr_stations, int w_rank, void* stream) {
  return dispatch<true>(uvw, mu, k, po_x, po_y, l, m, n, sph, aterms, aterm_index,
                        station1, station2, pieces, oyx, wf, out, S, T, C, N, nr_stations,
                        w_rank, stream);
}
