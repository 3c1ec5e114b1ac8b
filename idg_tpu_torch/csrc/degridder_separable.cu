// The entry point of the separable degridder rungs: cuda_v3 (K9b, FP32
// FFMA; degridder_sep_fp32.cu), cuda_v4 (K9b, bf16 wgmma, exact Φ) and
// cuda_v5 (K9c, bf16 wgmma, Φ by the channel recurrence), both in
// degridder_sep_bf16.cu.

#include <cuda_runtime.h>

#include "common.cuh"

namespace idg {
cudaError_t degridder_sep_v3(const float*, const float*, const float*, const float*,
                             const float*, const float*, const float*, const float*,
                             const float*, const float2*, const int*, const int*, const int*,
                             const float2*, float2*, int, int, int, int, int, int, cudaStream_t);
cudaError_t degridder_sep_bf16(const float*, const float*, const float*, const float*,
                               const float*, const float*, const float*, const float*,
                               const float*, const float2*, const int*, const int*,
                               const int*, const float2*, float2*, int, int, int, int, int,
                               int, bool, cudaStream_t);
}  // namespace idg

// variant: 0 = cuda_v3 (FP32 FFMA, exact Φ; degridder_sep_fp32.cu), 1 =
// cuda_v4 (bf16 wgmma, exact Φ), 2 = cuda_v5 (bf16 wgmma, recurrence Φ;
// both degridder_sep_bf16.cu).
extern "C" int idg_degridder_separable(
    const void* uvw, const void* mu, const void* k, const void* po_x, const void* po_y,
    const void* l, const void* m, const void* n, const void* sph, const void* aterms,
    const void* aterm_index, const void* station1, const void* station2,
    const void* subgrids, void* out, int S, int T, int C, int N, int nr_stations,
    int w_rank, int variant, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || w_rank < 1 || w_rank > idg::kMaxWRank) {
    return (int)cudaErrorInvalidValue;
  }
  auto* st = static_cast<cudaStream_t>(stream);
#define IDG_ARGS                                                                       \
  (const float*)uvw, (const float*)mu, (const float*)k, (const float*)po_x,            \
      (const float*)po_y, (const float*)l, (const float*)m, (const float*)n,           \
      (const float*)sph, (const float2*)aterms, (const int*)aterm_index,               \
      (const int*)station1, (const int*)station2, (const float2*)subgrids,             \
      (float2*)out, S, T, C, N, nr_stations, w_rank
  switch (variant) {
    case 0: return (int)idg::degridder_sep_v3(IDG_ARGS, st);
    case 1: return (int)idg::degridder_sep_bf16(IDG_ARGS, false, st);
    case 2: return (int)idg::degridder_sep_bf16(IDG_ARGS, true, st);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IDG_ARGS
}
