// Native host-side runtime of the PyTorch/CUDA port (idg_tpu_torch).
//
// The reference implements its host layer in C++ (data initializers
// app/common/init.cpp, OpenMP golden kernels app/CPU/kernels/*.cpp,
// comparator tests/test_util.hpp). This library provides the same
// capabilities for the port, exposed over a C ABI and loaded via ctypes
// (idg_tpu_torch/native/__init__.py, which builds it with g++ at first use):
//
//   1. glibc-compatible rand() stream (TYPE_3 additive generator) for
//      bulk synthetic-data draws — the data-loader hot path.
//   2. OpenMP golden gridder/degridder oracles (double-precision
//      accumulation) for full-scale verification runs where the NumPy
//      oracle is too slow.
//   3. The normalized-RMS comparator metric (tests/test_util.hpp:28-92).
//
// It is the port's own copy of the JAX package's idg_tpu/native/
// idg_native.cpp, the same source, so both packages draw the same streams
// and compute the same oracles. Layouts follow the port's SoA conventions
// (idg_tpu_torch/types.py, with complex data as interleaved float pairs),
// not the reference's AoS structs.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// 1. glibc-compatible rand()
// ---------------------------------------------------------------------------

struct IdgRand {
  uint32_t table[344];  // rolling window storage (31-word state + headroom)
  int head;             // index of oldest live word
  int count;            // live words (always 31 after init)
};

static inline uint32_t idg_rand_next(IdgRand *s) {
  // val = r[i-31] + r[i-3]; output val >> 1  (glibc TYPE_3 semantics)
  int i31 = s->head;
  int i3 = (s->head + 28) % 31;
  uint32_t val = s->table[i31] + s->table[i3];
  s->table[i31] = val;            // the new word replaces the oldest
  s->head = (s->head + 1) % 31;
  return val >> 1;
}

void *idg_rand_new(uint32_t seed) {
  IdgRand *s = new IdgRand();
  if (seed == 0) seed = 1;
  int32_t r[34];
  r[0] = (int32_t)seed;
  for (int i = 1; i < 31; ++i) {
    // 16807 * r[i-1] % 2147483647 without overflow (Park-Miller hi/lo split)
    int64_t hi = r[i - 1] / 127773;
    int64_t lo = r[i - 1] % 127773;
    int64_t word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = (int32_t)word;
  }
  for (int i = 31; i < 34; ++i) r[i] = r[i - 31];
  // After the 34-word table, glibc discards 310 outputs. Simulate the
  // rolling state: keep the last 31 words, oldest first.
  uint32_t win[344];
  for (int i = 0; i < 34; ++i) win[i] = (uint32_t)r[i];
  int n = 34;
  for (int k = 0; k < 310; ++k) {
    win[n] = win[n - 31] + win[n - 3];
    ++n;
    if (n == 344) {  // compact the window
      std::memmove(win, win + n - 31, 31 * sizeof(uint32_t));
      n = 31;
    }
  }
  std::memmove(s->table, win + n - 31, 31 * sizeof(uint32_t));
  s->head = 0;
  s->count = 31;
  return s;
}

void idg_rand_free(void *handle) { delete (IdgRand *)handle; }

void idg_rand_fill(void *handle, int64_t n, int64_t *out) {
  IdgRand *s = (IdgRand *)handle;
  for (int64_t i = 0; i < n; ++i) out[i] = (int64_t)idg_rand_next(s);
}

void idg_rand_uniform_fill(void *handle, int64_t n, double *out) {
  IdgRand *s = (IdgRand *)handle;
  for (int64_t i = 0; i < n; ++i)
    out[i] = (double)idg_rand_next(s) / 2147483647.0;
}

// ---------------------------------------------------------------------------
// 2. OpenMP golden kernels
// ---------------------------------------------------------------------------
// Math (SURVEY.md §2.2; models/reference.py):
//   gridder:  pixel[y,x,p] = Σ_t Σ_c vis[t,c,p]·e^{i(po[y,x] − pi[t,y,x]·k_c)}
//             then A1ᴴ·P·A2 Jones correction and spheroidal taper;
//   degridder is the adjoint (taper+Jones first, conjugate phase, sum pixels).
// Layouts (idg_tpu_torch/types.py): uvw f32[S·T,3]; vis f32[S·T,C,P,2] interleaved;
// aterms f32[ts,st,N,N,P,2]; spheroidal f32[N,N]; subgrids f32[S,P,N,N,2];
// metadata: int32 arrays of length S.

struct IdgProblem {
  int32_t grid_size, subgrid_size, nr_timesteps, nr_channels, nr_correlations;
  float image_size, w_step;
};

static inline void lmn_at(const IdgProblem *p, int x, int y, double *l,
                          double *m, double *n) {
  const int N = p->subgrid_size;
  *l = (x + 0.5 - N / 2) * (double)p->image_size / N;
  *m = (y + 0.5 - N / 2) * (double)p->image_size / N;
  double tmp = (*l) * (*l) + (*m) * (*m);
  *n = tmp > 1.0 ? 1.0 : tmp / (1.0 + std::sqrt(1.0 - tmp));
}

typedef std::complex<double> cdbl;

static inline void jones_rows(const float *at, int64_t base, cdbl a[4]) {
  // at layout [..., N, N, P, 2]; base points at the (y, x, 0, 0) element
  for (int pol = 0; pol < 4; ++pol)
    a[pol] = cdbl(at[base + 2 * pol], at[base + 2 * pol + 1]);
}

void idg_gridder_reference(
    const IdgProblem *prob, int64_t nr_subgrids,
    const float *uvw,           // [S·T, 3]
    const float *wavenumbers,   // [C]
    const float *vis,           // [S·T, C, P, 2]
    const float *spheroidal,    // [N, N]
    const float *aterms,        // [ts, st, N, N, P, 2]
    const int32_t *time_offset, const int32_t *aterm_index,
    const int32_t *station1, const int32_t *station2,
    const int32_t *coord_x, const int32_t *coord_y, const int32_t *coord_z,
    int32_t nr_stations,
    float *subgrids             // [S, P, N, N, 2] out
) {
  const int N = prob->subgrid_size;
  const int T = prob->nr_timesteps;
  const int C = prob->nr_channels;
  const int P = prob->nr_correlations;
  const int G = prob->grid_size;
  const double scale = 2.0 * M_PI / prob->image_size;

#pragma omp parallel for schedule(dynamic)
  for (int64_t s = 0; s < nr_subgrids; ++s) {
    const double u_off = (coord_x[s] + N / 2 - G / 2) * scale;
    const double v_off = (coord_y[s] + N / 2 - G / 2) * scale;
    const double w_off = 2.0 * M_PI * prob->w_step * (coord_z[s] + 0.5);
    const int64_t t0 = time_offset[s];
    const int64_t at_base =
        ((int64_t)aterm_index[s] * nr_stations) * (int64_t)N * N * P * 2;
    const int64_t a1_base = at_base + (int64_t)station1[s] * N * N * P * 2;
    const int64_t a2_base = at_base + (int64_t)station2[s] * N * N * P * 2;

    for (int y = 0; y < N; ++y) {
      for (int x = 0; x < N; ++x) {
        double l, m, n;
        lmn_at(prob, x, y, &l, &m, &n);
        const double po = u_off * l + v_off * m + w_off * n;
        cdbl acc[4] = {0.0, 0.0, 0.0, 0.0};
        for (int t = 0; t < T; ++t) {
          const float *uv = uvw + (t0 + t) * 3;
          const double pi_ = uv[0] * l + uv[1] * m + uv[2] * n;
          const float *vrow = vis + (((t0 + t) * C) * P) * 2;
          for (int c = 0; c < C; ++c) {
            const double phase = po - pi_ * (double)wavenumbers[c];
            const cdbl ph(std::cos(phase), std::sin(phase));
            const float *vc = vrow + c * P * 2;
            for (int pol = 0; pol < P; ++pol)
              acc[pol] += cdbl(vc[2 * pol], vc[2 * pol + 1]) * ph;
          }
        }
        // Jones: A1ᴴ·acc·A2, then taper
        cdbl a1[4], a2[4];
        const int64_t pix_off = ((int64_t)y * N + x) * P * 2;
        jones_rows(aterms, a1_base + pix_off, a1);
        jones_rows(aterms, a2_base + pix_off, a2);
        const cdbl h0 = std::conj(a1[0]), h1 = std::conj(a1[2]);
        const cdbl h2 = std::conj(a1[1]), h3 = std::conj(a1[3]);
        const cdbl t00 = h0 * acc[0] + h1 * acc[2];
        const cdbl t01 = h0 * acc[1] + h1 * acc[3];
        const cdbl t10 = h2 * acc[0] + h3 * acc[2];
        const cdbl t11 = h2 * acc[1] + h3 * acc[3];
        cdbl out[4];
        out[0] = t00 * a2[0] + t01 * a2[2];
        out[1] = t00 * a2[1] + t01 * a2[3];
        out[2] = t10 * a2[0] + t11 * a2[2];
        out[3] = t10 * a2[1] + t11 * a2[3];
        const double sph = spheroidal[y * N + x];
        for (int pol = 0; pol < P; ++pol) {
          const int64_t o =
              (((s * P + pol) * (int64_t)N + y) * N + x) * 2;
          subgrids[o] = (float)(out[pol].real() * sph);
          subgrids[o + 1] = (float)(out[pol].imag() * sph);
        }
      }
    }
  }
}

void idg_degridder_reference(
    const IdgProblem *prob, int64_t nr_subgrids,
    const float *uvw, const float *wavenumbers,
    const float *subgrids,      // [S, P, N, N, 2] in
    const float *spheroidal, const float *aterms,
    const int32_t *time_offset, const int32_t *aterm_index,
    const int32_t *station1, const int32_t *station2,
    const int32_t *coord_x, const int32_t *coord_y, const int32_t *coord_z,
    int32_t nr_stations,
    float *vis                  // [S·T, C, P, 2] out
) {
  const int N = prob->subgrid_size;
  const int T = prob->nr_timesteps;
  const int C = prob->nr_channels;
  const int P = prob->nr_correlations;
  const int G = prob->grid_size;
  const double scale = 2.0 * M_PI / prob->image_size;

#pragma omp parallel for schedule(dynamic)
  for (int64_t s = 0; s < nr_subgrids; ++s) {
    const double u_off = (coord_x[s] + N / 2 - G / 2) * scale;
    const double v_off = (coord_y[s] + N / 2 - G / 2) * scale;
    const double w_off = 2.0 * M_PI * prob->w_step * (coord_z[s] + 0.5);
    const int64_t t0 = time_offset[s];
    const int64_t at_base =
        ((int64_t)aterm_index[s] * nr_stations) * (int64_t)N * N * P * 2;
    const int64_t a1_base = at_base + (int64_t)station1[s] * N * N * P * 2;
    const int64_t a2_base = at_base + (int64_t)station2[s] * N * N * P * 2;

    // Stage taper + A1·P·A2ᴴ for every pixel (degridder prologue)
    cdbl *staged = new cdbl[(int64_t)N * N * P];
    double *lmn = new double[(int64_t)N * N * 3];
    for (int y = 0; y < N; ++y) {
      for (int x = 0; x < N; ++x) {
        double l, m, n;
        lmn_at(prob, x, y, &l, &m, &n);
        const int64_t li = ((int64_t)y * N + x) * 3;
        lmn[li] = l; lmn[li + 1] = m; lmn[li + 2] = n;
        const double sph = spheroidal[y * N + x];
        cdbl pm[4];
        for (int pol = 0; pol < P; ++pol) {
          const int64_t o = (((s * P + pol) * (int64_t)N + y) * N + x) * 2;
          pm[pol] = cdbl(subgrids[o], subgrids[o + 1]) * sph;
        }
        cdbl a1[4], a2[4];
        const int64_t pix_off = ((int64_t)y * N + x) * P * 2;
        jones_rows(aterms, a1_base + pix_off, a1);
        jones_rows(aterms, a2_base + pix_off, a2);
        const cdbl t00 = a1[0] * pm[0] + a1[1] * pm[2];
        const cdbl t01 = a1[0] * pm[1] + a1[1] * pm[3];
        const cdbl t10 = a1[2] * pm[0] + a1[3] * pm[2];
        const cdbl t11 = a1[2] * pm[1] + a1[3] * pm[3];
        cdbl *st = staged + ((int64_t)y * N + x) * P;
        st[0] = t00 * std::conj(a2[0]) + t01 * std::conj(a2[1]);
        st[1] = t00 * std::conj(a2[2]) + t01 * std::conj(a2[3]);
        st[2] = t10 * std::conj(a2[0]) + t11 * std::conj(a2[1]);
        st[3] = t10 * std::conj(a2[2]) + t11 * std::conj(a2[3]);
      }
    }

    for (int t = 0; t < T; ++t) {
      const float *uv = uvw + (t0 + t) * 3;
      for (int c = 0; c < C; ++c) {
        const double k = wavenumbers[c];
        cdbl acc[4] = {0.0, 0.0, 0.0, 0.0};
        for (int64_t pix = 0; pix < (int64_t)N * N; ++pix) {
          const double *lm = lmn + pix * 3;
          const double pi_ = uv[0] * lm[0] + uv[1] * lm[1] + uv[2] * lm[2];
          const double po = u_off * lm[0] + v_off * lm[1] + w_off * lm[2];
          const double phase = pi_ * k - po;
          const cdbl ph(std::cos(phase), std::sin(phase));
          const cdbl *st = staged + pix * P;
          for (int pol = 0; pol < P; ++pol) acc[pol] += st[pol] * ph;
        }
        for (int pol = 0; pol < P; ++pol) {
          const int64_t o = (((t0 + t) * (int64_t)C + c) * P + pol) * 2;
          vis[o] = (float)acc[pol].real();
          vis[o + 1] = (float)acc[pol].imag();
        }
      }
    }
    delete[] staged;
    delete[] lmn;
  }
}

// ---------------------------------------------------------------------------
// 3. Comparator (tests/test_util.hpp:28-92 metric)
// ---------------------------------------------------------------------------

double idg_check_error(const float *a, const float *b, int64_t n) {
  // a, b: interleaved complex float arrays of n elements.
  double r_max = 1.0, i_max = 1.0;
  for (int64_t i = 0; i < n; ++i) {
    const double ar = std::fabs((double)a[2 * i]);
    const double ai = std::fabs((double)a[2 * i + 1]);
    if (ar > r_max) r_max = ar;
    if (ai > i_max) i_max = ai;
  }
  double r_err = 0.0, i_err = 0.0;
  int64_t nnz = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double br = b[2 * i], bi = b[2 * i + 1];
    if (br == 0.0 && bi == 0.0) continue;
    ++nnz;
    const double dr = br - (double)a[2 * i];
    const double di = bi - (double)a[2 * i + 1];
    r_err += dr * dr;
    i_err += di * di;
  }
  if (nnz == 0) nnz = 1;
  return std::sqrt(r_err / r_max / nnz + i_err / i_max / nnz);
}

}  // extern "C"
