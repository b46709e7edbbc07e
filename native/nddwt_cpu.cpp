// Native CPU backend for the non-decimated DWT (dimension-generic).
//
// This framework's counterpart of the reference's MEX layer
// (mex/nd_dwt_mex.c gateway + mex/nddwt.c FFTW core): a C++/OpenMP engine
// exposed through a minimal C ABI consumed via ctypes
// (non_decimated_wavelets/native/cpu_backend.py). Where the reference
// used frequency-domain fast convolution (FFTW batched plans,
// mex/nddwt.c:15-61), this backend computes the numerically identical
// direct form — separable K-tap circular correlations
//     y_c[n] = sum_j t_c[j] * x[(n + j - (K/2 - 1)) mod N]
// per axis, which for the short Daubechies filters is the bandwidth-optimal
// shape on CPUs too (no complex intermediates for real data). Unlike the
// reference core it never mutates its inputs (the reference's multilevel
// rec writes into the caller's array, mex/nddwt.c:263-288 — a defect this
// implementation deliberately does not reproduce).
//
// Data model: arrays are C-order float64. Complex data is handled as an
// extra innermost real pair (re,im): correlations along spatial axes apply
// to both components identically since the taps are real.
//
// Band layout/order and multilevel semantics match the engine exactly:
// band-first (B, *spatial), B = 2^d + (2^d-1)(L-1), deepest approx first,
// bit k of the band index = high-pass on axis k (bit 0 fastest).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct AxisView {
  int64_t outer;   // product of dims before `axis`
  int64_t n;       // extent of `axis`
  int64_t inner;   // product of dims after `axis` (incl. complex pair)
};

AxisView make_view(const int64_t* shape, int ndim, int axis, int64_t inner_extra) {
  AxisView v{1, shape[axis], inner_extra};
  for (int a = 0; a < axis; ++a) v.outer *= shape[a];
  for (int a = axis + 1; a < ndim; ++a) v.inner *= shape[a];
  return v;
}

// One analysis pass along `axis`: writes lo and hi outputs.
void corr_pair(const double* x, double* lo, double* hi, const AxisView& v,
               const double* taps, int K) {
  const int64_t o = K / 2 - 1;
  const int64_t N = v.n;
  const double* tl = taps;      // low row
  const double* th = taps + K;  // high row
#pragma omp parallel for schedule(static)
  for (int64_t ou = 0; ou < v.outer; ++ou) {
    const double* xo = x + ou * N * v.inner;
    double* lo_o = lo + ou * N * v.inner;
    double* hi_o = hi + ou * N * v.inner;
    for (int64_t n = 0; n < N; ++n) {
      double* lrow = lo_o + n * v.inner;
      double* hrow = hi_o + n * v.inner;
      for (int64_t i = 0; i < v.inner; ++i) { lrow[i] = 0.0; hrow[i] = 0.0; }
      for (int j = 0; j < K; ++j) {
        int64_t src = n + j - o;
        src %= N; if (src < 0) src += N;
        const double* xrow = xo + src * v.inner;
        const double cl = tl[j], ch = th[j];
        for (int64_t i = 0; i < v.inner; ++i) {
          lrow[i] += cl * xrow[i];
          hrow[i] += ch * xrow[i];
        }
      }
    }
  }
}

// One synthesis pass along `axis`: out = adj(lo) + adj(hi).
void adj_pair(const double* lo, const double* hi, double* out, const AxisView& v,
              const double* taps, int K) {
  const int64_t o = K / 2 - 1;
  const int64_t N = v.n;
  const double* tl = taps;
  const double* th = taps + K;
#pragma omp parallel for schedule(static)
  for (int64_t ou = 0; ou < v.outer; ++ou) {
    const double* lo_o = lo + ou * N * v.inner;
    const double* hi_o = hi + ou * N * v.inner;
    double* oo = out + ou * N * v.inner;
    for (int64_t m = 0; m < N; ++m) {
      double* orow = oo + m * v.inner;
      for (int64_t i = 0; i < v.inner; ++i) orow[i] = 0.0;
      for (int j = 0; j < K; ++j) {
        int64_t src = m - j + o;
        src %= N; if (src < 0) src += N;
        const double* lrow = lo_o + src * v.inner;
        const double* hrow = hi_o + src * v.inner;
        const double cl = tl[j], ch = th[j];
        for (int64_t i = 0; i < v.inner; ++i) {
          orow[i] += cl * lrow[i] + ch * hrow[i];
        }
      }
    }
  }
}

// Single-level analysis: x (numel) -> bands (2^d, numel), engine band order.
void level1_dec(const double* x, double* bands, const int64_t* shape, int ndim,
                const double* taps_all, const int* ks, int64_t inner_extra,
                int64_t numel, std::vector<double>& scratch) {
  // Ping-pong band lists; process axes 0..d-1, doubling bands each pass.
  // Each pass puts the newest axis' bit at the MSB, so after processing
  // axes in order 0..d-1 the list index is exactly the engine band order
  // (bit k = axis k, bit 0 fastest) — no reordering needed.
  int nb = 1 << ndim;
  scratch.resize(static_cast<size_t>(nb) * numel * 2);
  double* cur = scratch.data();
  double* nxt = scratch.data() + static_cast<size_t>(nb) * numel;
  std::memcpy(cur, x, sizeof(double) * numel);
  int cur_nb = 1;
  const double* taps = taps_all;
  for (int ax = 0; ax < ndim; ++ax) {
    AxisView v = make_view(shape, ndim, ax, inner_extra);
    int K = ks[ax];
    for (int b = 0; b < cur_nb; ++b) {
      corr_pair(cur + static_cast<size_t>(b) * numel,
                nxt + static_cast<size_t>(b) * numel,
                nxt + static_cast<size_t>(b + cur_nb) * numel, v, taps, K);
    }
    std::swap(cur, nxt);
    cur_nb *= 2;
    taps += 2 * K;
  }
  std::memcpy(bands, cur, sizeof(double) * numel * nb);
}

// Single-level synthesis: bands (2^d, numel) engine order -> out (numel).
void level1_rec(const double* bands, double* out, const int64_t* shape, int ndim,
                const double* taps_all, const int* ks, int64_t inner_extra,
                int64_t numel, std::vector<double>& scratch) {
  int nb = 1 << ndim;
  scratch.resize(static_cast<size_t>(nb) * numel * 2);
  double* cur = scratch.data();
  double* nxt = scratch.data() + static_cast<size_t>(nb) * numel;
  // Engine band order already has axis ndim-1's bit as the MSB of the
  // band index, so collapse MSB-first directly (mirror of level1_dec).
  std::memcpy(cur, bands, sizeof(double) * numel * nb);
  int cur_nb = nb;
  for (int ax = ndim - 1; ax >= 0; --ax) {
    AxisView v = make_view(shape, ndim, ax, inner_extra);
    int K = ks[ax];
    const double* taps = taps_all;
    for (int a = 0; a < ax; ++a) taps += 2 * ks[a];
    int half = cur_nb / 2;
    for (int b = 0; b < half; ++b) {
      adj_pair(cur + static_cast<size_t>(b) * numel,
               cur + static_cast<size_t>(b + half) * numel,
               nxt + static_cast<size_t>(b) * numel, v, taps, K);
    }
    std::swap(cur, nxt);
    cur_nb = half;
  }
  std::memcpy(out, cur, sizeof(double) * numel);
}

}  // namespace

extern "C" {

// x: (spatial) real f64 or complex as trailing (re,im) pairs.
// y: (B, spatial) same element layout. Returns 0 on success.
int nddwt_dec(const void* x_ptr, void* y_ptr, const long* shape_l, int ndim,
              const void* taps_ptr, const int* ks, int level, int is_complex) {
  if (ndim < 1 || ndim > 8 || level < 1) return 1;
  std::vector<int64_t> shape(ndim);
  int64_t numel_sp = 1;
  for (int a = 0; a < ndim; ++a) { shape[a] = shape_l[a]; numel_sp *= shape[a]; }
  const int64_t inner_extra = is_complex ? 2 : 1;
  const int64_t numel = numel_sp * inner_extra;
  const double* x = static_cast<const double*>(x_ptr);
  double* y = static_cast<double*>(y_ptr);
  const double* taps = static_cast<const double*>(taps_ptr);
  const int nb = 1 << ndim;
  const int B = nb + (nb - 1) * (level - 1);

  std::vector<double> scratch;
  std::vector<double> bands(static_cast<size_t>(nb) * numel);
  std::vector<double> approx(static_cast<size_t>(numel));
  std::memcpy(approx.data(), x, sizeof(double) * numel);

  int write_pos = B;  // fill detail groups from the back (shallowest last)
  for (int lvl = 0; lvl < level; ++lvl) {
    level1_dec(approx.data(), bands.data(), shape.data(), ndim, taps, ks,
               inner_extra, numel, scratch);
    std::memcpy(approx.data(), bands.data(), sizeof(double) * numel);
    write_pos -= (nb - 1);
    std::memcpy(y + static_cast<size_t>(write_pos) * numel,
                bands.data() + numel, sizeof(double) * numel * (nb - 1));
  }
  std::memcpy(y, approx.data(), sizeof(double) * numel);
  return 0;
}

int nddwt_rec(const void* y_ptr, void* x_ptr, const long* shape_l, int ndim,
              const void* taps_ptr, const int* ks, int level, int preserve_l2,
              int is_complex) {
  if (ndim < 1 || ndim > 8 || level < 1) return 1;
  std::vector<int64_t> shape(ndim);
  int64_t numel_sp = 1;
  for (int a = 0; a < ndim; ++a) { shape[a] = shape_l[a]; numel_sp *= shape[a]; }
  const int64_t inner_extra = is_complex ? 2 : 1;
  const int64_t numel = numel_sp * inner_extra;
  const double* y = static_cast<const double*>(y_ptr);
  double* x = static_cast<double*>(x_ptr);
  const double* taps = static_cast<const double*>(taps_ptr);
  const int nb = 1 << ndim;

  std::vector<double> scratch;
  std::vector<double> group(static_cast<size_t>(nb) * numel);
  std::vector<double> acc(static_cast<size_t>(numel));

  // Deepest group: bands 0..nb-1.
  std::memcpy(group.data(), y, sizeof(double) * numel * nb);
  level1_rec(group.data(), acc.data(), shape.data(), ndim, taps, ks,
             inner_extra, numel, scratch);
  if (!preserve_l2)
    for (int64_t i = 0; i < numel; ++i) acc[i] /= nb;
  int64_t pos = nb;
  for (int lvl = 1; lvl < level; ++lvl) {
    std::memcpy(group.data(), acc.data(), sizeof(double) * numel);
    std::memcpy(group.data() + numel, y + static_cast<size_t>(pos) * numel,
                sizeof(double) * numel * (nb - 1));
    level1_rec(group.data(), acc.data(), shape.data(), ndim, taps, ks,
               inner_extra, numel, scratch);
    if (!preserve_l2)
      for (int64_t i = 0; i < numel; ++i) acc[i] /= nb;
    pos += nb - 1;
  }
  std::memcpy(x, acc.data(), sizeof(double) * numel);
  return 0;
}

int nddwt_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Runtime thread control (the reference hard-codes 8 FFTW threads,
// mex/nddwt.c:103; here the count is adjustable so benchmarks can measure
// the honest single-core figure). Returns the resulting max thread count.
int nddwt_set_num_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
  return omp_get_max_threads();
#else
  (void)n;
  return 1;
#endif
}

}  // extern "C"
