// tkcore — native host-side runtime for tensorkrylov.
//
// The accelerator compute path is JAX/XLA; this library covers the host side:
//   * multithreaded batched DIA (banded) SpMV — the CPU reference baseline
//     for bench.py and large host-side oracle computations,
//   * dense→DIA band extraction (the Python loop is O(n²) interpreter-bound),
//   * a fast parser for the Braess–Hackbusch coefficient file format
//     (t lines of ω then t lines of α, '{'-delimited labels; see
//     /root/reference/coefficients_data file layout, SURVEY.md §2.11).
//
// Build: make -C csrc     (produces libtkcore.so, loaded via ctypes with a
// pure-Python fallback if absent).

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// u[s, i] = sum_b bands[s, b, i] * v[s, i + offsets[b]]  (zero outside range)
// bands: (d, nb, n) row-major; v, u: (d, n).
void tk_banded_spmv_f64(const double* bands, const int64_t* offsets, int nb,
                        int d, int64_t n, const double* v, double* u,
                        int nthreads) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  std::atomic<int> next_row{0};
  auto worker = [&]() {
    int s;
    while ((s = next_row.fetch_add(1)) < d) {
      const double* vb = v + (int64_t)s * n;
      double* ub = u + (int64_t)s * n;
      std::memset(ub, 0, sizeof(double) * n);
      for (int b = 0; b < nb; ++b) {
        const int64_t off = offsets[b];
        const double* band = bands + ((int64_t)s * nb + b) * n;
        const int64_t lo = off >= 0 ? 0 : -off;
        const int64_t hi = off >= 0 ? n - off : n;
        for (int64_t i = lo; i < hi; ++i) ub[i] += band[i] * vb[i + off];
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

void tk_banded_spmv_f32(const float* bands, const int64_t* offsets, int nb,
                        int d, int64_t n, const float* v, float* u,
                        int nthreads) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  std::atomic<int> next_row{0};
  auto worker = [&]() {
    int s;
    while ((s = next_row.fetch_add(1)) < d) {
      const float* vb = v + (int64_t)s * n;
      float* ub = u + (int64_t)s * n;
      std::memset(ub, 0, sizeof(float) * n);
      for (int b = 0; b < nb; ++b) {
        const int64_t off = offsets[b];
        const float* band = bands + ((int64_t)s * nb + b) * n;
        const int64_t lo = off >= 0 ? 0 : -off;
        const int64_t hi = off >= 0 ? n - off : n;
        for (int64_t i = lo; i < hi; ++i) ub[i] += band[i] * vb[i + off];
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Extract DIA bands from dense factors. mats: (d, n, n); out bands:
// (d, nb, n) for the given offsets (caller detects offsets or passes all).
void tk_dense_to_bands_f64(const double* mats, int d, int64_t n,
                           const int64_t* offsets, int nb, double* bands) {
  for (int s = 0; s < d; ++s) {
    for (int b = 0; b < nb; ++b) {
      const int64_t off = offsets[b];
      double* out = bands + ((int64_t)s * nb + b) * n;
      std::memset(out, 0, sizeof(double) * n);
      const int64_t lo = off >= 0 ? 0 : -off;
      const int64_t hi = off >= 0 ? n - off : n;
      const double* M = mats + (int64_t)s * n * n;
      for (int64_t i = lo; i < hi; ++i) out[i] = M[i * n + (i + off)];
    }
  }
}

// Which diagonals of (d, n, n) dense factors are nonzero. nonzero: (2n-1)
// bytes, index o+n-1 for offset o.
void tk_detect_offsets_f64(const double* mats, int d, int64_t n,
                           uint8_t* nonzero) {
  std::memset(nonzero, 0, (size_t)(2 * n - 1));
  for (int s = 0; s < d; ++s) {
    const double* M = mats + (int64_t)s * n * n;
    for (int64_t i = 0; i < n; ++i)
      for (int64_t j = 0; j < n; ++j)
        if (M[i * n + j] != 0.0) nonzero[j - i + n - 1] = 1;
  }
}

// Parse one Braess–Hackbusch coefficient file: 2t lines of
// "  <40-digit float>   {omega[i]}" / "{alpha[i]}". Returns 0 on success,
// negative error codes otherwise. omega/alpha must hold t doubles each.
int tk_parse_bh_file(const char* path, int t, double* omega, double* alpha) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[512];
  int count = 0;
  while (std::fgets(line, sizeof line, f)) {
    char* p = line;
    while (*p && std::isspace((unsigned char)*p)) ++p;
    if (!*p) continue;
    char* end = nullptr;
    double val = std::strtod(p, &end);
    if (end == p) { std::fclose(f); return -2; }
    if (count < t) omega[count] = val;
    else if (count < 2 * t) alpha[count - t] = val;
    else { std::fclose(f); return -3; }
    ++count;
  }
  std::fclose(f);
  return count == 2 * t ? 0 : -4;
}

int tk_version() { return 1; }

}  // extern "C"
