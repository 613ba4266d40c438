// Native host-side runtime kernels for scs_tpu.
//
// This is the framework's counterpart of the reference's native
// runtime layer around the compute core:
//   * CSC matrix utilities (reference: scs_source/linsys/scs_matrix.c,
//     csparse.c — validation, SpMV, dense assembly used by the bridge)
//   * binary problem serialization (reference: scs_source/src/rw.c,
//     write_data_filename path, scs/scsobject.h:493)
//
// The device compute path (projections, DR loop, factorizations) lives in
// JAX/XLA/Pallas; these kernels cover the host-side data plumbing where
// the reference also uses native code. Exposed via a plain C ABI and
// loaded with ctypes (no pybind11 in the build image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC csc_ops.cpp -o _scs_native.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSC utilities
// ---------------------------------------------------------------------------

// Returns 1 if the CSC matrix (with sorted row indices) has any entry
// strictly below the diagonal (reference semantics: scs/py/__init__.py
// _has_lower_tri — the last row index in each column is the largest).
int64_t csc_has_lower_tri(const int64_t* indptr, const int64_t* indices,
                          int64_t ncols) {
  for (int64_t j = 0; j < ncols; ++j) {
    int64_t end = indptr[j + 1];
    if (end > indptr[j] && indices[end - 1] > j) return 1;
  }
  return 0;
}

// Returns 1 if row indices are sorted and in-range within every column.
int64_t csc_validate(const int64_t* indptr, const int64_t* indices,
                     int64_t nrows, int64_t ncols) {
  if (indptr[0] != 0) return 0;
  for (int64_t j = 0; j < ncols; ++j) {
    if (indptr[j + 1] < indptr[j]) return 0;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      if (indices[k] < 0 || indices[k] >= nrows) return 0;
      if (k > indptr[j] && indices[k] <= indices[k - 1]) return 0;
    }
  }
  return 1;
}

// Dense (row-major, m x n) assembly from CSC.
void csc_to_dense(int64_t m, int64_t n, const double* data,
                  const int64_t* indices, const int64_t* indptr,
                  double* out /* m*n, zeroed by caller or here */) {
  std::memset(out, 0, sizeof(double) * (size_t)(m * n));
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      out[indices[k] * n + j] = data[k];
    }
  }
}

// Symmetric dense assembly from an upper-triangular CSC P (row-major n x n):
// fills both triangles (the device path wants the full symmetric matrix).
void csc_triu_to_dense_sym(int64_t n, const double* data,
                           const int64_t* indices, const int64_t* indptr,
                           double* out) {
  std::memset(out, 0, sizeof(double) * (size_t)(n * n));
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      int64_t i = indices[k];
      out[i * n + j] = data[k];
      out[j * n + i] = data[k];
    }
  }
}

// y = A @ x (CSC)
void csc_matvec(int64_t m, int64_t n, const double* data,
                const int64_t* indices, const int64_t* indptr,
                const double* x, double* y) {
  std::memset(y, 0, sizeof(double) * (size_t)m);
  for (int64_t j = 0; j < n; ++j) {
    double xj = x[j];
    if (xj == 0.0) continue;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      y[indices[k]] += data[k] * xj;
    }
  }
}

// y = A' @ x (CSC)
void csc_rmatvec(int64_t m, int64_t n, const double* data,
                 const int64_t* indices, const int64_t* indptr,
                 const double* x, double* y) {
  for (int64_t j = 0; j < n; ++j) {
    double acc = 0.0;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      acc += data[k] * x[indices[k]];
    }
    y[j] = acc;
  }
}

// Block-ELL packing for the Pallas SpMV path: given CSC and a block size
// bs, compute for each block-row the list of nonzero block-columns.
// Pass 1 (count): writes per-blockrow counts into counts[nbr].
void bell_count(int64_t m, int64_t n, const int64_t* indices,
                const int64_t* indptr, int64_t bs, int64_t* counts,
                uint8_t* scratch /* nbc bytes, caller-zeroed */) {
  int64_t nbr = (m + bs - 1) / bs;
  int64_t nbc = (n + bs - 1) / bs;
  std::vector<uint8_t> seen((size_t)(nbr * nbc), 0);
  (void)scratch;
  for (int64_t j = 0; j < n; ++j) {
    int64_t bj = j / bs;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      int64_t bi = indices[k] / bs;
      seen[(size_t)(bi * nbc + bj)] = 1;
    }
  }
  for (int64_t bi = 0; bi < nbr; ++bi) {
    int64_t cnt = 0;
    for (int64_t bj = 0; bj < nbc; ++bj) cnt += seen[(size_t)(bi * nbc + bj)];
    counts[bi] = cnt;
  }
}

// Pass 2 (fill): writes block data. blocks is (nbr, width, bs, bs) dense,
// cols is (nbr, width) block-column ids (padded with -1 -> mapped to 0
// with zero data). width = max(counts).
void bell_fill(int64_t m, int64_t n, const double* data,
               const int64_t* indices, const int64_t* indptr, int64_t bs,
               int64_t width, double* blocks, int64_t* cols) {
  int64_t nbr = (m + bs - 1) / bs;
  int64_t nbc = (n + bs - 1) / bs;
  // slot map: for each (block-row, block-col) the slot index or -1
  std::vector<int64_t> slot((size_t)(nbr * nbc), -1);
  std::vector<int64_t> used((size_t)nbr, 0);
  for (int64_t i = 0; i < nbr * width; ++i) cols[i] = 0;
  std::memset(blocks, 0,
              sizeof(double) * (size_t)(nbr * width * bs * bs));
  for (int64_t j = 0; j < n; ++j) {
    int64_t bj = j / bs;
    int64_t cj = j % bs;
    for (int64_t k = indptr[j]; k < indptr[j + 1]; ++k) {
      int64_t i = indices[k];
      int64_t bi = i / bs;
      int64_t ri = i % bs;
      int64_t* s = &slot[(size_t)(bi * nbc + bj)];
      if (*s < 0) {
        *s = used[(size_t)bi]++;
        cols[bi * width + *s] = bj;
      }
      blocks[((bi * width + *s) * bs + ri) * bs + cj] = data[k];
    }
  }
}

// ---------------------------------------------------------------------------
// Binary problem serialization (rw.c analogue)
//
// Format (little-endian):
//   magic   "SCSTPU01"               8 bytes
//   m, n, p_nnz_flag                 3 x int64
//   b[m], c[n]                       doubles
//   A: nnz, indptr[n+1], indices[nnz], data[nnz]
//   P (if flag): nnz, indptr[n+1], indices[nnz], data[nnz]
//   n_settings, then per setting: name_len, name bytes, double value
//   cone: n_fields, per field: name_len, name, arr_len, doubles
// ---------------------------------------------------------------------------

static const char kMagic[8] = {'S', 'C', 'S', 'T', 'P', 'U', '0', '1'};

static bool wr(FILE* f, const void* p, size_t sz) {
  return std::fwrite(p, 1, sz, f) == sz;
}
static bool rd(FILE* f, void* p, size_t sz) {
  return std::fread(p, 1, sz, f) == sz;
}

// Returns 0 on success.
int64_t write_problem_bin(
    const char* path, int64_t m, int64_t n,
    const double* b, const double* c,
    int64_t a_nnz, const int64_t* a_indptr, const int64_t* a_indices,
    const double* a_data,
    int64_t has_p, int64_t p_nnz, const int64_t* p_indptr,
    const int64_t* p_indices, const double* p_data,
    int64_t n_settings, const char** setting_names,
    const double* setting_vals,
    int64_t n_cone, const char** cone_names, const int64_t* cone_lens,
    const double* cone_data /* concatenated */) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  bool ok = wr(f, kMagic, 8);
  int64_t hdr[3] = {m, n, has_p};
  ok = ok && wr(f, hdr, sizeof(hdr));
  ok = ok && wr(f, b, sizeof(double) * (size_t)m);
  ok = ok && wr(f, c, sizeof(double) * (size_t)n);
  ok = ok && wr(f, &a_nnz, 8);
  ok = ok && wr(f, a_indptr, 8 * (size_t)(n + 1));
  ok = ok && wr(f, a_indices, 8 * (size_t)a_nnz);
  ok = ok && wr(f, a_data, 8 * (size_t)a_nnz);
  if (has_p) {
    ok = ok && wr(f, &p_nnz, 8);
    ok = ok && wr(f, p_indptr, 8 * (size_t)(n + 1));
    ok = ok && wr(f, p_indices, 8 * (size_t)p_nnz);
    ok = ok && wr(f, p_data, 8 * (size_t)p_nnz);
  }
  ok = ok && wr(f, &n_settings, 8);
  for (int64_t i = 0; ok && i < n_settings; ++i) {
    int64_t len = (int64_t)std::strlen(setting_names[i]);
    ok = wr(f, &len, 8) && wr(f, setting_names[i], (size_t)len) &&
         wr(f, &setting_vals[i], 8);
  }
  ok = ok && wr(f, &n_cone, 8);
  int64_t off = 0;
  for (int64_t i = 0; ok && i < n_cone; ++i) {
    int64_t len = (int64_t)std::strlen(cone_names[i]);
    ok = wr(f, &len, 8) && wr(f, cone_names[i], (size_t)len) &&
         wr(f, &cone_lens[i], 8) &&
         wr(f, cone_data + off, 8 * (size_t)cone_lens[i]);
    off += cone_lens[i];
  }
  std::fclose(f);
  return ok ? 0 : 2;
}

// Reads just the header: magic check + dims + nnz counts so the Python
// side can allocate. Returns 0 on success.
int64_t read_problem_header(const char* path, int64_t* m, int64_t* n,
                            int64_t* has_p, int64_t* a_nnz, int64_t* p_nnz) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char magic[8];
  if (!rd(f, magic, 8) || std::memcmp(magic, kMagic, 8) != 0) {
    std::fclose(f);
    return 3;
  }
  int64_t hdr[3];
  if (!rd(f, hdr, sizeof(hdr))) {
    std::fclose(f);
    return 2;
  }
  *m = hdr[0];
  *n = hdr[1];
  *has_p = hdr[2];
  // skip b, c
  std::fseek(f, (long)(8 * (hdr[0] + hdr[1])), SEEK_CUR);
  if (!rd(f, a_nnz, 8)) {
    std::fclose(f);
    return 2;
  }
  *p_nnz = 0;
  if (hdr[2]) {
    std::fseek(f, (long)(8 * (hdr[1] + 1 + 2 * (*a_nnz))), SEEK_CUR);
    if (!rd(f, p_nnz, 8)) {
      std::fclose(f);
      return 2;
    }
  }
  std::fclose(f);
  return 0;
}

// Reads the full body into caller-allocated buffers (sized per the
// header). Settings/cone tails are returned as raw bytes for Python to
// parse (cap via tail_cap; actual length written to tail_len).
int64_t read_problem_body(const char* path, int64_t m, int64_t n,
                          int64_t has_p, int64_t a_nnz, int64_t p_nnz,
                          double* b, double* c, int64_t* a_indptr,
                          int64_t* a_indices, double* a_data,
                          int64_t* p_indptr, int64_t* p_indices,
                          double* p_data, uint8_t* tail, int64_t tail_cap,
                          int64_t* tail_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 8 + 3 * 8, SEEK_SET);
  bool ok = rd(f, b, 8 * (size_t)m) && rd(f, c, 8 * (size_t)n);
  int64_t nnz_check;
  ok = ok && rd(f, &nnz_check, 8) && nnz_check == a_nnz;
  ok = ok && rd(f, a_indptr, 8 * (size_t)(n + 1));
  ok = ok && rd(f, a_indices, 8 * (size_t)a_nnz);
  ok = ok && rd(f, a_data, 8 * (size_t)a_nnz);
  if (has_p) {
    ok = ok && rd(f, &nnz_check, 8) && nnz_check == p_nnz;
    ok = ok && rd(f, p_indptr, 8 * (size_t)(n + 1));
    ok = ok && rd(f, p_indices, 8 * (size_t)p_nnz);
    ok = ok && rd(f, p_data, 8 * (size_t)p_nnz);
  }
  if (ok) {
    int64_t got = (int64_t)std::fread(tail, 1, (size_t)tail_cap, f);
    *tail_len = got;
  }
  std::fclose(f);
  return ok ? 0 : 2;
}

}  // extern "C"
