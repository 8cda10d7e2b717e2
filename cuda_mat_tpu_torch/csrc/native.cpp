// Native (C++) ingestion + setup hot spots for cuda_mat_tpu_torch: the
// port's own copy of the JAX package's native source (the code is the
// same, so both packages parse and factorize identically).
//
// Counterpart of the reference's C/C++ host runtime: the NIST Matrix Market
// reader (reference mmio.c) + COO->CSR conversion pipeline with
// symmetrization and validation (reference mmio_wrapper.h:133-348), and the
// ILU(0) setup factorization (the role of cusparseDcsrilu0 at reference
// pbicgstab.cu:359 — here a host-side setup phase, since the factor is built
// once and then applied on-device by the banded triangular solver).
//
// Exposed via a plain C ABI consumed with ctypes (see native/loader.py); the
// Python implementations in io/mmio.py and reference/cpu_solvers.py are the
// semantics oracles and the fallback when this library is not built.
//
// Built with g++ at first use by native/loader.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CsrHandle {
  int64_t n = 0, m = 0, nnz = 0;
  std::vector<double> data;
  std::vector<int32_t> indices;
  std::vector<int32_t> indptr;
};

// Skip whitespace (including newlines) in a buffer.
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
  return p;
}

}  // namespace

extern "C" {

// Parse a Matrix Market coordinate file into a verified base-0 CSR.
// Returns 0 on success; negative codes on error:
//   -1 io error, -2 bad banner/unsupported type, -3 malformed body,
//   -4 index out of range, -5 duplicate entry / unsorted after compress.
int cmt_mm_open(const char* path, int symmetrize, void** out_handle,
                int64_t* out_n, int64_t* out_m, int64_t* out_nnz) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // read whole file (the bench fixtures are up to a few hundred MB)
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(fsize));
  if (fsize > 0 && std::fread(&buf[0], 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  const char* p = buf.data();
  const char* end = p + buf.size();

  // banner line
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  if (!nl) return -2;
  std::string banner(p, nl);
  p = nl + 1;
  char obj[64] = {0}, fmt[64] = {0}, field[64] = {0}, sym[64] = {0};
  if (std::sscanf(banner.c_str(), "%%%%MatrixMarket %63s %63s %63s %63s", obj,
                  fmt, field, sym) != 4)
    return -2;
  for (char* s : {obj, fmt, field, sym})
    for (char* c = s; *c; ++c) *c = std::tolower(*c);
  if (std::strcmp(obj, "matrix") != 0) return -2;
  if (std::strcmp(fmt, "coordinate") != 0) return -2;  // dense rejected
  if (std::strcmp(field, "real") != 0 && std::strcmp(field, "integer") != 0)
    return -2;  // pattern/complex rejected (reference mmio_wrapper.h:166-169)
  bool is_sym = !std::strcmp(sym, "symmetric") || !std::strcmp(sym, "hermitian");
  bool is_skew = !std::strcmp(sym, "skew-symmetric");
  if (!is_sym && !is_skew && std::strcmp(sym, "general") != 0) return -2;

  // comments, then size line
  while (p < end) {
    p = skip_ws(p, end);
    if (p < end && *p == '%') {
      const char* q = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!q) return -3;
      p = q + 1;
    } else {
      break;
    }
  }
  char* endp = nullptr;
  int64_t n = std::strtoll(p, &endp, 10);
  p = endp;
  int64_t m = std::strtoll(p, &endp, 10);
  p = endp;
  int64_t nnz_stored = std::strtoll(p, &endp, 10);
  p = endp;
  if (n <= 0 || m <= 0 || nnz_stored < 0) return -3;

  std::vector<int32_t> rows, cols;
  std::vector<double> vals;
  size_t cap = static_cast<size_t>(nnz_stored) *
               ((is_sym || is_skew) ? 2 : 1);
  rows.reserve(cap);
  cols.reserve(cap);
  vals.reserve(cap);
  for (int64_t k = 0; k < nnz_stored; ++k) {
    long r = std::strtol(p, &endp, 10);
    if (endp == p) return -3;
    p = endp;
    long c = std::strtol(p, &endp, 10);
    if (endp == p) return -3;
    p = endp;
    double v = std::strtod(p, &endp);
    if (endp == p) return -3;
    p = endp;
    // MM files are 1-based
    if (r < 1 || r > n || c < 1 || c > m) return -4;
    rows.push_back(static_cast<int32_t>(r - 1));
    cols.push_back(static_cast<int32_t>(c - 1));
    vals.push_back(v);
    if (symmetrize && (is_sym || is_skew) && r != c) {
      // mirror off-diagonal entries (reference mmio_wrapper.h:172-230;
      // skew mirrors negated, :205-206)
      rows.push_back(static_cast<int32_t>(c - 1));
      cols.push_back(static_cast<int32_t>(r - 1));
      vals.push_back(is_skew ? -v : v);
    }
  }

  const int64_t nnz = static_cast<int64_t>(vals.size());
  // row-major sort via permutation (reference mmio_wrapper.h:251-258)
  std::vector<int64_t> perm(nnz);
  for (int64_t i = 0; i < nnz; ++i) perm[i] = i;
  std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });

  auto h = new CsrHandle;
  h->n = n;
  h->m = m;
  h->nnz = nnz;
  h->data.resize(nnz);
  h->indices.resize(nnz);
  h->indptr.assign(n + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t src = perm[i];
    h->data[i] = vals[src];
    h->indices[i] = cols[src];
    h->indptr[rows[src] + 1] += 1;
  }
  for (int64_t i = 0; i < n; ++i) h->indptr[i + 1] += h->indptr[i];
  // verify: strictly increasing columns per row (duplicates rejected,
  // reference verify_pattern, mmio_wrapper.h:91-130)
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t k = h->indptr[i] + 1; k < h->indptr[i + 1]; ++k) {
      if (h->indices[k] <= h->indices[k - 1]) {
        delete h;
        return -5;
      }
    }
  }

  *out_handle = h;
  *out_n = n;
  *out_m = m;
  *out_nnz = nnz;
  return 0;
}

void cmt_mm_fill_csr(void* handle, void* data, void* indices, void* indptr) {
  auto h = static_cast<CsrHandle*>(handle);
  std::memcpy(data, h->data.data(), h->data.size() * sizeof(double));
  std::memcpy(indices, h->indices.data(), h->indices.size() * sizeof(int32_t));
  std::memcpy(indptr, h->indptr.data(), h->indptr.size() * sizeof(int32_t));
}

void cmt_mm_close(void* handle) { delete static_cast<CsrHandle*>(handle); }

}  // extern "C"

// ILU(0) / MILU(0): in-place on mvals (a copy of the CSR values), same
// row-wise IKJ elimination restricted to the pattern as the Python oracle
// (reference/cpu_solvers.py ilu0_factorize).  With omega != 0,
// the update terms that fall OUTSIDE the pattern ("dropped fill") are
// accumulated per row and omega times their sum is subtracted from the
// row's diagonal — the classic modified-ILU row-sum correction (omega = 1
// preserves A's row sums exactly; 0 < omega < 1 is relaxed MILU, which
// conditions the Laplacian family far better than plain ILU(0) while
// keeping the factor diagonally dominant enough for the truncated Neumann
// series — measured sweeps in BASELINE.md r4).
// Returns 0 on success, (row+1) if a diagonal entry is missing, or (k+1)
// when pivot k is zero at the moment it is used.  The pivot check must be
// lazy, not eager: a stored-zero diagonal can become nonzero during
// elimination before any row uses it (mat3.mtx row 1 is exactly this case,
// and the reference factorizes it fine).
static int64_t ilu0_impl(int64_t n, const int32_t* indptr,
                         const int32_t* indices, double* m, double omega) {
  std::vector<int64_t> diag(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t lo = indptr[i], hi = indptr[i + 1];
    const int32_t* first = indices + lo;
    const int32_t* last = indices + hi;
    const int32_t* it = std::lower_bound(first, last, static_cast<int32_t>(i));
    if (it == last || *it != i) return i + 1;
    diag[i] = lo + (it - first);
  }
  for (int64_t i = 0; i < n; ++i) {
    const int32_t lo = indptr[i], hi = indptr[i + 1];
    double dropped = 0.0;
    for (int32_t kk = lo; kk < static_cast<int32_t>(diag[i]); ++kk) {
      const int32_t k = indices[kk];
      const double pivot = m[diag[k]];
      if (pivot == 0.0) return k + 1;
      const double lik = m[kk] / pivot;
      m[kk] = lik;
      // subtract lik * U(k, j) for j > k present in row i's tail; with
      // MILU, sum the terms for absent j instead of silently dropping them
      const int32_t klo = static_cast<int32_t>(diag[k]) + 1;
      const int32_t khi = indptr[k + 1];
      int32_t ti = kk + 1;  // row i tail cursor (sorted)
      for (int32_t kj = klo; kj < khi; ++kj) {
        const int32_t col = indices[kj];
        while (ti < hi && indices[ti] < col) ++ti;
        if (ti < hi && indices[ti] == col) {
          m[ti] -= lik * m[kj];
        } else if (omega != 0.0) {
          dropped += lik * m[kj];
        } else if (ti >= hi) {
          break;  // plain ILU(0): nothing left to match in row i's tail
        }
      }
    }
    if (omega != 0.0) m[diag[i]] -= omega * dropped;
  }
  return 0;
}

extern "C" {

int64_t cmt_ilu0(int64_t n, const void* indptr_v, const void* indices_v,
                 void* mvals_v) {
  return ilu0_impl(n, static_cast<const int32_t*>(indptr_v),
                   static_cast<const int32_t*>(indices_v),
                   static_cast<double*>(mvals_v), 0.0);
}

int64_t cmt_milu0(int64_t n, const void* indptr_v, const void* indices_v,
                  void* mvals_v, double omega) {
  return ilu0_impl(n, static_cast<const int32_t*>(indptr_v),
                   static_cast<const int32_t*>(indices_v),
                   static_cast<double*>(mvals_v), omega);
}

}  // extern "C"
