// Hopper (sm_90a) kernel B7: the 2-D tile-ring grid-stencil SpMV of
// StencilOperator2D (cuda_mat_tpu_torch/ops/stencil2d.py).
//
// Layout (shared with the JAX package): an R x C grid is stored as a
// (rp + 2 tr) x (cp + 2 tc) row-major array, rp and cp the grid rounded up
// to whole tr x tc tiles, with one ring of zero tiles around it.  The output
// is 0 on the ring; an interior cell (i, j) (0 <= i < rp, 0 <= j < cp) is
//   y = sum_k coef_k(i, j) * x[i + dr_k, j + dc_k]
// in term order, where coef_k is a scalar (constant coefficient) or the
// (i, j) entry of the k-th (rp, cp) grid of a stacked coefficient array
// (variable coefficients).  With `mask`, cells past the true grid (i >= r or
// j >= c) are 0 too.
//
// Replaces stencil_spmv_padded / _stencil_kernel
// (cuda_mat_tpu/ops/pallas_stencil.py:101, :53).  The TPU kernel assembled
// each output tile from nine neighbouring tile views in VMEM; here one
// thread computes one output cell and reads its neighbours straight from
// device memory (neighbouring threads, neighbouring addresses; the rows
// above and below hit L2).  Bound by device memory: x read once and y
// written once, plus one (rp, cp) grid per variable coefficient.  Block rows
// map to grid rows, so no thread divides an index.  Products and sums use
// the _rn intrinsics, so the kernel equals its plain PyTorch twin bit for
// bit.
//
// The launcher is extern "C" for ctypes: it launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError() (or
// kBadArgs for arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 64;
constexpr int kBadArgs = -1;
constexpr int kThreads = 256;
constexpr int kMaxGridRows = 65535;

struct Terms2D {
  int n;
  int dr[kMaxTerms];
  int dc[kMaxTerms];
  int var[kMaxTerms];  // index into the coefficient stack, -1 for a scalar
  double c[kMaxTerms];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void stencil2d_kernel(const T* __restrict__ x,
                                 const T* __restrict__ coeffs,
                                 T* __restrict__ y,
                                 const __grid_constant__ Terms2D t,
                                 int rows, int cols, int tr, int tc, int rp,
                                 int cp, int r, int c, int mask) {
  const int jj = blockIdx.x * blockDim.x + threadIdx.x;
  if (jj >= cols) return;
  for (int ii = blockIdx.y; ii < rows; ii += gridDim.y) {
    const long long at = static_cast<long long>(ii) * cols + jj;
    const int i = ii - tr;
    const int j = jj - tc;
    T out = T(0);
    if (i >= 0 && i < rp && j >= 0 && j < cp && !(mask && (i >= r || j >= c))) {
      const long long cell = static_cast<long long>(i) * cp + j;
      for (int k = 0; k < t.n; ++k) {
        const T xv = x[at + static_cast<long long>(t.dr[k]) * cols + t.dc[k]];
        const T coef = t.var[k] < 0
                           ? static_cast<T>(t.c[k])
                           : coeffs[static_cast<long long>(t.var[k]) * rp * cp +
                                    cell];
        const T term = mul_rn(coef, xv);
        out = k == 0 ? term : add_rn(out, term);
      }
    }
    y[at] = out;
  }
}

template <typename T>
int launch(const void* x, const void* coeffs, void* y, const Terms2D& t,
           int tr, int tc, int rp, int cp, int r, int c, int mask,
           cudaStream_t stream) {
  const int rows = rp + 2 * tr;
  const int cols = cp + 2 * tc;
  dim3 grid((cols + kThreads - 1) / kThreads,
            rows < kMaxGridRows ? rows : kMaxGridRows);
  stencil2d_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(coeffs),
      static_cast<T*>(y), t, rows, cols, tr, tc, rp, cp, r, c, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  var[k] >= 0 names the coefficient grid
// of term k in `coeffs` ((n_var, rp, cp), may be null when no term has one).
int cmt_stencil2d_spmv(int dtype, const void* x, const void* coeffs, void* y,
                       const int* dr, const int* dc, const int* var,
                       const double* c, int nterms, int tr, int tc, int rp,
                       int cp, int r, int cgrid, int mask, void* stream) {
  if (nterms < 1 || nterms > kMaxTerms || tr <= 0 || tc <= 0 || rp <= 0 ||
      cp <= 0 || rp % tr != 0 || cp % tc != 0)
    return kBadArgs;
  Terms2D t;
  t.n = nterms;
  for (int k = 0; k < nterms; ++k) {
    if (dr[k] < -tr || dr[k] > tr || dc[k] < -tc || dc[k] > tc)
      return kBadArgs;
    if (var[k] >= 0 && coeffs == nullptr) return kBadArgs;
    t.dr[k] = dr[k];
    t.dc[k] = dc[k];
    t.var[k] = var[k];
    t.c[k] = c[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, coeffs, y, t, tr, tc, rp, cp, r, cgrid, mask, s);
  if (dtype == 1)
    return launch<double>(x, coeffs, y, t, tr, tc, rp, cp, r, cgrid, mask, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
