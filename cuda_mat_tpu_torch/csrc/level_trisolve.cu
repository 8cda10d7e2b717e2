// Hopper (sm_90a) kernel B8: the level-scheduled sparse triangular sweep of
// exact ILU(0), over the factor's own CSR rows of one triangle.
//
// It replaces no TPU kernel.  The JAX package runs a factor whose band is
// wider than one block on its blocked XLA loop (BlockTriangularSolver,
// cuda_mat_tpu/ops/trisolve.py:80): n/B dependent steps, each a dense B x B
// inverse applied to a gather.  On the card that loop is paced by the host
// (about five launches a block), and its block inverses grow as n.B.  The
// reference solves such factors with cuSPARSE's level-scheduled csrsv
// (pbicgstab.cu:92-98, analysis at :338-345), and so does this kernel.
//
// Layout (cuda_mat_tpu_torch/ops/level_trisolve.py, LevelPlan): the rows of
// the triangle in level order, position p holding row rows[p], whose entries
// (columns ascending) are cols/vals[ptr[p] .. ptr[p+1]); level l is positions
// level_ptr[l] .. level_ptr[l+1].  A row's level is one more than the deepest
// row it depends on, so the rows of a level depend only on earlier levels.
//
//   y[row] = f[row] - sum_e vals[e] * y[cols[e]]            (forward, unit L)
//   y[row] = (f[row] - sum_e vals[e] * y[cols[e]]) / diag[p] (backward, U)
//
// What bounds it: the chain of levels (7N - 6 a sweep for a 27-point N^3
// grid), not bytes.  A level holds a few thousand rows at most, so each
// level's work is a few hundred kilobytes and a few microseconds' latency at
// best.  The design spends one launch a sweep: a persistent cooperative grid
// walks all levels with a grid-wide barrier between them (a launch a level
// would put thousands of host launches in each iteration).  Each thread owns
// position level_ptr[l] + t of every level (more only where a level outgrows
// the grid), t numbering the grid's warps across the blocks first, so a
// level's rows spread over every SM (on an H100 at HPCG 104^3 a level went
// from 3.05 to 2.78 us: the gathers no longer queue on a few SMs).  A
// thread fetches its row's pointers, right-hand side, diagonal and first
// kHeld entries into registers before the barrier that opens the level, so
// after it only the gather of the solved values remains.  Solved values are
// read through L2 (ld.global.cg): L1 is not coherent across blocks, and a
// line of y may sit in it from before the row's level.
//
// On an H100 a level costs about 2.8 us: the grid barrier alone 1.16 us,
// the gathers about 0.55, the rest the fetch's dependent loads, the
// arithmetic and the store (PERF.md, B8's row).
//
// Products and sums use the _rn intrinsics, which nvcc never contracts into
// an FMA, summed in the row's column order from 0, as the plain twin
// (level_sweep_plain) forms them.
//
// The launcher is extern "C" for ctypes: it launches on the caller's stream,
// never synchronises, allocates nothing, and returns the launch's error code
// (or kBadArgs for arguments the kernel does not take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBadArgs = -1;
constexpr int kThreads = 128;  // four warps a block
constexpr int kHeld = 16;      // entries of a row fetched ahead of its level

template <typename T>
struct Args {
  const T* f;
  T* y;
  const int* level_ptr;
  const int* rows;
  const int* ptr;
  const int* cols;
  const T* vals;
  const T* diag;  // nullptr: unit diagonal (the forward sweep)
  int levels;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// One row, fetched ahead of its level: everything but the solved values.
template <typename T>
struct Row {
  int p, row, lo, hi;
  T rhs, d;
  int col[kHeld];
  T val[kHeld];
};

template <typename T, bool UNIT>
__device__ __forceinline__ void fetch(Row<T>& r, const Args<T>& a, int p,
                                      int end) {
  r.p = p;
  if (p >= end) return;
  r.row = __ldg(a.rows + p);
  r.lo = __ldg(a.ptr + p);
  r.hi = __ldg(a.ptr + p + 1);
  r.rhs = __ldg(a.f + r.row);
  if (!UNIT) r.d = __ldg(a.diag + p);
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (r.lo + k < r.hi) {
      r.col[k] = __ldg(a.cols + r.lo + k);
      r.val[k] = __ldg(a.vals + r.lo + k);
    }
  }
}

template <typename T, bool UNIT>
__device__ __forceinline__ void solve(const Row<T>& r, const Args<T>& a) {
  T got[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k)
    got[k] = r.lo + k < r.hi ? __ldcg(a.y + r.col[k]) : T(0);
  T s = T(0);
#pragma unroll
  for (int k = 0; k < kHeld; ++k)
    if (r.lo + k < r.hi) s = add_rn(s, mul_rn(r.val[k], got[k]));
  for (int e = r.lo + kHeld; e < r.hi; ++e)
    s = add_rn(s, mul_rn(__ldg(a.vals + e), __ldcg(a.y + __ldg(a.cols + e))));
  const T v = sub_rn(r.rhs, s);
  a.y[r.row] = UNIT ? v : div_rn(v, r.d);
}

// B8: one sweep, all levels, in one cooperative launch.
template <typename T, bool UNIT>
__global__ void __launch_bounds__(kThreads)
level_sweep_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int t = (warp * static_cast<int>(gridDim.x) +
                 static_cast<int>(blockIdx.x)) * 32 +
                static_cast<int>(threadIdx.x) % 32;
  const int stride = static_cast<int>(gridDim.x) * kThreads;
  int lo = __ldg(a.level_ptr), hi = __ldg(a.level_ptr + 1);
  Row<T> r;
  fetch<T, UNIT>(r, a, lo + t, hi);
  for (int l = 0; l < a.levels; ++l) {
    if (r.p < hi) {
      solve<T, UNIT>(r, a);
      for (int p = r.p + stride; p < hi; p += stride) {
        fetch<T, UNIT>(r, a, p, hi);
        solve<T, UNIT>(r, a);
      }
    }
    if (l + 1 < a.levels) {
      lo = hi;
      hi = __ldg(a.level_ptr + l + 2);
      fetch<T, UNIT>(r, a, lo + t, hi);
      grid.sync();
    }
  }
}

template <typename T, bool UNIT>
int launch(const Args<T>& a, int blocks, cudaStream_t st) {
  void* kern = reinterpret_cast<void*>(level_sweep_kernel<T, UNIT>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cooperative grid must be resident at once
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  Args<T> args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), params, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* f, void* y, const int* level_ptr, const int* rows,
             const int* ptr, const int* cols, const void* vals,
             const void* diag, int levels, int blocks, cudaStream_t st) {
  const Args<T> a{static_cast<const T*>(f), static_cast<T*>(y), level_ptr,
                  rows, ptr, cols, static_cast<const T*>(vals),
                  static_cast<const T*>(diag), levels};
  return diag == nullptr ? launch<T, true>(a, blocks, st)
                         : launch<T, false>(a, blocks, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  The index arrays are int32 on the
// device (level_ptr: levels + 1, rows: n, ptr: n + 1, cols: entries); diag
// null for the forward sweep over unit-lower L.  blocks: the grid, at least
// 1 (cut to what the card holds at once).
int cmt_level_sweep(int dtype, const void* f, void* y, const int* level_ptr,
                    const int* rows, const int* ptr, const int* cols,
                    const void* vals, const void* diag, int levels,
                    int blocks, void* stream) {
  if (levels < 0 || blocks < 1) return kBadArgs;
  if (levels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(f, y, level_ptr, rows, ptr, cols, vals, diag,
                           levels, blocks, s);
  if (dtype == 1)
    return dispatch<double>(f, y, level_ptr, rows, ptr, cols, vals, diag,
                            levels, blocks, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
