// Hopper (sm_90a) kernel B3: banded (DIA) SpMV on block-halo padded vectors.
//
// Layout (shared with the JAX package's PallasDIAOperator): a vector of n
// rows is stored padded to npad (a multiple of `block`) with a zero tail, and
// one zero block of `block` elements sits on each side, so x_pad and y have
// npad + 2*block elements.  The matrix is `ndiag` row-aligned diagonals,
// stacked contiguously as data[d * npad + q] = A[q, q + off_d] (zero past n
// and wherever q + off_d leaves the matrix).  Every |off_d| <= block, so a
// read x_pad[j + off_d] for a true-block row j never leaves the array; rows
// near the ends read the zero pad blocks.
//
// One launch takes a batch of S such problems (the row shards a process
// holds): S vectors of npad + 2*block one after another, and each
// diagonal's S rows of npad, data[(d * S + i) * npad + q].  Shard i is an
// instance of its own, on grid row blockIdx.y = i.
//
// The kernel writes every element of its output, pads included: the wrapper
// allocates it with torch.empty.  Products and sums use the _rn intrinsics,
// which nvcc never contracts into an FMA, and the sum starts from the first
// product (not from 0 + product, which would turn a -0 into +0), so the
// kernel equals its plain PyTorch twin (cuda_mat_tpu_torch/ops/dia_spmv.py)
// bit for bit.
//
// The launcher is extern "C" for ctypes: it launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError() (or
// kBadArgs for arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 128;  // the factor operators are built with up to 128
constexpr int kBadArgs = -1;
constexpr int kThreads = 256;

// Diagonal offsets go to the kernel by value, in its parameter space (512
// bytes at most); __grid_constant__ lets the kernel index them there without
// a copy to local memory.
struct Offsets {
  int n;
  int off[kMaxDiags];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// B3. Replaces dia_spmv_block_padded / _dia_block_kernel
// (cuda_mat_tpu/ops/pallas_spmv.py:75, :43):
//   y[j] = sum_d data[d, j - block] * x[j + off_d]   for j in [block, block + npad),
//   0 in both pad blocks; diagonals summed in ascending-offset order; each
//   shard of a batch on its own (one thread a row over S (npad + 2 block)).
// Bound by device memory: it reads each diagonal once, x once and writes y
// once ((ndiag + 2) * itemsize bytes per row).  One thread per output row:
// neighbouring threads read neighbouring elements of each diagonal and of
// each shifted x window, so every access coalesces, and the ndiag shifted
// reads of x mostly hit the same cache lines.  All index arithmetic is 32-bit
// (the launcher refuses npad + 2*block >= 2^31) except the start of each
// diagonal's row.
template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                const __grid_constant__ Offsets offs, int npad,
                                int block) {
  const int j = static_cast<int>(blockIdx.x) * kThreads
                + static_cast<int>(threadIdx.x);
  const int total = npad + 2 * block;
  if (j >= total) return;
  const long long shard = blockIdx.y;
  const long long dstride = static_cast<long long>(gridDim.y) * npad;
  data += shard * npad;
  x += shard * total;
  const int q = j - block;
  T out = T(0);
  if (q >= 0 && q < npad) {
    out = mul_rn(data[q], x[j + offs.off[0]]);
    for (int d = 1; d < offs.n; ++d)
      out = add_rn(out, mul_rn(data[d * dstride + q], x[j + offs.off[d]]));
  }
  y[shard * total + j] = out;
}

template <typename T>
int launch(const void* data, const void* x, void* y, const Offsets& offs,
           int npad, int block, int nshards, cudaStream_t stream) {
  const int total = npad + 2 * block;
  const int grid = (total + kThreads - 1) / kThreads;
  dia_spmv_kernel<T><<<dim3(grid, nshards), kThreads, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), offs, npad, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  offsets: ndiag ints, each |off| <= block.
// nshards: the shards of the batch (1 for one vector).
int cmt_dia_spmv(int dtype, const void* data, const void* x, void* y,
                 const int* offsets, int ndiag, long long npad,
                 long long block, int nshards, void* stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || block <= 0 || npad < 0 ||
      npad % block != 0 || npad + 2 * block >= (1LL << 31) || nshards < 1 ||
      nshards > 65535)
    return kBadArgs;
  Offsets offs;
  offs.n = ndiag;
  for (int d = 0; d < ndiag; ++d) {
    if (offsets[d] > block || offsets[d] < -block) return kBadArgs;
    offs.off[d] = offsets[d];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(npad), b = static_cast<int>(block);
  if (dtype == 0) return launch<float>(data, x, y, offs, np, b, nshards, s);
  if (dtype == 1) return launch<double>(data, x, y, offs, np, b, nshards, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
