// Hopper (sm_90a) kernels of the gap-strided constant-stencil solve path.
//
// Layout (shared with the JAX package, cuda_mat_tpu.ops.pallas_stencil):
// a vector of the R x C grid is stored gap-strided, each grid row padded to
// stride S >= C with zero gap cells, then block-halo padded: one zero block
// of `block` elements on each side and a zero tail [np_true, npad) after the
// R*S true strided rows.  A stencil read that crosses a grid-row seam lands in
// a zero gap cell, so no kernel masks seams per element; the output's gap
// cells are re-zeroed by one multiply with the 0/1 gap mask (periodic in S,
// and block % S == 0, so gap[q % block] is the mask of strided row q).
//
// Every kernel writes every element of its outputs, pads included: the
// wrapper allocates them with torch.empty.  Products and sums use the _rn
// intrinsics, which nvcc never contracts into an FMA, so each kernel equals
// its plain PyTorch twin (cuda_mat_tpu_torch/ops/stencil.py) bit for bit.
//
// Launchers are extern "C" for ctypes: they launch on the caller's stream,
// never synchronise, allocate nothing, and return cudaGetLastError() (or
// kBadArgs for arguments the kernels do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 64;
constexpr int kBadArgs = -1;
constexpr int kThreads = 256;

// Stencil terms go to the kernel by value, in its parameter space;
// __grid_constant__ lets the kernels index them there without a copy to
// local memory.
struct Terms {
  int n;
  long long off[kMaxTerms];
  double c[kMaxTerms];
};

bool fill_terms(Terms* t, const long long* off, const double* c, int n) {
  if (n < 1 || n > kMaxTerms) return false;
  t->n = n;
  for (int k = 0; k < n; ++k) {
    t->off[k] = off[k];
    t->c[k] = c[k];
  }
  return true;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// sum_k c_k * v[i + off_k] in term order (the JAX kernels' order), every
// product and partial sum rounded on its own.
template <typename T>
__device__ __forceinline__ T stencil_sum(const Terms& t, const T* v,
                                         long long i) {
  T acc = mul_rn(static_cast<T>(t.c[0]), v[i + t.off[0]]);
  for (int k = 1; k < t.n; ++k)
    acc = add_rn(acc, mul_rn(static_cast<T>(t.c[k]), v[i + t.off[k]]));
  return acc;
}

// B1. Replaces const_stencil_spmv_padded / _const_stencil_kernel
// (cuda_mat_tpu/ops/pallas_stencil.py:306, :262):
//   y[j] = gap(q) * sum_k c_k x[j + off_k]   for strided row q = j - block,
//   0 in the pad blocks and for global rows base + q >= np_true.
// Bound by device memory: about 8 bytes per element in f32 (read x once,
// write y once; the neighbouring terms' reads hit the same or adjacent cache
// lines, and the gap mask stays in L2).  One thread per output element keeps
// neighbouring threads on neighbouring addresses, so every access coalesces.
template <typename T>
__global__ void const_stencil_spmv_kernel(const T* __restrict__ x,
                                          const T* __restrict__ gap,
                                          T* __restrict__ y,
                                          const __grid_constant__ Terms terms,
                                          long long npad, long long block,
                                          long long np_true, long long base) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (j >= npad + 2 * block) return;
  const long long q = j - block;
  T out = T(0);
  if (q >= 0 && q < npad && base + q < np_true)
    out = mul_rn(stencil_sum(terms, x, j), gap[q % block]);
  y[j] = out;
}

// B2. Replaces const_series_msolve_padded / _const_msolve_kernel +
// _msolve_series_interior (pallas_stencil.py:624, :524, :474): the fused
// Neumann-series M-solve
//   u = (P_l x) * gap * inv_d,  zeroed outside global rows [0, np_true)
//   y = (P_u u) * gap,          zeroed in the pads and the tail.
// Bound by device memory: it reads x and inv_d and writes y (about 12 bytes
// per element in f32).  The intermediate u never goes to device memory: each
// thread block owns an output tile of `tile` rows and builds u over
// [tile0 - halo, tile0 + tile + halo) in shared memory, halo = max|off_u|.
// Blocks run in any order, so each one recomputes its own halo of u (2*halo
// extra P_l rows per tile) instead of carrying state between grid steps as
// the TPU's sequential grid did.
template <typename T>
__global__ void const_series_msolve_kernel(
    const T* __restrict__ x, const T* __restrict__ inv_d,
    const T* __restrict__ gap_ext, T* __restrict__ y,
    const __grid_constant__ Terms tl, const __grid_constant__ Terms tu,
    long long npad, long long block, long long np_true, long long base,
    int hpad_ext, int halo, int tile) {
  extern __shared__ unsigned char smem_raw[];
  T* u = reinterpret_cast<T*>(smem_raw);
  const T* gap = gap_ext + hpad_ext;  // gap[m], m in [0, block)
  const long long tile0 = static_cast<long long>(blockIdx.x) * tile;
  // tile divides block, so a tile lies wholly in a pad or wholly inside
  if (tile0 < block || tile0 >= block + npad) {
    for (int m = threadIdx.x; m < tile; m += blockDim.x) y[tile0 + m] = T(0);
    return;
  }
  const int ext = tile + 2 * halo;
  for (int e = threadIdx.x; e < ext; e += blockDim.x) {
    const long long p = tile0 - halo + e;  // padded position of u[e]
    const long long q = p - block;         // strided row, >= -halo
    T v = T(0);
    if (base + q >= 0 && base + q < np_true)
      v = mul_rn(mul_rn(stencil_sum(tl, x, p), gap[(q + block) % block]),
                 inv_d[p]);
    u[e] = v;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < tile; m += blockDim.x) {
    const long long q = tile0 + m - block;
    T out = T(0);
    if (base + q < np_true)
      out = mul_rn(stencil_sum(tu, static_cast<const T*>(u),
                               static_cast<long long>(halo + m)),
                   gap[q % block]);
    y[tile0 + m] = out;
  }
}

// B6. Replaces const_stencil_spmv_dots_padded / _const_stencil_dots_kernel
// (pallas_stencil.py:416, :353): B1's y, plus per-thread-block partials of
// <w, y> (w given) and, with `with_self`, <y, y>, written to a
// (grid, n_dots) array that the wrapper sums over blocks.  One thread per
// output element as in B1; each block of kThreads threads reduces its
// products by a fixed halving tree in shared memory (h = kThreads/2, ..., 1),
// so the partials are the same from run to run and no atomics are needed.
// Bound by device memory: x and the weights read once, y written once.
constexpr int kMaxDots = 2;

template <typename T>
__global__ void const_stencil_spmv_dots_kernel(
    const T* __restrict__ x, const T* __restrict__ gap,
    const T* __restrict__ w, T* __restrict__ y, T* __restrict__ partials,
    const __grid_constant__ Terms terms, long long npad, long long block,
    long long np_true, long long base, int with_self) {
  __shared__ __align__(8) unsigned char raw[kMaxDots * kThreads * sizeof(T)];
  T* s = reinterpret_cast<T*>(raw);
  const int tid = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long q = j - block;
  T out = T(0);
  if (q >= 0 && q < npad && base + q < np_true)
    out = mul_rn(stencil_sum(terms, x, j), gap[q % block]);
  y[j] = out;
  const int n_w = w != nullptr;
  const int n_dots = n_w + with_self;
  if (n_w) s[tid] = mul_rn(w[j], out);
  if (with_self) s[n_w * kThreads + tid] = mul_rn(out, out);
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h)
      for (int d = 0; d < n_dots; ++d)
        s[d * kThreads + tid] = add_rn(s[d * kThreads + tid],
                                       s[d * kThreads + tid + h]);
    __syncthreads();
  }
  if (tid < n_dots)
    partials[static_cast<long long>(blockIdx.x) * n_dots + tid] =
        s[tid * kThreads];
}

// B5. Replaces const_series_msolve_fma_padded / _const_msolve_fma_kernel
// (pallas_stencil.py:681, :554): B2 with the solver's BLAS1 update folded in
// ahead of it,
//   p = a + c1 * (b + c2 * c)   (c given)   or   p = a + c1 * b,
//   y = B2(p),
// returning both p and y.  The scalars c1, c2 are read from device memory
// (0-d tensors of the loop), so the host never waits for them.  Bound by
// device memory: it reads a, b, (c,) inv_d and writes p and y; the combined
// p never makes a round trip through device memory before the series reads
// it.  Each thread block owns an output tile as in B2 and first computes p
// over the window that P_l reads for its u region,
// [tile0 - halo - h_l, tile0 + tile + halo + h_l), into shared memory.
template <typename T>
__global__ void const_series_msolve_fma_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ c1p, const T* __restrict__ c2p,
    const T* __restrict__ inv_d, const T* __restrict__ gap_ext,
    T* __restrict__ p_out, T* __restrict__ y,
    const __grid_constant__ Terms tl, const __grid_constant__ Terms tu,
    long long npad, long long block, long long np_true, long long base,
    int hpad_ext, int h_l, int halo, int tile) {
  extern __shared__ unsigned char smem_raw[];
  T* pw = reinterpret_cast<T*>(smem_raw);  // p over the P_l window
  const int extp = tile + 2 * (halo + h_l);
  T* u = pw + extp;                        // u over the tile and its halo
  const T* gap = gap_ext + hpad_ext;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tile;
  if (tile0 < block || tile0 >= block + npad) {
    for (int m = threadIdx.x; m < tile; m += blockDim.x) {
      p_out[tile0 + m] = T(0);
      y[tile0 + m] = T(0);
    }
    return;
  }
  const T c1 = *c1p;
  const T c2 = c != nullptr ? *c2p : T(0);
  const long long w0 = tile0 - halo - h_l;
  for (int e = threadIdx.x; e < extp; e += blockDim.x) {
    const long long j = w0 + e;
    T t;
    if (c != nullptr) {
      t = mul_rn(c2, c[j]);
      t = add_rn(b[j], t);
      t = mul_rn(c1, t);
    } else {
      t = mul_rn(c1, b[j]);
    }
    pw[e] = add_rn(a[j], t);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < tile; m += blockDim.x)
    p_out[tile0 + m] = pw[halo + h_l + m];
  const int ext = tile + 2 * halo;
  for (int e = threadIdx.x; e < ext; e += blockDim.x) {
    const long long q = tile0 - halo + e - block;
    T v = T(0);
    if (base + q >= 0 && base + q < np_true)
      v = mul_rn(mul_rn(stencil_sum(tl, static_cast<const T*>(pw),
                                    static_cast<long long>(h_l + e)),
                        gap[(q + block) % block]),
                 inv_d[tile0 - halo + e]);
    u[e] = v;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < tile; m += blockDim.x) {
    const long long q = tile0 + m - block;
    T out = T(0);
    if (base + q < np_true)
      out = mul_rn(stencil_sum(tu, static_cast<const T*>(u),
                               static_cast<long long>(halo + m)),
                   gap[q % block]);
    y[tile0 + m] = out;
  }
}

template <typename T>
int launch_spmv(const void* x, const void* gap, void* y, const Terms& t,
                long long npad, long long block, long long np_true,
                long long base, cudaStream_t stream) {
  const long long total = npad + 2 * block;
  const long long grid = (total + kThreads - 1) / kThreads;
  const_stencil_spmv_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                                 stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gap),
      static_cast<T*>(y), t, npad, block, np_true, base);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_msolve(const void* x, const void* inv_d, const void* gap_ext,
                  void* y, const Terms& tl, const Terms& tu, long long npad,
                  long long block, long long np_true, long long base,
                  int hpad_ext, int halo, int tile, cudaStream_t stream) {
  if (tile <= 0 || block % tile != 0 || halo < 0) return kBadArgs;
  const size_t smem = sizeof(T) * static_cast<size_t>(tile + 2 * halo);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        const_series_msolve_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (npad + 2 * block) / tile;
  const_series_msolve_kernel<T><<<static_cast<unsigned>(grid), kThreads, smem,
                                  stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(inv_d),
      static_cast<const T*>(gap_ext), static_cast<T*>(y), tl, tu, npad, block,
      np_true, base, hpad_ext, halo, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmv_dots(const void* x, const void* gap, const void* w, void* y,
                     void* partials, const Terms& t, long long npad,
                     long long block, long long np_true, long long base,
                     int with_self, cudaStream_t stream) {
  const long long total = npad + 2 * block;
  if (total % kThreads != 0 || (w == nullptr && !with_self)) return kBadArgs;
  const_stencil_spmv_dots_kernel<T><<<static_cast<unsigned>(total / kThreads),
                                      kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gap),
      static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<T*>(partials), t, npad, block, np_true, base,
      with_self != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_msolve_fma(const void* a, const void* b, const void* c,
                      const void* c1, const void* c2, const void* inv_d,
                      const void* gap_ext, void* p, void* y, const Terms& tl,
                      const Terms& tu, long long npad, long long block,
                      long long np_true, long long base, int hpad_ext,
                      int h_l, int halo, int tile, cudaStream_t stream) {
  if (tile <= 0 || block % tile != 0 || halo < 0 || h_l < 0 ||
      h_l + halo > block || (c != nullptr && c2 == nullptr))
    return kBadArgs;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(2 * tile + 4 * halo + 2 * h_l);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        const_series_msolve_fma_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (npad + 2 * block) / tile;
  const_series_msolve_fma_kernel<T><<<static_cast<unsigned>(grid), kThreads,
                                      smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(c1),
      static_cast<const T*>(c2), static_cast<const T*>(inv_d),
      static_cast<const T*>(gap_ext), static_cast<T*>(p), static_cast<T*>(y),
      tl, tu, npad, block, np_true, base, hpad_ext, h_l, halo, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.
int cmt_const_stencil_spmv(int dtype, const void* x, const void* gap, void* y,
                           const long long* off, const double* c, int nterms,
                           long long npad, long long block, long long np_true,
                           long long base, void* stream) {
  Terms t;
  if (!fill_terms(&t, off, c, nterms) || block <= 0) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_spmv<float>(x, gap, y, t, npad, block, np_true, base, s);
  if (dtype == 1)
    return launch_spmv<double>(x, gap, y, t, npad, block, np_true, base, s);
  return kBadArgs;
}

int cmt_const_series_msolve(int dtype, const void* x, const void* inv_d,
                            const void* gap_ext, void* y,
                            const long long* off_l, const double* c_l,
                            int nterms_l, const long long* off_u,
                            const double* c_u, int nterms_u, long long npad,
                            long long block, long long np_true, long long base,
                            int hpad_ext, int halo, int tile, void* stream) {
  Terms tl, tu;
  if (!fill_terms(&tl, off_l, c_l, nterms_l) ||
      !fill_terms(&tu, off_u, c_u, nterms_u) || block <= 0)
    return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_msolve<float>(x, inv_d, gap_ext, y, tl, tu, npad, block,
                                np_true, base, hpad_ext, halo, tile, s);
  if (dtype == 1)
    return launch_msolve<double>(x, inv_d, gap_ext, y, tl, tu, npad, block,
                                 np_true, base, hpad_ext, halo, tile, s);
  return kBadArgs;
}

// w may be null (no weight); partials is (grid, (w != null) + with_self).
int cmt_const_stencil_spmv_dots(int dtype, const void* x, const void* gap,
                                const void* w, void* y, void* partials,
                                const long long* off, const double* c,
                                int nterms, long long npad, long long block,
                                long long np_true, long long base,
                                int with_self, void* stream) {
  Terms t;
  if (!fill_terms(&t, off, c, nterms) || block <= 0) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_spmv_dots<float>(x, gap, w, y, partials, t, npad, block,
                                   np_true, base, with_self, s);
  if (dtype == 1)
    return launch_spmv_dots<double>(x, gap, w, y, partials, t, npad, block,
                                    np_true, base, with_self, s);
  return kBadArgs;
}

// c (and with it c2) null: the two-stream form p = a + c1 * b.
int cmt_const_series_msolve_fma(
    int dtype, const void* a, const void* b, const void* c, const void* c1,
    const void* c2, const void* inv_d, const void* gap_ext, void* p, void* y,
    const long long* off_l, const double* c_l, int nterms_l,
    const long long* off_u, const double* c_u, int nterms_u, long long npad,
    long long block, long long np_true, long long base, int hpad_ext,
    int h_l, int halo, int tile, void* stream) {
  Terms tl, tu;
  if (!fill_terms(&tl, off_l, c_l, nterms_l) ||
      !fill_terms(&tu, off_u, c_u, nterms_u) || block <= 0)
    return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_msolve_fma<float>(a, b, c, c1, c2, inv_d, gap_ext, p, y, tl,
                                    tu, npad, block, np_true, base, hpad_ext,
                                    h_l, halo, tile, s);
  if (dtype == 1)
    return launch_msolve_fma<double>(a, b, c, c1, c2, inv_d, gap_ext, p, y,
                                     tl, tu, npad, block, np_true, base,
                                     hpad_ext, h_l, halo, tile, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
