// Hopper (sm_90a) kernels of the exact banded ILU(0) triangular solves.
//
// One sweep over nb row blocks of B rows is the blocked recurrence
//   y_b = f_b . Wt[b] - y_{b-1} . WCt[b]      (row vector times B x B)
// (forward over b = 0..nb-1 for the unit-lower factor, backward over
// b = nb-1..0 for the upper one, y_{-1} = y_{nb} = 0).  Wt and WCt are the
// host-made arrays of ops/banded_trisolve.py, (nb, B, B) row-major, so
// y[j] = sum_k f[k] * Wt[b][k][j]: thread j reading Wt[b][k][j] over k
// walks rows, and a warp's 32 consecutive j read one contiguous segment.
//
// The TPU kernels (cuda_mat_tpu/ops/pallas_trisolve.py:46, :110) carry
// y_{b-1} from one sequential grid step to the next.  Hopper blocks run in
// no order, so each sweep is split where the recurrence allows it:
//   (a) banded_gemv_kernel: g_b = f_b . Wt[b] for all b at once, one thread
//       block per row block, over the whole card;
//   (b) banded_chain_kernel: y_b = g_b - y_{b-1} . WCt[b], walked by ONE
//       thread block in order, y_{b-1} in shared memory, in place over g.
// These are the TPU kernel's two products and its subtraction; only the
// order of the sums differs (each thread sums a slice of k with FMAs, the
// slices are added in a fixed order), so a kernel and its plain twin agree
// to rounding, deterministically, not bit for bit.
//
// Bound: device memory.  A sweep must read its two (nb, B, B) arrays once
// (f32, B=128, 1M rows: 1.02 GB); the arithmetic is 2 flops per 4 or 8
// bytes.  (a) streams Wt at the card's rate.  (b) is a chain of nb
// dependent steps on one SM: it streams WCt at what one SM can pull, with
// the next step's slice of WCt and of g loaded into registers while the
// current step runs, and is the slow part (nb x the step latency).  Only
// the last `bandwidth` rows of each WCt[b] are nonzero; skipping the rest,
// and a chain spread over many SMs, are left for later work.
//
// B4a, the fused msolve U \ (L \ f), is the forward sweep then the backward
// one, two calls of cmt_banded_sweep on one stream made by its front end
// (ops/banded_trisolve.py; the backward (a) needs all of y).  The TPU fused
// them into one launch to save its per-launch overhead and to keep y on
// chip; here y lives in device memory.
//
// Launchers are extern "C" for ctypes: they launch on the caller's stream,
// never synchronise, allocate nothing, and return the first
// cudaGetLastError() (or kBadArgs for arguments the kernels do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kBadArgs = -1;
constexpr int kMaxBlock = 1024;   // one thread per column j
constexpr int kGemvThreads = 256;
constexpr int kChainThreads = 1024;
constexpr int kPrefetchBytes = 64;  // WCt bytes per thread loaded a step ahead

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Thread t of a kernel works on column j = t % B over the row slice
// [k0, k1) of its group t / B; the groups' partial sums meet in shared
// memory and are added in group order.
struct Slice {
  int j, grp, k0, k1;
};

__device__ __forceinline__ Slice slice_of(int B, int groups) {
  const int per = (B + groups - 1) / groups;
  Slice s;
  s.j = threadIdx.x % B;
  s.grp = threadIdx.x / B;
  s.k0 = min(B, s.grp * per);
  s.k1 = min(B, s.k0 + per);
  return s;
}

// Threads groups * B of a kernel: as many groups as fit `threads`, at
// least one, at most B.
int groups_for(int B, int threads) {
  const int g = threads / B;
  return g < 1 ? 1 : (g > B ? B : g);
}

// (a) g[b*B + j] = sum_k f[b*B + k] * Wt[b][k][j]; one thread block per b,
// groups * B threads.  Shared memory: f_b, then groups x B partial sums.
template <typename T>
__global__ void banded_gemv_kernel(const T* __restrict__ f,
                                   const T* __restrict__ wt,
                                   T* __restrict__ g, int B, int groups) {
  extern __shared__ unsigned char smem_raw[];
  T* fs = reinterpret_cast<T*>(smem_raw);
  T* red = fs + B;
  const long long b = blockIdx.x;
  for (int k = threadIdx.x; k < B; k += blockDim.x) fs[k] = f[b * B + k];
  __syncthreads();
  const Slice s = slice_of(B, groups);
  const T* m = wt + b * B * B + s.j;
  T acc = T(0);
#pragma unroll 8
  for (int k = s.k0; k < s.k1; ++k)
    acc = fma_t(fs[k], m[static_cast<long long>(k) * B], acc);
  red[s.grp * B + s.j] = acc;
  __syncthreads();
  if (s.grp == 0) {
    T sum = red[s.j];
    for (int q = 1; q < groups; ++q) sum += red[q * B + s.j];
    g[b * B + s.j] = sum;
  }
}

// (b) in place over y (holding g on entry): for s = 0..nb-1 in sweep order,
// y_b = g_b - y_{b-1} . WCt[b].  One thread block of groups * B threads.
// Shared memory: prev = y_{b-1}, then groups x B partial sums.  The first
// P values of each thread's WCt slice (64 bytes, so that both register
// copies fit a full block's register budget) and its entry of g are loaded
// one step ahead.
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
banded_chain_kernel(const T* __restrict__ wct, T* __restrict__ y,
                    long long nb, int B, int groups, int forward) {
  constexpr int P = kPrefetchBytes / static_cast<int>(sizeof(T));
  extern __shared__ unsigned char smem_raw[];
  T* prev = reinterpret_cast<T*>(smem_raw);
  T* red = prev + B;
  const Slice sl = slice_of(B, groups);
  const int npre = min(sl.k1 - sl.k0, P);
  const long long bb = static_cast<long long>(B) * B;
  for (int k = threadIdx.x; k < B; k += blockDim.x) prev[k] = T(0);

  T nxt[P];
  T g_nxt = T(0);
  {
    const long long b0 = forward ? 0 : nb - 1;
    const T* m = wct + b0 * bb + static_cast<long long>(sl.k0) * B + sl.j;
#pragma unroll
    for (int i = 0; i < P; ++i)
      nxt[i] = i < npre ? m[static_cast<long long>(i) * B] : T(0);
    if (sl.grp == 0) g_nxt = y[b0 * B + sl.j];
  }
  __syncthreads();

  for (long long s = 0; s < nb; ++s) {
    const long long b = forward ? s : nb - 1 - s;
    T cur[P];
#pragma unroll
    for (int i = 0; i < P; ++i) cur[i] = nxt[i];
    const T g_cur = g_nxt;
    if (s + 1 < nb) {
      const long long bn = forward ? s + 1 : nb - 2 - s;
      const T* m = wct + bn * bb + static_cast<long long>(sl.k0) * B + sl.j;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (i < npre) nxt[i] = m[static_cast<long long>(i) * B];
      if (sl.grp == 0) g_nxt = y[bn * B + sl.j];
    }
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < npre) acc = fma_t(prev[sl.k0 + i], cur[i], acc);
    const T* m = wct + b * bb + sl.j;
    for (int k = sl.k0 + npre; k < sl.k1; ++k)
      acc = fma_t(prev[k], m[static_cast<long long>(k) * B], acc);
    red[sl.grp * B + sl.j] = acc;
    __syncthreads();   // all reads of prev done, all partials written
    if (sl.grp == 0) {
      T sum = red[sl.j];
      for (int q = 1; q < groups; ++q) sum += red[q * B + sl.j];
      const T out = g_cur - sum;
      y[b * B + sl.j] = out;
      prev[sl.j] = out;
    }
    __syncthreads();   // prev holds y_b; red may be overwritten
  }
}

// One sweep: f -> y (y must not alias f).
template <typename T>
int launch_sweep(const T* f, const T* wt, const T* wct, T* y, long long nb,
                 int B, bool forward, cudaStream_t stream) {
  const int gg = groups_for(B, kGemvThreads);
  banded_gemv_kernel<T><<<static_cast<unsigned>(nb), gg * B,
                          sizeof(T) * B * (1 + gg), stream>>>(f, wt, y, B,
                                                              gg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cg = groups_for(B, kChainThreads);
  banded_chain_kernel<T><<<1, cg * B, sizeof(T) * B * (1 + cg), stream>>>(
      wct, y, nb, B, cg, forward ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long nb, int B) {
  return nb < 1 || nb > 0x7fffffffLL || B < 1 || B > kMaxBlock;
}

}  // namespace

extern "C" {

// B4b. Replaces _banded_sweep / _sweep_kernel (pallas_trisolve.py:73, :46);
// twice, B4a (_fused_msolve / _fused_kernel, :149, :110).
// dtype: 0 = float32, 1 = float64.
int cmt_banded_sweep(int dtype, const void* f, const void* wt,
                     const void* wct, void* y, long long nb, int block,
                     int forward, void* stream) {
  if (bad_shape(nb, block)) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sweep<float>(static_cast<const float*>(f),
                               static_cast<const float*>(wt),
                               static_cast<const float*>(wct),
                               static_cast<float*>(y), nb, block,
                               forward != 0, s);
  if (dtype == 1)
    return launch_sweep<double>(static_cast<const double*>(f),
                                static_cast<const double*>(wt),
                                static_cast<const double*>(wct),
                                static_cast<double*>(y), nb, block,
                                forward != 0, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
