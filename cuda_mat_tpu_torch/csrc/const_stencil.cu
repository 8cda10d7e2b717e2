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

#include <cstdint>

#include "tma_ring.cuh"

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

using cmt::add_rn;
using cmt::mul_rn;

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
//   0 in the pad blocks and for rows q >= lim (lim = np_true - base, the
//   shard's tail, clipped to [0, npad]).
// Bound by device memory: x read once and y written once (8 bytes per
// element in f32, 16 in f64; the gap mask, one block long, stays in L2).
// On Hopper the parent design (one thread per element, 64-bit indices and a
// 64-bit modulo per element, 4-byte accesses, every neighbour re-read
// through L1/L2) reached 30-40% of that bound.  What this design does:
//   * x is streamed once.  Each of `ctas` persistent thread blocks (up to
//     four per SM) owns one contiguous run of tiles (`tile` elements, a
//     power of two dividing block, 4-8 KB) and pulls its run, plus `halo`
//     tiles on each side, through a ring of `stages` tiles in shared
//     memory: one TMA bulk copy per tile, completing on the tile's
//     mbarrier, issued `stages - 2 halo - 1` tiles ahead of the computed
//     one.  Even blocks walk their run forward and odd ones backward, so
//     the halo tiles two neighbours share are loaded by both at about the
//     same time and the second load hits L2.  A term whose offset reaches
//     past the ring's halo (|off| > halo * tile: only where the ring would
//     not fit shared memory) reads x from device memory.
//   * Shared-memory reads without bank conflicts: thread t computes
//     elements t + 256u (u < P) of a tile; the tile at element T * tile
//     sits in slot T % stages, so a read is one add and a wrap.
//   * 16-byte stores: a computed tile goes to one of two staging tiles in
//     shared memory and from there to y as whole 16-byte words; the pad
//     blocks are written as zero words without reading x.
//   * 32-bit indices (the wrapper refuses npad + 2 block >= 2^31), one
//     modulo per tile (a tile never straddles a layout block, so gap's
//     index is (start - block) % block plus the element's place in the
//     tile), and terms as 32-bit offsets with coefficients already in T
//     (rounded on the host, as the twin rounds them), held in shared memory
//     and read a term ahead.
// The terms are summed in their order, every product and sum rounded on its
// own, so y equals the twin's bit for bit.
constexpr int kStreamThreads = 256;

template <typename T>
struct TermsT {
  int n;
  int off[kMaxTerms];
  T c[kMaxTerms];
};

// P = tile / kStreamThreads elements per thread, a compile-time constant so
// that each term's P reads issue back to back.
template <typename T, int P>
__global__ void __launch_bounds__(kStreamThreads, 4)
const_stencil_spmv_kernel(const T* __restrict__ x, const T* __restrict__ gap,
                          T* __restrict__ y,
                          const __grid_constant__ TermsT<T> t, int npad,
                          int block, int lim, int halo, int stages) {
  using V = typename cmt::Vec16<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTile = P * kStreamThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the terms, one past the last read ahead of its use
  __shared__ int s_off[kMaxTerms + 1];
  __shared__ T s_c[kMaxTerms + 1];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* staged = ring + stages * kTile;   // two tiles of output
  std::uint64_t* bars =
      reinterpret_cast<std::uint64_t*>(staged + 2 * kTile);
  const int tid = threadIdx.x;
  const int n = t.n;
  if (tid <= n) {
    s_off[tid] = tid < n ? t.off[tid] : 0;
    s_c[tid] = tid < n ? t.c[tid] : T(0);
  }

  // this block's tiles [t0, t1) of the npad / kTile inner tiles, and the
  // halo tiles beside them: nst tiles, loaded in order from the first (even
  // blocks) or from the last (odd blocks), so that two neighbouring blocks
  // load the tiles they share at about the same time and the second load
  // finds them in L2.  The tile at element T * kTile lives in slot
  // T % stages of the ring.
  const int ntiles = npad / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  ntiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  ntiles / gridDim.x);
  const int nst = t1 - t0 + 2 * halo;
  const int dir = blockIdx.x & 1 ? -1 : 1;
  const int anchor = dir > 0 ? block / kTile + t0 - halo
                             : block / kTile + t1 - 1 + halo;
  constexpr unsigned kBytes = kTile * sizeof(T);
  auto issue = [&](int k) {   // load k: the tile anchor + dir * k
    const int tk = anchor + dir * k;
    const int s = tk % stages;
    cmt::mbar_expect(bars + s, kBytes);
    cmt::bulk_copy(ring + s * kTile, x + tk * kTile, kBytes, bars + s);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) cmt::mbar_init(bars + s);
    cmt::mbar_fence_init();
    for (int k = 0; k < min(stages, nst); ++k) issue(k);
  }

  // the pad blocks, while the first stages load: zero words, x unread
  const int pv = block / kVec;
  V* yv = reinterpret_cast<V*>(y);
  for (int v = blockIdx.x * kStreamThreads + tid; v < 2 * pv;
       v += gridDim.x * kStreamThreads)
    yv[v < pv ? v : v + npad / kVec] = cmt::zero16<T>();
  __syncthreads();   // the barriers and the terms are ready

  const int ring_len = stages * kTile;
  const int reach = halo * kTile;
  int ready = 0;   // loads this thread has seen complete
  for (int k = 0; k < t1 - t0; ++k) {
    const int tc = anchor + dir * (halo + k);   // the computed tile
    const int start = tc * kTile;
    const int q0 = start - block;
    const int m0 = q0 % block;
    T g[P];
#pragma unroll
    for (int u = 0; u < P; ++u)
      g[u] = __ldg(gap + m0 + tid + u * kStreamThreads);
    for (; ready <= k + 2 * halo; ++ready)
      cmt::mbar_wait(bars + (anchor + dir * ready) % stages,
                     (ready / stages) & 1);
    const int base = tc % stages * kTile + tid;   // element tid in the ring
    // term j's P products: x from the ring (or, past it, device memory)
    auto term = [&](int off, T c, T (&v)[P]) {
      if (off <= reach && off >= -reach) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          int i = base + u * kStreamThreads + off;
          i += i < 0 ? ring_len : 0;
          i -= i >= ring_len ? ring_len : 0;
          v[u] = mul_rn(c, ring[i]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < P; ++u)
          v[u] = mul_rn(c, __ldg(x + start + tid + u * kStreamThreads + off));
      }
    };
    T acc[P];
    term(s_off[0], s_c[0], acc);
    int off = s_off[1];
    T c = s_c[1];
    for (int j = 1; j < n; ++j) {
      const int off_next = s_off[j + 1];
      const T c_next = s_c[j + 1];
      T v[P];
      term(off, c, v);
#pragma unroll
      for (int u = 0; u < P; ++u) acc[u] = add_rn(acc[u], v[u]);
      off = off_next;
      c = c_next;
    }
    T* out = staged + (k & 1) * kTile;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int e = tid + u * kStreamThreads;
      out[e] = q0 + e < lim ? mul_rn(acc[u], g[u]) : T(0);
    }
    // every read of load k (the tile farthest behind) and every write of
    // `out` done: load k's slot takes load k + stages, `out` goes to y
    __syncthreads();
    if (tid == 0 && k + stages < nst) issue(k + stages);
    const V* ov = reinterpret_cast<const V*>(out);
    V* dst = reinterpret_cast<V*>(y + start);
#pragma unroll
    for (int u = 0; u < kTile / kVec / kStreamThreads; ++u)
      dst[tid + u * kStreamThreads] = ov[tid + u * kStreamThreads];
  }
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

// Raise the block's dynamic shared-memory limit to `bytes` once per kernel.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <typename T, int P>
int launch_spmv_p(const void* x, const void* gap, void* y,
                  const TermsT<T>& t, int npad, int block, int lim, int halo,
                  int stages, int ctas, cudaStream_t stream) {
  static size_t allowed = 0;
  constexpr int kTile = P * kStreamThreads;
  const size_t smem = sizeof(T) * static_cast<size_t>(stages + 2) * kTile +
                      sizeof(std::uint64_t) * stages;
  cudaError_t err =
      allow_smem(const_stencil_spmv_kernel<T, P>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const_stencil_spmv_kernel<T, P><<<ctas, kStreamThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gap),
      static_cast<T*>(y), t, npad, block, lim, halo, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmv(const void* x, const void* gap, void* y, const TermsT<T>& t,
                int npad, int block, int lim, int log_tile, int halo,
                int stages, int ctas, cudaStream_t stream) {
  if (log_tile < 9 || log_tile > 11 || stages > 256) return kBadArgs;
  const int tile = 1 << log_tile;
  if (tile * static_cast<int>(sizeof(T)) < 16 * kStreamThreads ||
      block % tile != 0 || npad % tile != 0 || halo < 0 ||
      2 * halo + 2 > stages ||
      static_cast<long long>(halo) * tile > block || ctas < 1 ||
      ctas > npad / tile)
    return kBadArgs;
  for (int k = 0; k < t.n; ++k)
    if (t.off[k] > block || t.off[k] < -block) return kBadArgs;
  switch (log_tile) {
    case 9:
      return launch_spmv_p<T, 2>(x, gap, y, t, npad, block, lim, halo,
                                 stages, ctas, stream);
    case 10:
      return launch_spmv_p<T, 4>(x, gap, y, t, npad, block, lim, halo,
                                 stages, ctas, stream);
    default:
      return launch_spmv_p<T, 8>(x, gap, y, t, npad, block, lim, halo,
                                 stages, ctas, stream);
  }
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

template <typename T>
int spmv_entry(const void* x, const void* gap, void* y, const int* off,
               const void* c, int nterms, int npad, int block, int lim,
               int log_tile, int halo, int stages, int ctas,
               cudaStream_t s) {
  if (nterms < 1 || nterms > kMaxTerms || block <= 0 || lim < 0 ||
      lim > npad)
    return kBadArgs;
  TermsT<T> t;
  t.n = nterms;
  for (int k = 0; k < nterms; ++k) {
    t.off[k] = off[k];
    t.c[k] = static_cast<const T*>(c)[k];
  }
  return launch_spmv<T>(x, gap, y, t, npad, block, lim, log_tile, halo,
                        stages, ctas, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  B1: `c` holds the nterms coefficients
// in that dtype; the geometry (tile = 2^log_tile, halo, ring stages, ctas)
// is the wrapper's (ops/_kernels.py: spmv_plan).
int cmt_const_stencil_spmv(int dtype, const void* x, const void* gap, void* y,
                           const int* off, const void* c, int nterms,
                           int npad, int block, int lim, int log_tile,
                           int halo, int stages, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return spmv_entry<float>(x, gap, y, off, c, nterms, npad, block, lim,
                             log_tile, halo, stages, ctas, s);
  if (dtype == 1)
    return spmv_entry<double>(x, gap, y, off, c, nterms, npad, block, lim,
                              log_tile, halo, stages, ctas, s);
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
