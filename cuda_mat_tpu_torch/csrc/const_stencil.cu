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

#include <algorithm>
#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kMaxTerms = 64;
constexpr int kBadArgs = -1;
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block

using cmt::add_rn;
using cmt::mul_rn;

// B1. Replaces const_stencil_spmv_padded / _const_stencil_kernel
// (cuda_mat_tpu/ops/pallas_stencil.py:306, :262):
//   y[j] = gap(q) * sum_k c_k x[j + off_k]   for strided row q = j - block,
//   0 in the pad blocks and for rows q >= lim (lim = np_true - base, the
//   shard's tail, clipped to [0, npad]).
// One launch takes a batch of S such vectors (the row shards a process
// holds), each npad + 2 block long and stored one after another: shard i
// is an instance of its own, on grid row blockIdx.y = i, with its base
// base + i npad.
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

// B6. Replaces const_stencil_spmv_dots_padded / _const_stencil_dots_kernel
// (pallas_stencil.py:416, :353): B1's y, and the dots <w, y> (w given) and,
// with `with_self`, <y, y>, for the solver loop's fused_dots.  Bound by
// device memory: x and w read once, y written once (12 bytes a row in f32).
//   * B6 is B1's streaming kernel (spmv_body below, one body for both) with
//     an epilogue on each computed tile.  The weight is read only at the
//     computed tile, by 16-byte loads issued before the tile's stencil sum,
//     into registers: a TMA copy beside x's tile would have needed a ring
//     of w tiles in shared memory, fewer blocks an SM at the flagship.
//   * Partials that do not depend on the machine: one per kDotRows = 256
//     rows of y (DOTS_BLOCK), the products of those rows summed by a fixed
//     halving tree (row r += row r + h, h = 128, ..., 1), the pad blocks'
//     partials 0.  One warp takes a 256-row chunk of the staged y tile:
//     lane l reads its chunk's 16-byte words l + 32 j (j < 8 / vec), stores
//     them to y and forms their products, so the tree's levels 128 .. 32 vec
//     are in its registers, 16 vec .. vec are shuffles, and the rest inside
//     a word.  No block barrier and no shared memory beyond B1's.  Whether
//     <y, y> is taken is a template flag (Self), so a launch without it
//     forms no y·y products and holds no second tree in registers.
//   * The cross-block sum in the same launch: each block takes a ticket
//     (atomicAdd on a counter that stays 0 between launches, one for each
//     stream that launches B6, so that no two running launches share it;
//     the partials are the launch's own memory) after its
//     partials are written and fenced; the last block sums the partials in
//     a fixed order (thread t: rows t, t + 256, ... one after another, then
//     the 256-thread halving tree), writes the dots and resets the counter.
// Every product and sum is rounded on its own, so y, the partials and the
// dots equal the plain twin (ops/stencil.py) bit for bit.
constexpr int kDotRows = 256;

template <typename T>
struct DotsArgs {
  const T* w;        // the weight vector, or null
  T* partials;       // nd partials per kDotRows rows of y, row after row
  T* dots;           // the nd sums
  unsigned* ticket;  // blocks done with their partials; 0 between launches
  int with_self;     // <y, y> too (after <w, y> where w is given): the
                     // kernel's Self
};

// The halving tree of one 256-row chunk, held by one warp: lane l holds the
// rows of the chunk's 16-byte words l + 32 j (s[j][q]: row 4 (l + 32 j) + q
// in f32).  Returns the chunk's sum on lane 0; every lane must call it.
template <typename T, int J, int Vn>
__device__ __forceinline__ T chunk_tree(T (&s)[J][Vn]) {
#pragma unroll
  for (int h = J / 2; h >= 1; h /= 2)   // rows 128 .. 32 Vn apart
#pragma unroll
    for (int j = 0; j < h; ++j)
#pragma unroll
      for (int q = 0; q < Vn; ++q) s[j][q] = add_rn(s[j][q], s[j + h][q]);
#pragma unroll
  for (int h = 16; h >= 1; h /= 2)      // rows 16 Vn .. Vn apart
#pragma unroll
    for (int q = 0; q < Vn; ++q)
      s[0][q] = add_rn(s[0][q], __shfl_down_sync(0xffffffffu, s[0][q], h));
#pragma unroll
  for (int h = Vn / 2; h >= 1; h /= 2)  // rows Vn / 2 .. 1 apart
#pragma unroll
    for (int q = 0; q < h; ++q) s[0][q] = add_rn(s[0][q], s[0][q + h]);
  return s[0][0];
}

// B1's body, and with Dots B6's (with Self, <y, y> among its dots): P =
// tile / kStreamThreads elements per thread, a compile-time constant so that
// each term's P reads issue back to back.  `da` is B6's (null for B1).
template <typename T, int P, bool Dots, bool Self = false>
__device__ __forceinline__ void spmv_body(
    const T* __restrict__ x, const T* __restrict__ gap, T* __restrict__ y,
    const TermsT<T>& t, int npad, int block, int lim, int halo, int stages,
    const DotsArgs<T>* da) {
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
  // B6: a chunk's words, the words a lane holds of it, the dots; the pad
  // blocks' partials are 0 (y is 0 there)
  constexpr int kChunkWords = kDotRows / kVec;
  constexpr int kJ = kChunkWords / 32;
  const int warp = tid / 32, lane = tid % 32;
  int nd = 0;
  if constexpr (Dots) {
    nd = (da->w != nullptr) + Self;
    const int pc = block / kDotRows;
    for (int c = blockIdx.x * kStreamThreads + tid; c < 2 * pc;
         c += gridDim.x * kStreamThreads)
      for (int d = 0; d < nd; ++d)
        da->partials[(c < pc ? c : c + npad / kDotRows) * nd + d] = T(0);
  }
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
    // B6: the weight's words of this warp's chunk (chunk `warp` of the tile)
    V wk[kJ];
    if constexpr (Dots) {
      if (warp < P && da->w != nullptr) {
        const V* wt = reinterpret_cast<const V*>(da->w + start) +
                      warp * kChunkWords + lane;
#pragma unroll
        for (int j = 0; j < kJ; ++j) wk[j] = __ldg(wt + 32 * j);
      }
    }
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
    if constexpr (!Dots) {
#pragma unroll
      for (int u = 0; u < kTile / kVec / kStreamThreads; ++u)
        dst[tid + u * kStreamThreads] = ov[tid + u * kStreamThreads];
    } else if (warp < P) {
      // chunk `warp` of the tile: its words to y, its products, its
      // partials (the tree in chunk_tree)
      const int w0 = warp * kChunkWords + lane;
      T s[2][kJ][kVec];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const V yw = ov[w0 + 32 * j];
        dst[w0 + 32 * j] = yw;
        const T* ye = reinterpret_cast<const T*>(&yw);
        const T* we = reinterpret_cast<const T*>(&wk[j]);
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          if constexpr (Self) {   // <w, y> first where w is given
            const T yy = mul_rn(ye[q], ye[q]);
            s[0][j][q] = da->w != nullptr ? mul_rn(we[q], ye[q]) : yy;
            s[1][j][q] = yy;
          } else {                // the launcher requires w
            s[0][j][q] = mul_rn(we[q], ye[q]);
          }
        }
      }
      T* row = da->partials + (start / kDotRows + warp) * nd;
      const T p0 = chunk_tree<T, kJ, kVec>(s[0]);
      if (lane == 0) row[0] = p0;
      if (Self && nd > 1) {
        const T p1 = chunk_tree<T, kJ, kVec>(s[1]);
        if (lane == 0) row[1] = p1;
      }
    }
  }
  if constexpr (Dots) {
    // each block's partials written and visible before it takes a ticket;
    // the last block sums them all
    __shared__ unsigned s_last;
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(da->ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // thread tid: rows tid, tid + 256, ... in order, kB rows in flight
    const int rows = (npad + 2 * block) / kDotRows;
    const T* pt = da->partials;
    T acc[2] = {T(0), T(0)};
    if (tid < rows)
#pragma unroll
      for (int d = 0; d < 2; ++d)
        if (d < nd) acc[d] = __ldcg(pt + tid * nd + d);
    constexpr int kB = 64 / sizeof(T);
    int r = tid + kStreamThreads;
    for (; r + (kB - 1) * kStreamThreads < rows; r += kB * kStreamThreads) {
      T v[kB][2];
#pragma unroll
      for (int i = 0; i < kB; ++i)
#pragma unroll
        for (int d = 0; d < 2; ++d)
          if (d < nd) v[i][d] = __ldcg(pt + (r + i * kStreamThreads) * nd + d);
#pragma unroll
      for (int i = 0; i < kB; ++i)
#pragma unroll
        for (int d = 0; d < 2; ++d)
          if (d < nd) acc[d] = add_rn(acc[d], v[i][d]);
    }
    for (; r < rows; r += kStreamThreads)
#pragma unroll
      for (int d = 0; d < 2; ++d)
        if (d < nd) acc[d] = add_rn(acc[d], __ldcg(pt + r * nd + d));
    // the 256 sums by the halving tree (h = 128, 64, 32 through shared
    // memory, the ring's first rows: every load of it has completed)
    T* red = ring;
#pragma unroll
    for (int d = 0; d < 2; ++d)
      if (d < nd) red[d * kStreamThreads + tid] = acc[d];
    __syncthreads();
    for (int h = kStreamThreads / 2; h >= 32; h /= 2) {
      if (tid < h)
        for (int d = 0; d < nd; ++d) {
          T* e = red + d * kStreamThreads + tid;
          *e = add_rn(*e, e[h]);
        }
      __syncthreads();
    }
    if (warp == 0) {
      for (int d = 0; d < nd; ++d) {
        T v = red[d * kStreamThreads + lane];
#pragma unroll
        for (int h = 16; h >= 1; h /= 2)
          v = add_rn(v, __shfl_down_sync(0xffffffffu, v, h));
        if (lane == 0) da->dots[d] = v;
      }
      if (lane == 0) *da->ticket = 0;
    }
  }
}

// Shard blockIdx.y's tail: lim0 - blockIdx.y npad (lim0 = np_true - base,
// shard 0's), clipped to [0, npad].
__device__ __forceinline__ int shard_lim(long long lim0, int npad) {
  const long long l = lim0 - static_cast<long long>(blockIdx.y) * npad;
  return static_cast<int>(l < 0 ? 0 : l > npad ? npad : l);
}

template <typename T, int P>
__global__ void __launch_bounds__(kStreamThreads, 4)
const_stencil_spmv_kernel(const T* __restrict__ x, const T* __restrict__ gap,
                          T* __restrict__ y,
                          const __grid_constant__ TermsT<T> t, int npad,
                          int block, long long lim0, int halo, int stages) {
  const long long at = static_cast<long long>(blockIdx.y) * (npad + 2 * block);
  spmv_body<T, P, false>(x + at, gap, y + at, t, npad, block,
                         shard_lim(lim0, npad), halo, stages, nullptr);
}

template <typename T, int P, bool Self>
__global__ void __launch_bounds__(kStreamThreads, 4)
const_stencil_spmv_dots_kernel(const T* __restrict__ x,
                               const T* __restrict__ gap, T* __restrict__ y,
                               const __grid_constant__ TermsT<T> t, int npad,
                               int block, int lim, int halo, int stages,
                               const __grid_constant__ DotsArgs<T> da) {
  spmv_body<T, P, true, Self>(x, gap, y, t, npad, block, lim, halo, stages,
                              &da);
}

// B2 and B5, one kernel.  B2 replaces const_series_msolve_padded /
// _const_msolve_kernel + _msolve_series_interior (pallas_stencil.py:624,
// :524, :474), the fused Neumann-series M-solve
//   u = (P_l x) * gap * inv_d,  0 where the global row base + q lies outside
//                               [0, np_true),
//   y = (P_u u) * gap,          0 in the pad blocks and for rows q >= lim
// (lim = np_true - base, the shard's tail, clipped to [0, npad]).  u is
// taken over the whole window P_u reads, pad blocks included: on a shard
// whose base is past 0, the rows before its first and after its last are
// the neighbours' rows, whose x (the halos) and inv_d sit in the pad
// blocks, as in the JAX kernel's u mask (pallas_stencil.py:495-503).  As
// B1, one launch takes a batch of S vectors, shard i on grid row
// blockIdx.y = i with its base base + i npad.  B5
// replaces const_series_msolve_fma_padded / _const_msolve_fma_kernel (:681,
// :554): the same series on p, with the solver's BLAS1 update folded in
// ahead of it,
//   p = a + c1 * (b + c2 * c)   (c given)   or   p = a + c1 * b,
// and p returned too; c1 and c2 are read from device memory (0-d tensors of
// the loop), so the host never waits for them.  B2 is the case p = x.
// Bound by device memory: each input stream (x, or a, b and c) and inv_d
// read once, y (and p) written once: 12 bytes a row in f32 for B2, 20 and 24
// for B5's two and three streams.  u and p never go to device memory.  A
// design with one thread block per tile (~6,300 at the flagship) had to
// recompute u over the tile and its halo (1.375x the rows; B5 also p over
// 1.75x), and with 64-bit indices, a 64-bit modulo a row, double
// coefficients and 4-byte stores it reached 24% (B2) and 17% (B5) of the
// bound on an H100.  What this design does:
//   * Persistent thread blocks, each owning one run of tiles (`tile` rows, a
//     power of two dividing block).  Even blocks walk their run forward and
//     odd ones backward, so the tiles two neighbours both read come from L2.
//   * The input streams and inv_d come through a ring of `stages` stages in
//     shared memory, one TMA bulk copy per tile and stream, all of a stage
//     completing on the stage's mbarrier.  A step consumes one stage: it
//     forms the stage's p tile (B2: copies x) into the p ring, which keeps
//     the tiles P_l reads (`xlo` behind the u tile, `xhi` ahead) and the one
//     being formed, and it takes the inv_d tile of the u tile it computes.
//     A term of P_l that reaches past the p ring's halo (only where the ring
//     would not fit shared memory) reads device memory (B5 forms p there).
//   * u is computed once per run: each u tile once, ahead of the first y
//     tile that reads it, into a ring that keeps P_u's reach (`ulo` tiles
//     behind the y tile, `uhi` ahead).  A run adds ulo + uhi u tiles.
//   * Reads without a wrap: each ring also holds a copy of its first rows
//     after its end and of its last rows before its start (gp_*, gu_*: as
//     far as the terms reach), so a term's reads are one address plus a
//     constant.  Where those copies do not fit shared memory, the u ring
//     wraps each read instead (`wrap`).
//   * Thread t computes rows t + 256u (u < P) of a tile: conflict-free
//     shared-memory reads.  y goes out through a staging tile as 16-byte
//     words, p from the p ring; the pad blocks are written as zero words.
//   * 32-bit indices (the wrapper refuses npad + 2 block >= 2^31) and no
//     division in the loop: the ring and gap-mask positions move by one
//     tile a step (a tile never straddles a layout block).  Terms as 32-bit
//     offsets with coefficients already in T (rounded on the host, as the
//     twins round them), one shared-memory read a term, a term ahead.
//   * Lean mode (stages == 0), for layouts whose u ring leaves no room for
//     the rest: the inputs, inv_d and p come from device memory and y is
//     stored from registers; only u stays in shared memory.
// On an H100 a step is bound by its own instructions and shared-memory
// reads (20 term reads a row at the flagship), not by its loads: one or two
// stages time alike, and larger tiles run faster (tools/msolve_sweep.py).
// Every product and sum is rounded on its own, in the twins' order, so p
// and y equal the plain twins (ops/stencil.py) bit for bit.
template <typename T>
struct MsolveArgs {
  const T* a;        // x (B2) or a (B5)
  const T* b;        // B5 only
  const T* c;        // B5's third stream, or null
  const T* c1p;      // B5's scalars, on the device
  const T* c2p;
  const T* inv_d;
  const T* gap;      // gap[m], m in [0, block)
  T* p;              // B5's p, null for B2
  T* y;
  int npad, block;
  int base, np_true;  // shard 0's global row of q = 0, the true rows
  int nin;           // streams combined into p: 1 (B2's x), 2 or 3
  int stages;        // input ring stages; 0: lean mode
  int xlo, xhi;      // tiles of P_l's reach that the p ring holds
  int gp_lo, gp_hi;  // rows of P_l's reach read from the p ring
  int ulo, uhi;      // tiles of P_u's reach
  int ru;            // rows of the u ring
  int gu_lo, gu_hi;  // rows copied before and after the u ring
  int wrap;          // the u ring wraps each read (no copies)
  TermsT<T> tl, tu;
};

// A term in shared memory: one 8-byte (f32) or 16-byte (f64) read.
template <typename T>
struct alignas(2 * sizeof(T) > 8 ? 16 : 8) TermS {
  int off;
  T c;
};

// acc[u] = sum_j c_j v_j[u] in term order, v_j from read(off_j, v_j): the
// first product, then + each product, every one rounded on its own.  The
// terms are read a term ahead of their use (t[n] exists).
template <typename T, int P, class Read>
__device__ __forceinline__ void series(const TermS<T>* t, int n, Read read,
                                       T (&acc)[P]) {
  T v[P];
  TermS<T> cur = t[0];
  read(cur.off, v);
#pragma unroll
  for (int u = 0; u < P; ++u) acc[u] = mul_rn(cur.c, v[u]);
  TermS<T> next = t[1];
  for (int j = 1; j < n; ++j) {
    cur = next;
    next = t[j + 1];
    read(cur.off, v);
#pragma unroll
    for (int u = 0; u < P; ++u) acc[u] = add_rn(acc[u], mul_rn(cur.c, v[u]));
  }
}

// a mod m in [0, m), for m > 0 and any a
__device__ __forceinline__ int posmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// a + d wrapped into [0, m), for a in [0, m) and |d| <= m
__device__ __forceinline__ int wrap_add(int a, int d, int m) {
  a += d;
  return a < 0 ? a + m : a >= m ? a - m : a;
}

// P = tile / kStreamThreads rows a thread, a compile-time constant.
template <typename T, int P>
__global__ void __launch_bounds__(kStreamThreads, P >= 8 ? 2 : 4)
const_series_msolve_kernel(const __grid_constant__ MsolveArgs<T> k) {
  using V = typename cmt::Vec16<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTile = P * kStreamThreads;
  constexpr int kWords = kTile / kVec;   // 16-byte words of a tile
  constexpr int kPer = (kWords + kStreamThreads - 1) / kStreamThreads;
  constexpr unsigned kBytes = kTile * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // P_l's and P_u's terms, one past the last (read ahead of its use)
  __shared__ TermS<T> s_terms[2][kMaxTerms + 1];
  const int tid = threadIdx.x;
  // the arguments in registers, read once from parameter space; this
  // block's shard (blockIdx.y) starts `at` elements into each vector
  const int npad = k.npad, block = k.block, nin = k.nin;
  const int total = npad + 2 * block;
  const long long at = static_cast<long long>(blockIdx.y) * total;
  const T* __restrict__ xa = k.a + at;
  const T* __restrict__ xb = k.b == nullptr ? nullptr : k.b + at;
  const T* __restrict__ xc = k.c == nullptr ? nullptr : k.c + at;
  const T* __restrict__ inv_d = k.inv_d + at;
  const T* __restrict__ gap = k.gap;
  T* __restrict__ p_out = k.p == nullptr ? nullptr : k.p + at;
  T* __restrict__ y_out = k.y + at;
  // u is taken for rows q in [qlo, qhi) (global rows in [0, np_true)), y
  // for rows q < lim; all three clipped to the padded vector
  const long long bq = static_cast<long long>(k.base) +
                       static_cast<long long>(blockIdx.y) * npad;
  const int qlo = static_cast<int>(max(-bq, static_cast<long long>(-block)));
  const int qhi = static_cast<int>(
      min(max(k.np_true - bq, static_cast<long long>(-block)),
          static_cast<long long>(npad + block)));
  const int lim = min(max(qhi, 0), npad);
  const int stages = k.stages, xlo = k.xlo, xhi = k.xhi;
  const int gp_lo = k.gp_lo, gp_hi = k.gp_hi, ru = k.ru;
  const int gu_lo = k.gu_lo, gu_hi = k.gu_hi;
  const bool wrap = k.wrap != 0;
  const bool lean = stages == 0;
  const int ntl = k.tl.n, ntu = k.tu.n;
  bool near = true;   // this thread's P_l term reads the p ring
  if (tid <= kMaxTerms) {
    const int ol = tid < ntl ? k.tl.off[tid] : 0;
    s_terms[0][tid] = {ol, tid < ntl ? k.tl.c[tid] : T(0)};
    s_terms[1][tid] = {tid < ntu ? k.tu.off[tid] : 0,
                       tid < ntu ? k.tu.c[tid] : T(0)};
    near = !lean && ol >= -gp_lo && ol <= gp_hi;
  }
  const int nst = nin + 1;   // tiles of a stage: the streams, then inv_d
  const int rp = lean ? 0 : (xlo + xhi + 2) * kTile;   // p ring rows
  T* in = reinterpret_cast<T*>(smem_raw);
  T* pr = in + stages * nst * kTile + gp_lo;   // row 0 of the p ring
  T* ur = pr + rp + gp_hi + gu_lo;             // row 0 of the u ring
  T* staged = ur + ru + gu_hi;                 // a tile of y
  std::uint64_t* bars =
      reinterpret_cast<std::uint64_t*>(staged + (lean ? 0 : kTile));

  // This block's run: tiles [t0, t1) of the ntiles inner tiles.  In walk
  // order, y tile Y_w (w < t1 - t0) is tile first + dir w; u tile U_j is
  // first + dir (j - bu) and p tile X_m is first + dir (m - bu - bx), so Y_w
  // reads U_w .. U_{w+bu+au} and U_j reads X_j .. X_{j+E-1}.  Tile T holds
  // padded rows [T tile, (T + 1) tile).
  const int ntiles = npad / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  ntiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  ntiles / gridDim.x);
  const int dir = blockIdx.x & 1 ? -1 : 1;
  const int inner0 = block / kTile;   // the first inner tile
  const int inner1 = inner0 + ntiles;
  const int first = inner0 + (dir > 0 ? t0 : t1 - 1);
  const int bu = dir > 0 ? k.ulo : k.uhi;
  const int au = dir > 0 ? k.uhi : k.ulo;
  const int bx = dir > 0 ? xlo : xhi;
  const int E = xlo + xhi + 1;
  const int nu = t1 - t0 + bu + au;   // u tiles of the run
  const int nx = nu + E - 1;          // p tiles of the run
  // load m brings X_m's streams (m < nx) and U_{m-E}'s inv_d (m >= E);
  // step i consumes load i + E: it forms X_{i+E} and computes U_i
  const int nloads = nu + E;

  const T c1 = nin > 1 ? *k.c1p : T(0);
  const T c2 = nin > 2 ? *k.c2p : T(0);
  // p from the streams' values, in fma_combine's order (B2: x itself)
  auto combine = [&](T a, T b, T c) -> T {
    if (nin == 1) return a;
    if (nin == 2) return add_rn(a, mul_rn(c1, b));
    return add_rn(a, mul_rn(c1, add_rn(b, mul_rn(c2, c))));
  };
  auto p_at = [&](int r) -> T {   // p at padded row r, from device memory
    // (0 off the vector: only rows of u that no y row reads get there)
    if (r < 0 || r >= total) return T(0);
    if (nin == 1) return __ldg(xa + r);
    return combine(__ldg(xa + r), __ldg(xb + r),
                   nin > 2 ? __ldg(xc + r) : T(0));
  };
  auto issue = [&](int m) {
    const int s = m % stages;
    T* st = in + s * nst * kTile;
    const int tx = first + dir * (m - bu - bx);
    const int tu = first + dir * (m - E - bu);
    const bool has_x = m < nx && tx >= 0 && tx < inner1 + inner0;
    const bool has_d = m >= E && tu >= 0 && tu < inner1 + inner0;
    cmt::mbar_expect(bars + s, (has_x ? nin * kBytes : 0u) +
                                   (has_d ? kBytes : 0u));
    if (has_x) {
      cmt::bulk_copy(st, xa + tx * kTile, kBytes, bars + s);
      if (nin > 1) cmt::bulk_copy(st + kTile, xb + tx * kTile, kBytes, bars + s);
      if (nin > 2)
        cmt::bulk_copy(st + 2 * kTile, xc + tx * kTile, kBytes, bars + s);
    }
    if (has_d)
      cmt::bulk_copy(st + nin * kTile, inv_d + tu * kTile, kBytes, bars + s);
  };
  if (!lean && tid == 0) {
    for (int s = 0; s < stages; ++s) cmt::mbar_init(bars + s);
    cmt::mbar_fence_init();
    for (int m = 0; m < min(stages, nloads); ++m) issue(m);
  }

  // the pad blocks of y (and p), while the first stages load: zero words
  const int pv = block / kVec;
  V* yv = reinterpret_cast<V*>(y_out);
  V* pv_out = reinterpret_cast<V*>(p_out);
  for (int v = blockIdx.x * kStreamThreads + tid; v < 2 * pv;
       v += gridDim.x * kStreamThreads) {
    const int at = v < pv ? v : v + npad / kVec;
    yv[at] = cmt::zero16<T>();
    if (pv_out != nullptr) pv_out[at] = cmt::zero16<T>();
  }
  // the barriers and the terms ready; every P_l term in the p ring?
  near = __syncthreads_and(near);

  // Per-step positions, moved by one tile a step (no division in the
  // loop): the stage of the load consumed and its phase, the u tile's and
  // the y tile's rows in the u ring and in the layout block (gap), the u
  // tile's and the formed p tile's rows in the p ring.
  const int i0 = lean ? 0 : -E;
  const int step = dir * kTile;
  int slot = 0, phase = 0;   // load i + E = i0 + E = 0 (normal mode)
  int u_tile = first - dir * bu;   // U_0's, moved from step 0 on
  int u_ring = posmod(u_tile * kTile, ru);
  int u_gap = posmod(u_tile * kTile - block, block);
  int u_p = lean ? 0 : posmod(u_tile * kTile, rp);
  const int y0 = (first + dir * (i0 - bu - au)) * kTile;
  int y_ring = posmod(y0, ru);
  int y_gap = posmod(y0 - block, block);
  int x_p = lean ? 0 : posmod((first + dir * (i0 + E - bu - bx)) * kTile, rp);
  for (int i = i0; i < nu; ++i) {
    const int m = i + E;   // the load this step consumes
    const int w = i - bu - au;   // this step's y tile, Y_w (if w >= 0)
    const int yrow0 = (first + dir * w) * kTile;
    const int yq0 = yrow0 - block;
    // the y tile's gap mask, loaded ahead of the u tile's work
    T gy[P];
    if (w >= 0 && yq0 < lim) {
#pragma unroll
      for (int u = 0; u < P; ++u)
        gy[u] = __ldg(gap + y_gap + tid + u * kStreamThreads);
    }
    const T* st = in + slot * nst * kTile;
    if (!lean) cmt::mbar_wait(bars + slot, phase);
    if (i >= 0) {   // u tile U_i, from the p ring: its rows, then the copies
      const int row0 = u_tile * kTile;
      const int q0 = row0 - block;
      T uv[P];
      if (q0 < qhi && q0 + kTile > qlo) {
        T g[P], d[P];
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int e = tid + u * kStreamThreads;
          g[u] = __ldg(gap + u_gap + e);
          d[u] = lean ? __ldg(inv_d + row0 + e) : st[nin * kTile + e];
        }
        const T* pb = pr + u_p + tid;
        T acc[P];
        if (near) {
          series<T, P>(
              s_terms[0], ntl,
              [&](int off, T(&v)[P]) {
#pragma unroll
                for (int u = 0; u < P; ++u)
                  v[u] = pb[off + u * kStreamThreads];
              },
              acc);
        } else {
          series<T, P>(
              s_terms[0], ntl,
              [&](int off, T(&v)[P]) {
                if (!lean && off >= -gp_lo && off <= gp_hi) {
#pragma unroll
                  for (int u = 0; u < P; ++u)
                    v[u] = pb[off + u * kStreamThreads];
                } else {
#pragma unroll
                  for (int u = 0; u < P; ++u)
                    v[u] = p_at(row0 + tid + off + u * kStreamThreads);
                }
              },
              acc);
        }
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int q = q0 + tid + u * kStreamThreads;
          uv[u] = q >= qlo && q < qhi ? mul_rn(mul_rn(acc[u], g[u]), d[u])
                                      : T(0);
        }
      } else {
#pragma unroll
        for (int u = 0; u < P; ++u) uv[u] = T(0);
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        int pos = u_ring + tid + u * kStreamThreads;
        pos -= pos >= ru ? ru : 0;
        ur[pos] = uv[u];
        if (pos < gu_hi) ur[pos + ru] = uv[u];
        if (pos >= ru - gu_lo) ur[pos - ru] = uv[u];
      }
    }
    const int tx = first + dir * (m - bu - bx);   // X_m's tile
    const bool formed = !lean && m < nx && tx >= 0 && tx < inner1 + inner0;
    if (formed) {   // p tile X_m into the p ring and its copies
      const V* sv = reinterpret_cast<const V*>(st);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int v = tid + j * kStreamThreads;
        if (kWords % kStreamThreads != 0 && v >= kWords) break;
        V pw = sv[v];
        if (nin > 1) {
          const V bw = sv[kWords + v];
          const V cw = nin > 2 ? sv[2 * kWords + v] : bw;
          T* pe = reinterpret_cast<T*>(&pw);
          const T* be = reinterpret_cast<const T*>(&bw);
          const T* ce = reinterpret_cast<const T*>(&cw);
#pragma unroll
          for (int q = 0; q < kVec; ++q) pe[q] = combine(pe[q], be[q], ce[q]);
        }
        const int pos = x_p + v * kVec;
        *reinterpret_cast<V*>(pr + pos) = pw;
        if (pos < gp_hi) *reinterpret_cast<V*>(pr + pos + rp) = pw;
        if (pos >= rp - gp_lo) *reinterpret_cast<V*>(pr + pos - rp) = pw;
      }
    }
    // U_i and X_m written, every read of load m's stage done: the stage
    // takes load m + stages
    __syncthreads();
    if (!lean && tid == 0 && m + stages < nloads) issue(m + stages);
    if (w >= 0) {   // y tile Y_w from the u ring
      T out[P];
      if (yq0 < lim) {
        const int ub = y_ring + tid;
        T acc[P];
        if (wrap) {
          series<T, P>(
              s_terms[1], ntu,
              [&](int off, T(&v)[P]) {
                int r0 = ub + off;
                r0 += r0 < 0 ? ru : 0;
                r0 -= r0 >= ru ? ru : 0;
#pragma unroll
                for (int u = 0; u < P; ++u) {
                  int r = r0 + u * kStreamThreads;
                  r -= r >= ru ? ru : 0;
                  v[u] = ur[r];
                }
              },
              acc);
        } else {
          const T* yb = ur + ub;
          series<T, P>(
              s_terms[1], ntu,
              [&](int off, T(&v)[P]) {
#pragma unroll
                for (int u = 0; u < P; ++u)
                  v[u] = yb[off + u * kStreamThreads];
              },
              acc);
        }
#pragma unroll
        for (int u = 0; u < P; ++u)
          out[u] = yq0 + tid + u * kStreamThreads < lim
                       ? mul_rn(acc[u], gy[u])
                       : T(0);
      } else {
#pragma unroll
        for (int u = 0; u < P; ++u) out[u] = T(0);
      }
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int e = tid + u * kStreamThreads;
        if (lean)
          y_out[yrow0 + e] = out[u];
        else
          staged[e] = out[u];
      }
    }
    if (pv_out != nullptr) {   // B5's p of the run's own tiles
      const int wx = m - bu - bx;
      if (formed && wx >= 0 && wx < t1 - t0) {   // X_m, just formed
        const V* src = reinterpret_cast<const V*>(pr + x_p);
        V* dst = pv_out + tx * kWords;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int v = tid + j * kStreamThreads;
          if (kWords % kStreamThreads == 0 || v < kWords) dst[v] = src[v];
        }
      } else if (lean && w >= 0) {
        const int ty = first + dir * w;
        const V* av = reinterpret_cast<const V*>(xa) + ty * kWords;
        const V* bv = reinterpret_cast<const V*>(xb) + ty * kWords;
        const V* cv = nin > 2 ? reinterpret_cast<const V*>(xc) + ty * kWords
                              : bv;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int v = tid + j * kStreamThreads;
          if (kWords % kStreamThreads != 0 && v >= kWords) break;
          V pw = __ldg(av + v);
          const V bw = __ldg(bv + v);
          const V cw = nin > 2 ? __ldg(cv + v) : bw;
          T* pe = reinterpret_cast<T*>(&pw);
          const T* be = reinterpret_cast<const T*>(&bw);
          const T* ce = reinterpret_cast<const T*>(&cw);
#pragma unroll
          for (int q = 0; q < kVec; ++q) pe[q] = combine(pe[q], be[q], ce[q]);
          pv_out[ty * kWords + v] = pw;
        }
      }
    }
    // the staged y tile complete, every read of U_{i-U} done
    __syncthreads();
    if (!lean && w >= 0) {
      const V* sv = reinterpret_cast<const V*>(staged);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int v = tid + j * kStreamThreads;
        if (kWords % kStreamThreads == 0 || v < kWords)
          yv[yrow0 / kVec + v] = sv[v];
      }
    }
    // one tile on
    if (!lean && ++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
    if (i >= 0) u_tile += dir;
    u_ring = i >= 0 ? wrap_add(u_ring, step, ru) : u_ring;
    u_gap = i >= 0 ? wrap_add(u_gap, step, block) : u_gap;
    u_p = i >= 0 && !lean ? wrap_add(u_p, step, rp) : u_p;
    y_ring = wrap_add(y_ring, step, ru);
    y_gap = wrap_add(y_gap, step, block);
    x_p = lean ? 0 : wrap_add(x_p, step, rp);
  }
}

// Raise the block's dynamic shared-memory limit to `bytes` once per kernel
// (also below 48 KB: the default limit counts the static shared memory).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

// B6 with Self as `da` has it.
template <typename T, int P, bool Self>
cudaError_t launch_dots_p(const T* x, const T* gap, T* y, const TermsT<T>& t,
                          int npad, int block, int lim, int halo, int stages,
                          int ctas, size_t smem, const DotsArgs<T>& da,
                          cudaStream_t stream) {
  static size_t allowed = 0;
  cudaError_t err =
      allow_smem(const_stencil_spmv_dots_kernel<T, P, Self>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const_stencil_spmv_dots_kernel<T, P, Self>
      <<<ctas, kStreamThreads, smem, stream>>>(x, gap, y, t, npad, block, lim,
                                               halo, stages, da);
  return cudaSuccess;
}

// B1 on `nshards` shards, or B6 (one vector, lim0 its lim) where `da` is
// given.
template <typename T, int P>
int launch_spmv_p(const void* x, const void* gap, void* y,
                  const TermsT<T>& t, int npad, int block, long long lim0,
                  int nshards, int halo, int stages, int ctas,
                  const DotsArgs<T>* da, cudaStream_t stream) {
  static size_t allowed = 0;
  constexpr int kTile = P * kStreamThreads;
  const size_t smem = sizeof(T) * static_cast<size_t>(stages + 2) * kTile +
                      sizeof(std::uint64_t) * stages;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gap);
  T* yt = static_cast<T*>(y);
  cudaError_t err;
  if (da == nullptr) {
    err = allow_smem(const_stencil_spmv_kernel<T, P>, smem, &allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const_stencil_spmv_kernel<T, P>
        <<<dim3(ctas, nshards), kStreamThreads, smem, stream>>>(
            xt, gt, yt, t, npad, block, lim0, halo, stages);
  } else {
    const int lim = static_cast<int>(lim0);
    err = da->with_self
              ? launch_dots_p<T, P, true>(xt, gt, yt, t, npad, block, lim,
                                          halo, stages, ctas, smem, *da,
                                          stream)
              : launch_dots_p<T, P, false>(xt, gt, yt, t, npad, block, lim,
                                           halo, stages, ctas, smem, *da,
                                           stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// B1 and B6: checks every argument the kernel relies on.  B1 takes any
// lim0 (each shard's lim is clipped to [0, npad]); B6 one vector and its
// lim.
template <typename T>
int launch_spmv(const void* x, const void* gap, void* y, const TermsT<T>& t,
                int npad, int block, long long lim0, int nshards,
                int log_tile, int halo, int stages, int ctas,
                const DotsArgs<T>* da, cudaStream_t stream) {
  if (log_tile < 9 || log_tile > 11 || stages > 256) return kBadArgs;
  const int tile = 1 << log_tile;
  if (tile * static_cast<int>(sizeof(T)) < 16 * kStreamThreads ||
      block <= 0 || block % tile != 0 || npad < 0 || npad % tile != 0 ||
      static_cast<long long>(npad) + 2LL * block >= (1LL << 31) ||
      nshards < 1 || nshards > 65535 || halo < 0 || 2 * halo + 2 > stages ||
      static_cast<long long>(halo) * tile > block || ctas < 1 ||
      ctas > npad / tile || !aligned16(x) || !aligned16(y))
    return kBadArgs;
  if (da != nullptr &&
      (nshards != 1 || lim0 < 0 || lim0 > npad || da->partials == nullptr ||
       da->dots == nullptr || da->ticket == nullptr || !aligned16(da->w) ||
       (da->w == nullptr && !da->with_self)))
    return kBadArgs;
  for (int k = 0; k < t.n; ++k)
    if (t.off[k] > block || t.off[k] < -block) return kBadArgs;
  switch (log_tile) {
    case 9:
      return launch_spmv_p<T, 2>(x, gap, y, t, npad, block, lim0, nshards,
                                 halo, stages, ctas, da, stream);
    case 10:
      return launch_spmv_p<T, 4>(x, gap, y, t, npad, block, lim0, nshards,
                                 halo, stages, ctas, da, stream);
    default:
      return launch_spmv_p<T, 8>(x, gap, y, t, npad, block, lim0, nshards,
                                 halo, stages, ctas, da, stream);
  }
}

template <typename T, int P>
int launch_msolve_p(const MsolveArgs<T>& k, int ctas, int nshards,
                    size_t smem, cudaStream_t stream) {
  static size_t allowed = 0;
  cudaError_t err =
      allow_smem(const_series_msolve_kernel<T, P>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const_series_msolve_kernel<T, P>
      <<<dim3(ctas, nshards), kStreamThreads, smem, stream>>>(k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool fill_typed(TermsT<T>* t, const int* off, const void* c, int n, int* lo,
                int* hi) {
  if (n < 1 || n > kMaxTerms) return false;
  t->n = n;
  *lo = *hi = 0;
  for (int j = 0; j < n; ++j) {
    t->off[j] = off[j];
    t->c[j] = static_cast<const T*>(c)[j];
    *lo = std::max(*lo, -off[j]);
    *hi = std::max(*hi, off[j]);
  }
  return true;
}

// The geometry of ops/_kernels.py's msolve_plan, in this order.
enum Geo {
  kGeoTile, kGeoStages, kGeoXlo, kGeoXhi, kGeoGpLo, kGeoGpHi, kGeoUlo,
  kGeoUhi, kGeoRu, kGeoGuLo, kGeoGuHi, kGeoWrap, kGeoCtas
};

// B2 (nin 1: a = x) and B5 (nin 2 or 3) on `nshards` shards.  Checks every
// argument the kernel relies on; shared memory as msolve_plan counts it.
template <typename T>
int launch_msolve(int nin, const void* a, const void* b, const void* c,
                  const void* c1, const void* c2, const void* inv_d,
                  const void* gap, void* p, void* y, const int* off_l,
                  const void* c_l, int nterms_l, const int* off_u,
                  const void* c_u, int nterms_u, int npad, int block,
                  int base, int np_true, int nshards, const int* geo,
                  cudaStream_t stream) {
  MsolveArgs<T> k;
  int hl_lo, hl_hi, hu_lo, hu_hi;
  if (!fill_typed(&k.tl, off_l, c_l, nterms_l, &hl_lo, &hl_hi) ||
      !fill_typed(&k.tu, off_u, c_u, nterms_u, &hu_lo, &hu_hi))
    return kBadArgs;
  const int tile = geo[kGeoTile];
  constexpr int kVec = 16 / sizeof(T);
  k.a = static_cast<const T*>(a);
  k.b = static_cast<const T*>(b);
  k.c = static_cast<const T*>(c);
  k.c1p = static_cast<const T*>(c1);
  k.c2p = static_cast<const T*>(c2);
  k.inv_d = static_cast<const T*>(inv_d);
  k.gap = static_cast<const T*>(gap);
  k.p = static_cast<T*>(p);
  k.y = static_cast<T*>(y);
  k.npad = npad;
  k.block = block;
  k.base = base;
  k.np_true = np_true;
  k.nin = nin;
  k.stages = geo[kGeoStages];
  k.xlo = geo[kGeoXlo];
  k.xhi = geo[kGeoXhi];
  k.gp_lo = geo[kGeoGpLo];
  k.gp_hi = geo[kGeoGpHi];
  k.ulo = geo[kGeoUlo];
  k.uhi = geo[kGeoUhi];
  k.ru = geo[kGeoRu];
  k.gu_lo = geo[kGeoGuLo];
  k.gu_hi = geo[kGeoGuHi];
  k.wrap = geo[kGeoWrap];
  const int ctas = geo[kGeoCtas];
  const bool lean = k.stages == 0;
  const bool streams_ok =
      a != nullptr && inv_d != nullptr && gap != nullptr && y != nullptr &&
      (nin == 1 ? p == nullptr
                : b != nullptr && c1 != nullptr && p != nullptr &&
                      (nin == 2 || (c != nullptr && c2 != nullptr)));
  if (nin < 1 || nin > 3 || !streams_ok || tile < kStreamThreads ||
      tile * sizeof(T) > 8192 || (tile & (tile - 1)) != 0 ||
      block <= 0 || block % tile != 0 || npad <= 0 || npad % block != 0 ||
      static_cast<long long>(npad) + 2LL * block >= (1LL << 31) ||
      base < 0 || np_true < 0 || nshards < 1 || nshards > 65535 ||
      k.stages < 0 || k.stages > 64 || ctas < 1 ||
      ctas > npad / tile || std::max(hl_lo, hl_hi) > block ||
      std::max(hu_lo, hu_hi) > block)
    return kBadArgs;
  // the p ring: P_l's terms within [-gp_lo, gp_hi] read it
  if (k.xlo < 0 || k.xhi < 0 || k.gp_lo < 0 || k.gp_hi < 0 ||
      k.gp_lo % kVec || k.gp_hi % kVec || k.gp_lo > k.xlo * tile ||
      k.gp_hi > k.xhi * tile || k.xlo * tile > block ||
      k.xhi * tile > block ||
      (lean && (k.xlo || k.xhi || k.gp_lo || k.gp_hi)))
    return kBadArgs;
  // the u ring holds P_u's whole reach
  if (k.ulo < 0 || k.uhi < 0 || k.ulo * tile < hu_lo ||
      k.uhi * tile < hu_hi || k.ulo * tile > block || k.uhi * tile > block ||
      k.ru % kVec || k.gu_lo % kVec || k.gu_hi % kVec)
    return kBadArgs;
  if (k.wrap) {
    if (k.gu_lo || k.gu_hi || k.ru < (k.uhi + 1) * tile + hu_lo ||
        k.ru < (k.ulo + 1) * tile + hu_hi)
      return kBadArgs;
  } else if (k.ru != (k.ulo + k.uhi + 1) * tile || k.gu_lo < hu_lo ||
             k.gu_hi < hu_hi || k.gu_lo > k.ru || k.gu_hi > k.ru) {
    return kBadArgs;
  }
  const long long rows =
      static_cast<long long>(k.stages) * (nin + 1) * tile +
      (lean ? 0 : k.gp_lo + (k.xlo + k.xhi + 2) * tile + k.gp_hi + tile) +
      k.gu_lo + k.ru + k.gu_hi;
  const size_t smem = sizeof(T) * static_cast<size_t>(rows) +
                      sizeof(std::uint64_t) * k.stages;
  // beside the kernel's static terms (2 (kMaxTerms + 1) offsets and T's)
  if (smem + 2 * (kMaxTerms + 1) * (sizeof(int) + sizeof(T)) > kSmemLimit)
    return kBadArgs;
  switch (tile / kStreamThreads) {
    case 1:
      return launch_msolve_p<T, 1>(k, ctas, nshards, smem, stream);
    case 2:
      return launch_msolve_p<T, 2>(k, ctas, nshards, smem, stream);
    case 4:
      return launch_msolve_p<T, 4>(k, ctas, nshards, smem, stream);
    default:
      if constexpr (sizeof(T) == 4)   // 8 KB tiles: 2048 rows in f32 only
        return launch_msolve_p<T, 8>(k, ctas, nshards, smem, stream);
      return kBadArgs;
  }
}

// B1 (w, partials, dots and ticket null) or B6: the terms as the kernels
// take them, then launch_spmv.
template <typename T>
int spmv_entry(const void* x, const void* gap, const void* w, void* y,
               void* partials, void* dots, void* ticket, int with_self,
               const int* off, const void* c, int nterms, int npad,
               int block, long long lim0, int nshards, int log_tile,
               int halo, int stages, int ctas, cudaStream_t s) {
  if (nterms < 1 || nterms > kMaxTerms) return kBadArgs;
  TermsT<T> t;
  t.n = nterms;
  for (int k = 0; k < nterms; ++k) {
    t.off[k] = off[k];
    t.c[k] = static_cast<const T*>(c)[k];
  }
  DotsArgs<T> da{static_cast<const T*>(w), static_cast<T*>(partials),
                 static_cast<T*>(dots), static_cast<unsigned*>(ticket),
                 with_self != 0};
  return launch_spmv<T>(x, gap, y, t, npad, block, lim0, nshards, log_tile,
                        halo, stages, ctas, dots != nullptr ? &da : nullptr,
                        s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  B1: `c` holds the nterms coefficients
// in that dtype; the geometry (tile = 2^log_tile, halo, ring stages, ctas
// a shard) is the wrapper's (ops/_kernels.py: spmv_plan).  x and y hold
// nshards vectors of npad + 2 block one after another; lim0 = np_true -
// base of the first.
int cmt_const_stencil_spmv(int dtype, const void* x, const void* gap, void* y,
                           const int* off, const void* c, int nterms,
                           int npad, int block, long long lim0, int nshards,
                           int log_tile, int halo, int stages, int ctas,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return spmv_entry<float>(x, gap, nullptr, y, nullptr, nullptr, nullptr,
                             0, off, c, nterms, npad, block, lim0, nshards,
                             log_tile, halo, stages, ctas, s);
  if (dtype == 1)
    return spmv_entry<double>(x, gap, nullptr, y, nullptr, nullptr, nullptr,
                              0, off, c, nterms, npad, block, lim0, nshards,
                              log_tile, halo, stages, ctas, s);
  return kBadArgs;
}

// B2.  The terms: int32 offsets, coefficients in the dtype; gap points at
// gap[0] of the layout block; geo is msolve_plan's (see enum Geo; its ctas
// a shard).  The vectors hold nshards shards of npad + 2 block one after
// another; base is the first's global strided row of q = 0.
int cmt_const_series_msolve(int dtype, const void* x, const void* inv_d,
                            const void* gap, void* y, const int* off_l,
                            const void* c_l, int nterms_l, const int* off_u,
                            const void* c_u, int nterms_u, int npad,
                            int block, int base, int np_true, int nshards,
                            const int* geo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_msolve<float>(1, x, nullptr, nullptr, nullptr, nullptr,
                                inv_d, gap, nullptr, y, off_l, c_l,
                                nterms_l, off_u, c_u, nterms_u, npad, block,
                                base, np_true, nshards, geo, s);
  if (dtype == 1)
    return launch_msolve<double>(1, x, nullptr, nullptr, nullptr, nullptr,
                                 inv_d, gap, nullptr, y, off_l, c_l,
                                 nterms_l, off_u, c_u, nterms_u, npad, block,
                                 base, np_true, nshards, geo, s);
  return kBadArgs;
}

// B6, as B1, and: w may be null (no weight); partials holds
// (npad + 2 block) / 256 rows of (w != null) + with_self elements, dots
// that many; ticket is a uint32 that is 0 (and is 0 again at the end),
// used by no other launch while this one runs.
int cmt_const_stencil_spmv_dots(int dtype, const void* x, const void* gap,
                                const void* w, void* y, void* partials,
                                void* dots, void* ticket, int with_self,
                                const int* off, const void* c, int nterms,
                                int npad, int block, int lim, int log_tile,
                                int halo, int stages, int ctas,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dots == nullptr) return kBadArgs;
  if (dtype == 0)
    return spmv_entry<float>(x, gap, w, y, partials, dots, ticket, with_self,
                             off, c, nterms, npad, block, lim, 1, log_tile,
                             halo, stages, ctas, s);
  if (dtype == 1)
    return spmv_entry<double>(x, gap, w, y, partials, dots, ticket,
                              with_self, off, c, nterms, npad, block, lim, 1,
                              log_tile, halo, stages, ctas, s);
  return kBadArgs;
}

// B5, as B2.  c (and with it c2) null: the two-stream form p = a + c1 * b.
int cmt_const_series_msolve_fma(int dtype, const void* a, const void* b,
                                const void* c, const void* c1, const void* c2,
                                const void* inv_d, const void* gap, void* p,
                                void* y, const int* off_l, const void* c_l,
                                int nterms_l, const int* off_u,
                                const void* c_u, int nterms_u, int npad,
                                int block, int base, int np_true,
                                int nshards, const int* geo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nin = c != nullptr ? 3 : 2;
  if (dtype == 0)
    return launch_msolve<float>(nin, a, b, c, c1, c2, inv_d, gap, p, y,
                                off_l, c_l, nterms_l, off_u, c_u, nterms_u,
                                npad, block, base, np_true, nshards, geo, s);
  if (dtype == 1)
    return launch_msolve<double>(nin, a, b, c, c1, c2, inv_d, gap, p, y,
                                 off_l, c_l, nterms_l, off_u, c_u, nterms_u,
                                 npad, block, base, np_true, nshards, geo,
                                 s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
