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
// A row's level is one more than the deepest row it depends on, so the rows
// of a level depend only on earlier levels:
//
//   y[row] = f[row] - sum_e vals[e] * y[col[e]]         (forward, unit L)
//   y[row] = (f[row] - sum_e vals[e] * y[col[e]]) / d   (backward, U)
//
// What bounds it: the chain of levels (7N - 6 a sweep for a 27-point N^3
// grid), not bytes.  A level holds a few thousand rows at most, so each
// level's work is a few hundred kilobytes and a few microseconds' latency at
// best.  Both forms spend one cooperative launch a sweep (a launch a level
// would put thousands of host launches in each iteration); the plan
// (cuda_mat_tpu_torch/ops/level_trisolve.py, LevelPlan) picks the form.
//
// The chunked form, where the triangle's bandwidth w fits a block's shared
// memory (level_trisolve.chunks_fit: w values within CHUNK_BYTES, beside
// the ring).  The rows are cut into chunks of w rows in sweep order, so a
// row reads only its own chunk and the chunk before it, and each chunk
// goes to one block.  The block keeps its chunk's values in shared memory
// and parts its levels by a block barrier; a value crosses SMs only where
// the next chunk reads it, and each hand-over is point to point between
// two neighbouring blocks (a progress word), never a barrier of the whole
// grid.  So a sweep's chain is about (levels - chunks) * t + chunks * L, t
// a level inside a block and L a hand-over between SMs, where the
// grid-barrier form pays a hand-over on every level.  The solved values
// cross in a hand-over buffer in position order, so the next chunk's rows
// of a level read them in a few whole lines (a gather by row number would
// touch a line a row).  The layout and the protocol are the namespace
// `chunked`'s note below.
//
// The grid-barrier form, every other triangle (a band nearly as wide as
// the matrix gives a chunk too wide for shared memory, and a handful of
// chunks would each be a chain on one SM).  Layout: the rows in level
// order, position p holding row rows[p], whose entries (columns ascending)
// are cols/vals[ptr[p] .. ptr[p+1]); level l is positions level_ptr[l] ..
// level_ptr[l+1].  A persistent cooperative grid walks all levels with a
// grid-wide barrier between them.  Each thread owns position level_ptr[l] +
// t of every level (more only where a level outgrows the grid), t numbering
// the grid's warps across the blocks first, so a level's rows spread over
// every SM (on an H100 at HPCG 104^3 a level went from 3.05 to 2.78 us: the
// gathers no longer queue on a few SMs).  A thread fetches its row's
// pointers, right-hand side, diagonal and first kHeld entries into
// registers before the barrier that opens the level, so after it only the
// gather of the solved values remains.  Solved values are read through L2
// (ld.global.cg): L1 is not coherent across blocks, and a line of y may sit
// in it from before the row's level.  On an H100 a level costs about 2.8
// us: the grid barrier alone 1.16 us, the gathers about 0.55, the rest the
// fetch's dependent loads, the arithmetic and the store.
//
// Products and sums use the _rn intrinsics, which nvcc never contracts into
// an FMA, summed in the row's column order from 0, as the plain twin
// (level_sweep_plain) forms them, and U divides by its stored diagonal: both
// forms give the same bits.
//
// The launchers are extern "C" for ctypes: they launch on the caller's
// stream, never synchronise, allocate nothing, and return the launch's error
// code (or kBadArgs for arguments the kernel does not take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tma_ring.cuh"

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


// ---- The chunked form: a block a chunk, hand-overs by progress word ----
//
// Layout (level_trisolve.py, _chunked): the triangle's rows cut into chunks
// of `width` (its bandwidth) rows in sweep order, so a row reads only its
// own chunk and the chunk before it; rows at positions by (chunk, level),
// a level cut into groups of at most kCompute rows.  Group g's table
// entry: e_off, pos0, R | K << 16, need.  Its rows sit at positions
// pos0 .. pos0 + R (rows/diag by position); entry k of its row i is
// cols/vals[e_off + k*R + i], each group's slots padded to 16 bytes so two
// bulk copies bring them into a stage of the ring.  A column is coded: c >=
// 0 the row at position c of its own chunk (shared memory), c <= -2 the row
// at position -c - 2 of the previous chunk (the hand-over buffer, which
// each block writes by position as it solves), -1 no entry.  `need` counts
// the groups of the previous chunk the group's rows read: those below its
// level.
namespace chunked {

constexpr int kCompute = 128;  // CHUNK_THREADS: a group's rows at most
constexpr int kSignal = 96;    // warp 0 waits on the previous chunk, warp 1
                               // publishes this chunk's progress, warp 2
                               // fills the ring
constexpr int kBlock = kSignal + kCompute;
constexpr int kComputeBarrier = 1;  // named barrier of the compute warps
constexpr unsigned long long kMaxWaitNs = 2000000000ULL;  // a wait longer
                                // than 2 s gives up and goes on with what
                                // it has, so a fault cannot hang the card

template <typename T>
struct Args {
  const T* f;
  T* y;
  const int4* groups;
  const int* chunk_ptr;  // chunks + 1: chunk c is groups [ptr[c], ptr[c+1])
  const int* rows;       // by position
  const int* cols;       // by entry slot, coded
  const T* vals;         // by entry slot
  const T* diag;         // by position; nullptr: unit diagonal (forward)
  T* handover;           // by position: the solved values, for the next chunk
  int* flags;            // chunks progress words, 0 before and after a launch
  int n, width, chunks, most, stages, slot;
};

__host__ __device__ constexpr size_t pad16(size_t b) {
  return (b + 15) / 16 * 16;
}

// The chunk's values, the ring, the chunk's group table, the stages' and
// the table's mbarriers, two progress words (level_trisolve.chunk_smem).
inline size_t smem_bytes(int width, size_t item, int stages, int slot,
                         int most) {
  return pad16(static_cast<size_t>(width) * item) +
         static_cast<size_t>(stages) * slot + 16 * static_cast<size_t>(most) +
         8 * static_cast<size_t>(stages + 1) + 8;
}

__device__ __forceinline__ int load_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void store_relaxed_gpu(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int load_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(cmt::smem_addr(p))
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(
                   cmt::smem_addr(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kComputeBarrier), "n"(kCompute)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned pad4(unsigned k) { return (k + 3) & ~3u; }

// One block's view of its chunk.
template <typename T>
struct Chunk {
  T* ys;                // the chunk's values by position: f, then solved
  unsigned char* ring;  // stages of `slot` bytes
  int4* table;          // the chunk's groups
  std::uint64_t* bars;  // a barrier a stage, then the table's
  int* ready;           // the previous chunk's groups published
  int* done;            // this chunk's groups solved
  int pos0;             // the chunk's first position
  unsigned mask, shift;  // stages - 1, log2(stages)
};

// Warp 2's lane 0: group g's values and columns into `stage`.
template <typename T>
__device__ __forceinline__ void fill_stage(const Args<T>& a, const int4 g,
                                           unsigned char* stage,
                                           std::uint64_t* bar) {
  const unsigned ke = pad4((g.z >> 16) * (g.z & 0xFFFF));
  const unsigned vb = ke * sizeof(T), cb = ke * 4;
  cmt::mbar_expect(bar, vb + cb);
  if (ke) {
    cmt::bulk_copy(stage, a.vals + g.x, vb, bar);
    cmt::bulk_copy(stage + vb, a.cols + g.x, cb, bar);
  }
}

// A group's slots in a stage.
template <typename T>
struct Stage {
  const T* vals;
  const int* cols;
  unsigned r, k;
  __device__ __forceinline__ Stage(const unsigned char* stage, int4 g)
      : vals(reinterpret_cast<const T*>(stage)), r(g.z & 0xFFFF),
        k(g.z >> 16) {
    cols = reinterpret_cast<const int*>(stage + pad4(k * r) * sizeof(T));
  }
};

// Row i of a group, fetched before its level: its row, diagonal, first
// kHeld entries' columns and values, and their previous chunk's values
// once published (`fetched`).
template <typename T>
struct Ops {
  int row;
  T d;
  int col[kHeld];
  T val[kHeld];
  T got[kHeld];
  bool fetched;
};

// The previous chunk's values of a row's first kHeld entries, from the
// hand-over buffer through L2 (L1 is not coherent across blocks).
template <typename T>
__device__ __forceinline__ void fetch_prev(Ops<T>& o, const T* handover) {
#pragma unroll
  for (int e = 0; e < kHeld; ++e)
    if (o.col[e] <= -2) o.got[e] = __ldcg(handover - 2 - o.col[e]);
  o.fetched = true;
}

// Group g + 1's operands for compute thread ct (row ct of the group, in
// stage q), fetched while group g is solved.
template <typename T, bool UNIT>
__device__ __forceinline__ void ahead(Ops<T>& o, const Args<T>& a,
                                      const Chunk<T>& ch, const int4 g,
                                      unsigned q, int ct, int& seen) {
  const unsigned st = q & ch.mask;
  const Stage<T> s(ch.ring + st * a.slot, g);
  if (ct >= static_cast<int>(s.r)) return;
  const int p = g.y + ct;
  o.row = __ldg(a.rows + p);
  if (!UNIT) o.d = __ldg(a.diag + p);
  cmt::mbar_wait(ch.bars + st, (q >> ch.shift) & 1u);
#pragma unroll
  for (int e = 0; e < kHeld; ++e) {
    const bool in = e < static_cast<int>(s.k);
    o.col[e] = in ? s.cols[e * s.r + ct] : -1;
    o.val[e] = in ? s.vals[e * s.r + ct] : T(0);
  }
  o.fetched = false;
  if (seen < g.w) seen = load_acquire_cta(ch.ready);
  if (seen >= g.w) fetch_prev(o, a.handover);
}

// Row ct of group g solved: its own chunk's values from shared memory,
// the products summed in column order from 0.
template <typename T, bool UNIT>
__device__ __forceinline__ void finish(Ops<T>& o, const Args<T>& a,
                                       const Chunk<T>& ch, const Stage<T>& s,
                                       const int4 g, int ct) {
#pragma unroll
  for (int e = 0; e < kHeld; ++e)
    if (o.col[e] >= 0) o.got[e] = ch.ys[o.col[e]];
  T sum = T(0);
#pragma unroll
  for (int e = 0; e < kHeld; ++e)
    if (o.col[e] != -1) sum = add_rn(sum, mul_rn(o.val[e], o.got[e]));
  for (int e = kHeld; e < static_cast<int>(s.k); ++e) {
    const int c = s.cols[e * s.r + ct];
    if (c == -1) break;
    sum = add_rn(sum, mul_rn(s.vals[e * s.r + ct],
                             c >= 0 ? ch.ys[c] : __ldcg(a.handover - 2 - c)));
  }
  const int p = g.y + ct, at = p - ch.pos0;
  const T v = sub_rn(ch.ys[at], sum);
  const T out = UNIT ? v : div_rn(v, o.d);
  ch.ys[at] = out;
  a.handover[p] = out;
  a.y[o.row] = out;
}

// Group j (held in `cur`, its stage q) solved, group j + 1's operands
// fetched into `nxt` first; then the compute warps' barrier.
template <typename T, bool UNIT>
__device__ __forceinline__ void step(Ops<T>& cur, Ops<T>& nxt,
                                     const Args<T>& a, const Chunk<T>& ch,
                                     int j, int groups, unsigned q, int ct,
                                     int& seen) {
  const int4 g = ch.table[j];
  if (j + 1 < groups)
    ahead<T, UNIT>(nxt, a, ch, ch.table[j + 1], q + 1, ct, seen);
  const Stage<T> s(ch.ring + (q & ch.mask) * a.slot, g);
  if (ct < static_cast<int>(s.r)) {
    if (!cur.fetched) {
      const unsigned long long t0 = now_ns();
      while (seen < g.w && now_ns() - t0 < kMaxWaitNs)
        seen = load_acquire_cta(ch.ready);
      fetch_prev(cur, a.handover);
    }
    finish<T, UNIT>(cur, a, ch, s, g, ct);
  }
  __syncwarp();
  compute_sync();
  if (ct == 0) store_release_cta(ch.done, j + 1);
}

// B8, chunked: one sweep in one cooperative launch, block b walking chunks
// b, b + G, ... in order.  Per chunk: f's rows of the chunk into shared
// memory by position (each solved value overwrites its f) and the group
// table in; warp 0 mirrors the previous chunk's progress word into `ready`
// and clears the word once that chunk is done; warp 1 publishes `done`
// into this chunk's word; warp 2 keeps the ring's stages filled, a group
// into the stage that the group `stages` before it freed; the compute
// warps solve group j with group j + 1's operands fetched ahead.
template <typename T, bool UNIT>
__global__ void __launch_bounds__(kBlock) level_sweep_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Chunk<T> ch;
  ch.ys = reinterpret_cast<T*>(smem);
  ch.ring = smem + pad16(static_cast<size_t>(a.width) * sizeof(T));
  ch.table = reinterpret_cast<int4*>(
      ch.ring + static_cast<size_t>(a.stages) * a.slot);
  ch.bars = reinterpret_cast<std::uint64_t*>(ch.table + a.most);
  ch.ready = reinterpret_cast<int*>(ch.bars + a.stages + 1);
  ch.done = ch.ready + 1;
  ch.mask = static_cast<unsigned>(a.stages) - 1;
  ch.shift = static_cast<unsigned>(__ffs(a.stages) - 1);
  std::uint64_t* table_bar = ch.bars + a.stages;
  const int ct = static_cast<int>(threadIdx.x) - kSignal;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= a.stages; ++s) cmt::mbar_init(ch.bars + s);
    cmt::mbar_fence_init();
  }
  __syncthreads();
  unsigned q = 0;       // groups this block has walked: the ring's phases
  unsigned begun = 0;   // chunks it has begun: the table barrier's phases
  for (int c = blockIdx.x; c < a.chunks; c += gridDim.x, ++begun) {
    const int g0 = __ldg(a.chunk_ptr + c);
    const int groups = __ldg(a.chunk_ptr + c + 1) - g0;
    ch.pos0 = __ldg(&a.groups[g0].y);
    const int len = (c + 1 < a.chunks
                         ? __ldg(&a.groups[__ldg(a.chunk_ptr + c + 1)].y)
                         : a.n) - ch.pos0;
    if (threadIdx.x == 64) {
      *ch.ready = c == 0 ? INT_MAX : 0;
      *ch.done = 0;
      cmt::mbar_expect(table_bar, 16u * groups);
      cmt::bulk_copy(ch.table, a.groups + g0, 16u * groups, table_bar);
    }
#pragma unroll 8
    for (int i = threadIdx.x; i < len; i += kBlock)
      ch.ys[i] = __ldg(a.f + __ldg(a.rows + ch.pos0 + i));
    __syncthreads();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0 && c > 0) {
        const int total = g0 - __ldg(a.chunk_ptr + c - 1);
        int* word = a.flags + c - 1;
        const unsigned long long t0 = now_ns();
        int seen = 0;
        while (seen < total && now_ns() - t0 < kMaxWaitNs) {
          const int v = load_acquire_gpu(word);
          if (v != seen) {
            seen = v;
            store_release_cta(ch.ready, v);
          }
        }
        if (seen < total) store_release_cta(ch.ready, INT_MAX);
        store_relaxed_gpu(word, 0);  // as found, for the next launch
      }
      __syncwarp();
    } else if (threadIdx.x < 64) {
      if (threadIdx.x == 32 && c + 1 < a.chunks) {
        int* word = a.flags + c;
        const unsigned long long t0 = now_ns();
        for (int told = 0; told < groups && now_ns() - t0 < kMaxWaitNs;) {
          const int d = load_acquire_cta(ch.done);
          if (d != told) {
            told = d;
            store_release_gpu(word, d);
          }
        }
      }
      __syncwarp();
    } else if (ct < 0) {
      if (threadIdx.x == 64) {
        cmt::mbar_wait(table_bar, begun & 1u);
        const unsigned long long t0 = now_ns();
        int freed = 0;
        for (int j = 0; j < groups; ++j) {
          // group j's stage is group j - stages's, free once that is done
          while (j - a.stages >= freed && now_ns() - t0 < kMaxWaitNs)
            freed = load_acquire_cta(ch.done);
          const unsigned st = (q + j) & ch.mask;
          fill_stage<T>(a, ch.table[j], ch.ring + st * a.slot, ch.bars + st);
        }
      }
      __syncwarp();
    } else {
      cmt::mbar_wait(table_bar, begun & 1u);
      int seen = 0;
      Ops<T> x, z;
      x.fetched = false;
      ahead<T, UNIT>(x, a, ch, ch.table[0], q, ct, seen);
      int j = 0;
      for (; j + 1 < groups; j += 2) {
        step<T, UNIT>(x, z, a, ch, j, groups, q + j, ct, seen);
        step<T, UNIT>(z, x, a, ch, j + 1, groups, q + j + 1, ct, seen);
      }
      if (j < groups) step<T, UNIT>(x, z, a, ch, j, groups, q + j, ct, seen);
    }
    q += groups;
    __syncthreads();
  }
}

template <typename T, bool UNIT>
int launch(const Args<T>& a, int blocks, cudaStream_t st) {
  void* kern = reinterpret_cast<void*>(level_sweep_kernel<T, UNIT>);
  const size_t bytes = smem_bytes(a.width, sizeof(T), a.stages, a.slot,
                                  a.most);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kBlock,
                                                        bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return kBadArgs;
  // a cooperative grid must be resident at once
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  Args<T> args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kBlock), params, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* f, void* y, const int* groups, const int* chunk_ptr,
             const int* rows, const int* cols, const void* vals,
             const void* diag, void* handover, int* flags, int n, int width,
             int chunks, int most, int stages, int slot, int blocks,
             cudaStream_t st) {
  const Args<T> a{static_cast<const T*>(f), static_cast<T*>(y),
                  reinterpret_cast<const int4*>(groups), chunk_ptr, rows,
                  cols, static_cast<const T*>(vals),
                  static_cast<const T*>(diag), static_cast<T*>(handover),
                  flags, n, width, chunks, most, stages, slot};
  return diag == nullptr ? launch<T, true>(a, blocks, st)
                         : launch<T, false>(a, blocks, st);
}

}  // namespace chunked

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

// The chunked form (level_trisolve.py's chunked layout): groups int32[G][4]
// (16-byte aligned), chunk_ptr int32[chunks + 1], rows and diag by
// position, cols (coded) and vals by entry slot, handover n values by
// position, flags int32[chunks] all 0; width the chunk's rows; most the
// groups of the largest chunk; stages (a power of two, at least 2) and slot
// (a multiple of 16 bytes) the ring's.  blocks: the grid, at least 1 (cut
// to what the card holds at once).
int cmt_level_chunk_sweep(int dtype, const void* f, void* y, const int* groups,
                          const int* chunk_ptr, const int* rows,
                          const int* cols, const void* vals, const void* diag,
                          void* handover, int* flags, int n, int width,
                          int chunks, int most, int stages, int slot,
                          int blocks, void* stream) {
  if (n < 1 || width < 1 || chunks < 1 || most < 1 || stages < 2 ||
      (stages & (stages - 1)) || slot < 16 || slot % 16 || blocks < 1)
    return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return chunked::dispatch<float>(f, y, groups, chunk_ptr, rows, cols, vals,
                                    diag, handover, flags, n, width, chunks,
                                    most, stages, slot, blocks, s);
  if (dtype == 1)
    return chunked::dispatch<double>(f, y, groups, chunk_ptr, rows, cols,
                                     vals, diag, handover, flags, n, width,
                                     chunks, most, stages, slot, blocks, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
