// Hopper (sm_90a) kernels of the exact banded ILU(0) triangular sweeps.
//
// Replaces two TPU kernels (cuda_mat_tpu/ops/pallas_trisolve.py:73, :149):
//   B4b  _banded_sweep (:73 -> pallas_call :91, kernel body _sweep_kernel :46)
//   B4a  _fused_msolve (:149 -> :170, _fused_kernel :110), which on Hopper is
//        the forward sweep then the backward one, two sweeps made by its
//        front end (ops/banded_trisolve.py; the backward sweep needs all of
//        y).
// The TPU fed its 128 x 128 matrix unit with dense block inverses; the card
// has no such need, so a sweep runs by one of two routes, chosen once per
// factor by what the factor holds (ops/banded_trisolve.py: diag_route_fits):
//
// * The diagonal-form route (namespace diag), wherever each triangle has at
//   most kK = 8 distinct off-diagonal offsets (the 5- and 9-point stencils'
//   factors have 2 and 4; the bound sizes the kernel's registers and
//   unrolled sums) and the band fits the trisolve block.  The factor's
//   values stay as _factorize made them, one array of n per offset and U's
//   diagonal, and the sweep evaluates the recurrence itself:
//     y_i = f_i - sum_o l_{i,i-o} y_{i-o}           (forward, unit L)
//     x_i = (f_i - sum_o u_{i,i+o} x_{i+o}) / u_ii  (backward; the rows are
//                                                    scaled by 1 / u_ii)
//   The recurrence is linear, so the n positions (rows in sweep order) are
//   cut into P chunks of L and solved in three launches:
//     1. chunk_walk_kernel (mode 0), one block per chunk, all at once: each
//        chunk from a zero entering tail (the tb positions before it, tb the
//        largest offset in whole 16-byte rows), its exit tail s^_c;
//     2. chunk_carry_kernel, P - 1 blocks resident together: s_0 = 0,
//        s_{c+1} = s^_c + s_c . T_c, block c holding T_c (tb x tb, the map
//        from entering to exit tail under f = 0, made once per factor in
//        float64 by chunk_walk_kernel's mode 2 from each unit tail) and
//        handing s_{c+1} to block c + 1 value by value;
//     3. chunk_walk_kernel (mode 1), chunks 1.. again from s_c.
//   Bounds: bytes a sweep: f and the values (nk + 1 arrays of n, nk + 2
//   backward with U's diagonal) read by phase 1 and again by phase 3, y
//   written once, T read once: at 1M rows in f64, 2 offsets a triangle and
//   P = 107, ~65 MB forward and ~81 MB backward, 19-24 us at 3.35 TB/s.
//   Serial depth: 2 L + P = 2 n / P + P dependent steps (2 x 9,346
//   positions + 106 hand-overs there), against n for the plain recurrence.
//   The design is bound by that chain, not by bytes.  A walk step resolves
//   up to 128 positions (32 lanes of up to 4) but costs ~1,200 cycles of
//   dependent loads, FMAs and log2(32) shuffle rounds (~6.3 ns a position
//   at 1M rows on an H100); a carry step is a hand-over through L2 (~0.3
//   us) and a sum over T_c in registers (~0.8 us), so P
//   (ops/banded_trisolve.py: diag_chunk_shape) balances the walks' 2 n / P
//   positions against the P steps, at most one carry block per SM.
//
// * The dense route, for every other factor whose band fits the block and
//   for the arrays carried over from the JAX package: over nb row blocks
//   of B rows the blocked recurrence
//     y_b = f_b . Wt[b] - y_{b-1} . WCt[b]      (row vector times B x B)
//   (forward over b = 0..nb-1, backward over b = nb-1..0, y_{-1} = y_{nb} =
//   0), Wt and WCt the host-made (nb, B, B) row-major arrays, so column j of
//   y_b sums rows k of Wt[b] and WCt[b].  Only `bw` rows of WCt[b] can be
//   nonzero (the carry rows: B-bw..B-1 forward, 0..bw-1 backward), so y_b
//   depends on y_{b-1} only through its bw carry columns, its "tail"; and
//   Wt[b] is triangular (rows k <= j forward, k >= j backward) when `tri`
//   says so.  The plan (ops/banded_trisolve.py: sweep_plan) reads bw and
//   tri off the arrays, so skipping the other rows is exact for any
//   arrays; it rounds bw up to whole 16-byte rows (at most B), adding only
//   rows that are zero.  The sweep is cut into P chunks of m blocks in
//   sweep order and solved in three launches:
//     1. chunk_walk_kernel (rerun 0), one thread block per chunk, all at
//        once: g_b = f_b . Wt[b] (the triangle only) and y_b = g_b - tail .
//        WCt[b] (the carry rows only) from a zero state entering the chunk;
//        writes y (final for chunk 0), g, and the chunk's exit tail s^_c;
//     2. chunk_carry_kernel, one thread block: the state entering each
//        chunk, s_0 = 0, s_{c+1} = s^_c + s_c . T_c, with T_c (bw x bw) the
//        product of -WCt[b][carry, carry] over chunk c's blocks, made once
//        per factor;
//     3. chunk_walk_kernel (rerun 1), one thread block per chunk c >= 1:
//        the chain again from s_c over the stored g, writing y.
//   The rows of each column j are split over G row groups of threads (rows
//   k = q mod G), each summing its rows as four interleaved partial sums;
//   the groups' partials meet once per step in shared memory and are added
//   in group order.  Bounds: bytes: a sweep must read Wt's triangle and
//   WCt's carry rows once (f32, B=128, bw=100, 1M rows: 0.66 GB); this
//   design reads the carry rows twice (phases 1 and 3) and T once, ~1.07
//   GB.  Every operand is streamed into a ring of 2-4 stages in shared
//   memory, one item (a slab of rows) per stage: a whole slab (WCt's carry
//   rows, T_c) and its vector by one TMA bulk copy each, completing on the
//   stage's mbarrier; Wt's triangle by 16-byte cp.async from every thread;
//   where the layout is not 16-byte aligned, everything by cp.async one
//   element at a time.  P is about the SM count.  Serial depth: 2m + P
//   dependent steps in place of nb (m = 60, P = 131 at 1M rows on 132
//   SMs); phase 2, one block walking P steps, is the part that stays
//   serial.
//
// Nothing is cut off on either route: every step uses every carry entry,
// whatever T's size, so the result is the sequential recurrence's to
// rounding.  Every sum runs in a fixed order, with no atomics: two
// launches give equal bits, and the kernels agree with their plain twins
// to rounding.
//
// Launchers are extern "C" for ctypes: they launch on the caller's stream,
// never synchronise, allocate nothing, and return the first
// cudaGetLastError() (or kBadArgs for arguments the kernels do not take).

#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

// TMA bulk copies completing on an mbarrier (16-byte aligned layouts)
using cmt::bulk_copy;
using cmt::mbar_expect;
using cmt::mbar_init;
using cmt::mbar_wait;
using cmt::smem_addr;

constexpr int kBadArgs = -1;
constexpr int kMaxBlock = 1024;          // one thread per column j
constexpr int kSmemBudget = 225 * 1024;  // of the 227 KB a block may use
constexpr int kMaxStages = 4;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// --- cp.async of 16 bytes, or of one element (unaligned layouts)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..2) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// One stage's worth of a walk: `rows` rows of width W starting at `mat`
// (row k0 of its matrix), then `vlen` elements of `vec` stored after them.
// kind 0: rows of Wt[b] (only the triangle `tri` needs is copied);
// kind 1: carry rows of WCt[b] or of T_c.
template <typename T>
struct Item {
  const T* mat;
  const T* vec;
  int rows, k0, vlen, kind, step;
  long long b;
  bool last;
};

// Columns [c0, c1) of row k that an item copies: tri 1 needs columns >= k,
// tri 2 columns <= k, 0 all; widened to multiples of E elements.
template <int E>
__device__ __forceinline__ void row_span(int k, int W, int skip, int* c0,
                                         int* c1) {
  *c0 = skip == 1 ? k / E * E : 0;
  *c1 = skip == 2 ? min(W, (k / E + 1) * E) : W;
}

// Whether an item comes by one TMA bulk copy: a whole slab (WCt's carry
// rows, T_c's rows, a Wt[b] that is not triangular) in a 16-byte aligned
// layout.  A triangle of Wt[b] is many short row spans, which every thread
// copies 16 bytes at a time with cp.async instead: one bulk copy per span
// would be ~128 small copies from one warp.
template <typename T, int E>
__device__ __forceinline__ bool bulk_item(const Item<T>& it, int tri) {
  return E > 1 && !(it.kind == 0 && tri != 0);
}

// Copy one item into a stage: by one bulk copy of the slab and one of the
// vector, issued by thread 0 after announcing their bytes on `bar`; or by
// every thread, E elements per cp.async (these form this thread's group
// of the iteration).
template <typename T, int E>
__device__ __forceinline__ void load_item(const Item<T>& it, T* stage, int W,
                                          int tri, std::uint64_t* bar) {
  T* vs = stage + it.rows * W;
  if (bulk_item<T, E>(it, tri)) {
    if (threadIdx.x != 0) return;
    mbar_expect(bar, (it.rows * W + it.vlen) *
                         static_cast<unsigned>(sizeof(T)));
    if (it.rows) bulk_copy(stage, it.mat, it.rows * W * sizeof(T), bar);
    if (it.vlen) bulk_copy(vs, it.vec, it.vlen * sizeof(T), bar);
    return;
  }
  const int skip = it.kind == 0 ? tri : 0;
  const int cpr = W / E;
  const int total = it.rows * cpr;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    const int r = q / cpr, cc = (q - r * cpr) * E;
    int c0, c1;
    row_span<E>(it.k0 + r, W, skip, &c0, &c1);
    if (cc >= c0 && cc < c1)
      cp_async<E * sizeof(T)>(stage + r * W + cc,
                              it.mat + static_cast<long long>(r) * W + cc);
  }
  for (int q = threadIdx.x * E; q < it.vlen; q += blockDim.x * E)
    cp_async<E * sizeof(T)>(vs + q, it.vec + q);
}

// The ring: items 0..n-1 through S stages of `cap` elements; item i is
// consumed while items i+1..i+S-1 load.  Every thread commits one cp.async
// group per item (empty for a bulk item), so waiting for all but S-2
// groups finds item i's copies done; a bulk item also waits on its stage's
// mbarrier, whose phase parity `phases` tracks.  One barrier per item: it
// makes item i visible to every thread and frees the stage item i-1 held.
template <typename T, int E, class Describe, class Consume>
__device__ __forceinline__ void run_ring(int n, int S, int cap, int W,
                                         int tri, T* ring,
                                         std::uint64_t* bars,
                                         Describe describe, Consume consume) {
  if (E > 1 && threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + i);
    cmt::mbar_fence_init();
  }
  __syncthreads();
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) load_item<T, E>(describe(i), ring + i * cap, W, tri, bars + i);
    cp_commit();
  }
  unsigned phases = 0;
  for (int i = 0; i < n; ++i) {
    const Item<T> it = describe(i);
    const int st = i % S;
    cp_wait(S - 2);
    if (bulk_item<T, E>(it, tri)) {
      mbar_wait(bars + st, (phases >> st) & 1u);
      phases ^= 1u << st;
    }
    __syncthreads();
    const int nxt = i + S - 1;
    if (nxt < n)
      load_item<T, E>(describe(nxt), ring + (nxt % S) * cap, W, tri,
                      bars + nxt % S);
    cp_commit();
    consume(it, ring + st * cap);
  }
  cp_wait(0);
}

// The stages' mbarriers, after `n` elements (rounded up to 16 bytes).
template <typename T>
__device__ __forceinline__ std::uint64_t* stage_bars(T* p, int n) {
  constexpr int A = 16 / static_cast<int>(sizeof(T));
  return reinterpret_cast<std::uint64_t*>(p + (n + A - 1) / A * A);
}

// The threads of a walk: G row groups of Bc = cols rounded up to a warp;
// thread t sums column j = t % Bc over the rows k = q (mod G), q = t / Bc,
// and the groups' partial sums meet once per step in shared memory.
struct Lanes {
  int j, q, G, Bc;
};

__device__ __forceinline__ Lanes lanes_of(int cols, int G) {
  Lanes l;
  l.Bc = (cols + 31) / 32 * 32;
  l.G = G;
  l.j = threadIdx.x % l.Bc;
  l.q = threadIdx.x / l.Bc;
  return l;
}

// a += sum over the rows k in [k0, k1) with k = q (mod G) of
// v[k] * m[k * W]: four partial sums, added in a fixed order by sum4.
template <typename T>
__device__ __forceinline__ void dot_rows(T (&a)[4], const T* v, const T* m,
                                         int W, int k0, int k1,
                                         const Lanes& l) {
  int k = k0 + ((l.q - k0 % l.G) + l.G) % l.G;
  const int G = l.G;
  for (; k + 3 * G < k1; k += 4 * G) {
    a[0] = fma_t(v[k], m[k * W], a[0]);
    a[1] = fma_t(v[k + G], m[(k + G) * W], a[1]);
    a[2] = fma_t(v[k + 2 * G], m[(k + 2 * G) * W], a[2]);
    a[3] = fma_t(v[k + 3 * G], m[(k + 3 * G) * W], a[3]);
  }
  for (; k < k1; k += G) a[0] = fma_t(v[k], m[k * W], a[0]);
}

template <typename T>
__device__ __forceinline__ T sum4(T (&a)[4]) {
  const T s = (a[0] + a[1]) + (a[2] + a[3]);
  a[0] = a[1] = a[2] = a[3] = T(0);
  return s;
}

// Column j's total over the G groups' partials in red (G x Bc), in group
// order; call after a barrier that follows every group's write.
template <typename T>
__device__ __forceinline__ T group_sum(const T* red, const Lanes& l) {
  T s = red[l.j];
  for (int q = 1; q < l.G; ++q) s += red[q * l.Bc + l.j];
  return s;
}

// Phases 1 (rerun 0, chunk = blockIdx.x) and 3 (rerun 1, chunk =
// blockIdx.x + 1).  Shared memory: the ring, the bw-long tail of the last
// block, the partial sums of g and of the chain (G x Bc each), the stages'
// mbarriers.  Two barriers at a step's last item (the item's, then the
// partials'), one at every other.
template <typename T, int E>
__global__ void __launch_bounds__(kMaxBlock)
chunk_walk_kernel(const T* __restrict__ f, const T* __restrict__ wt,
                  const T* __restrict__ wct, T* __restrict__ g,
                  T* __restrict__ y, T* __restrict__ shat,
                  const T* __restrict__ s, long long nb, int B, int bw,
                  int m, int forward, int tri, int R, int S, int cap,
                  int rerun, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Lanes l = lanes_of(B, G);
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* tail = ring + static_cast<long long>(S) * cap;
  T* red_g = tail + (bw + 1) / 2 * 2;
  T* red_c = red_g + G * l.Bc;
  std::uint64_t* bars = stage_bars(red_c, G * l.Bc);
  const long long chunk = blockIdx.x + rerun;
  const long long s0 = chunk * m;
  const int steps = static_cast<int>(min(static_cast<long long>(m), nb - s0));
  const long long bb = static_cast<long long>(B) * B;
  const int r0 = forward ? B - bw : 0;   // first carry row (and column)
  const int n_w = rerun ? 0 : (B + R - 1) / R;
  const int per = n_w + (bw + R - 1) / R;
  const int j = l.j;
  const int cj = j - r0;
  const bool carry = j < B && cj >= 0 && cj < bw;
  const int lo = tri == 2 ? j : 0;       // rows of Wt[b] column j reads
  const int hi = tri == 1 ? j + 1 : B;
  for (int c = threadIdx.x; c < bw; c += blockDim.x)
    tail[c] = rerun ? s[chunk * bw + c] : T(0);

  auto describe = [&](int i) {
    Item<T> it;
    it.step = i / per;
    const int r = i - it.step * per;
    const long long sw = s0 + it.step;
    it.b = forward ? sw : nb - 1 - sw;
    it.last = r == per - 1;
    if (r < n_w) {
      it.kind = 0;
      it.k0 = r * R;
      it.rows = min(R, B - it.k0);
      it.mat = wt + it.b * bb + static_cast<long long>(it.k0) * B;
      it.vec = f + it.b * B + it.k0;
      it.vlen = it.rows;
    } else {
      it.kind = 1;
      it.k0 = (r - n_w) * R;
      it.rows = min(R, bw - it.k0);
      it.mat = wct + it.b * bb + static_cast<long long>(r0 + it.k0) * B;
      it.vec = rerun && r == 0 ? g + it.b * B : nullptr;
      it.vlen = it.vec ? B : 0;
    }
    return it;
  };

  T ga[4] = {T(0), T(0), T(0), T(0)};
  T ca[4] = {T(0), T(0), T(0), T(0)};
  T gj = T(0);
  auto consume = [&](const Item<T>& it, const T* st) {
    const T* v = st + it.rows * B;
    if (j < B) {
      if (it.kind == 0) {
        // g_b[j] over the rows of this slab that column j's triangle holds
        const int k0 = max(it.k0, lo), k1 = min(it.k0 + it.rows, hi);
        if (k0 < k1)
          dot_rows(ga, v - it.k0, st - it.k0 * B + j, B, k0, k1, l);
      } else {
        if (it.vlen && l.q == 0) gj = v[j];
        dot_rows(ca, tail, st - it.k0 * B + j, B, it.k0, it.k0 + it.rows,
                 l);
      }
    }
    if (!it.last) return;
    red_g[l.q * l.Bc + j] = sum4(ga);
    red_c[l.q * l.Bc + j] = sum4(ca);
    __syncthreads();   // every partial written, every read of tail done
    if (l.q != 0 || j >= B) return;
    if (!rerun) gj = group_sum(red_g, l);
    const T out = gj - group_sum(red_c, l);
    y[it.b * B + j] = out;
    if (!rerun && chunk > 0) g[it.b * B + j] = gj;
    if (carry) {
      tail[cj] = out;
      if (!rerun && it.step == steps - 1) shat[chunk * bw + cj] = out;
    }
  };
  run_ring<T, E>(steps * per, S, cap, B, tri, ring, bars, describe,
                 consume);
}

// Phase 2: one thread block, threads as in a walk over bw columns.
// s_0 = 0, s_{c+1} = s^_c + s_c . T_c for c = 0..P-2, written to s.
template <typename T, int E>
__global__ void __launch_bounds__(kMaxBlock)
chunk_carry_kernel(const T* __restrict__ tmat, const T* __restrict__ shat,
                   T* __restrict__ s, int P, int bw, int R, int S, int cap,
                   int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Lanes l = lanes_of(bw, G);
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* state = ring + static_cast<long long>(S) * cap;
  T* red = state + (bw + 1) / 2 * 2;
  std::uint64_t* bars = stage_bars(red, G * l.Bc);
  const int j = l.j;
  for (int c = threadIdx.x; c < bw; c += blockDim.x) {
    state[c] = T(0);
    s[c] = T(0);
  }
  const int per = (bw + R - 1) / R;
  const long long tt = static_cast<long long>(bw) * bw;

  auto describe = [&](int i) {
    Item<T> it;
    it.step = i / per;
    const int r = i - it.step * per;
    it.kind = 1;
    it.k0 = r * R;
    it.rows = min(R, bw - it.k0);
    it.mat = tmat + it.step * tt + static_cast<long long>(it.k0) * bw;
    it.vec = r == 0 ? shat + static_cast<long long>(it.step) * bw : nullptr;
    it.vlen = it.vec ? bw : 0;
    it.last = r == per - 1;
    it.b = 0;
    return it;
  };

  T a[4] = {T(0), T(0), T(0), T(0)};
  T h = T(0);
  auto consume = [&](const Item<T>& it, const T* st) {
    if (j < bw) {
      if (it.vlen && l.q == 0) h = st[it.rows * bw + j];
      dot_rows(a, state, st - it.k0 * bw + j, bw, it.k0, it.k0 + it.rows,
               l);
    }
    if (!it.last) return;
    red[l.q * l.Bc + j] = sum4(a);
    __syncthreads();   // every partial written, every read of state done
    if (l.q != 0 || j >= bw) return;
    const T out = h + group_sum(red, l);
    state[j] = out;
    s[static_cast<long long>(it.step + 1) * bw + j] = out;
  };
  run_ring<T, E>((P - 1) * per, S, cap, bw, 0, ring, bars, describe,
                 consume);
}

// Stage layout of a walk over rows of width W: R rows (a multiple of E,
// at least `need` where two stages allow) plus a vector of up to vmax, in
// S = 2..4 stages of `cap` elements; after the ring, `extra` elements and
// the stages' mbarriers.
struct Ring {
  int R, S, cap;
  size_t bytes;
};

template <typename T>
bool plan_ring(int W, int need, int vmax, int E, int extra, Ring* out) {
  const long long item = static_cast<long long>(sizeof(T));
  const int align = 16 / static_cast<int>(sizeof(T));
  auto cap_of = [&](int r) {
    return (r * W + vmax + align - 1) / align * align;
  };
  const long long tail = (extra + align - 1) / align * align * item +
                         kMaxStages * static_cast<long long>(sizeof(
                             std::uint64_t));
  int r = (need + E - 1) / E * E;
  if (r < E) r = E;
  while (r > E && 2 * cap_of(r) * item + tail > kSmemBudget) r -= E;
  const long long stage = cap_of(r) * item;
  if (2 * stage + tail > kSmemBudget) return false;
  const long long fit = (kSmemBudget - tail) / stage;
  out->R = r;
  out->S = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  out->cap = cap_of(r);
  out->bytes = static_cast<size_t>(out->S * stage + tail);
  return true;
}

template <typename T>
struct Sweep {
  const T *f, *wt, *wct, *tmat;
  T *y, *g, *shat, *s;
  long long nb;
  int B, bw, m, P, forward, tri;
};

// Row groups for a walk over `cols` columns: as many as fill 1024
// threads, at most 8.
int groups_for(int cols) {
  const int bc = (cols + 31) / 32 * 32;
  const int g = kMaxBlock / bc;
  return g < 1 ? 1 : (g > 8 ? 8 : g);
}

template <typename T, int E>
int launch_walk(const Sweep<T>& a, int rerun, cudaStream_t st) {
  Ring ring;
  const int need = a.bw > a.B ? a.bw : a.B;
  const int G = groups_for(a.B), bc = (a.B + 31) / 32 * 32;
  if (!plan_ring<T>(a.B, need, a.B, E, (a.bw + 1) / 2 * 2 + 2 * G * bc,
                    &ring))
    return kBadArgs;
  auto kern = chunk_walk_kernel<T, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ring.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(a.P - rerun), G * bc, ring.bytes, st>>>(
      a.f, a.wt, a.wct, a.g, a.y, a.shat, a.s, a.nb, a.B, a.bw, a.m,
      a.forward, a.tri, ring.R, ring.S, ring.cap, rerun, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_carry(const Sweep<T>& a, cudaStream_t st) {
  Ring ring;
  const int G = groups_for(a.bw), bc = (a.bw + 31) / 32 * 32;
  if (!plan_ring<T>(a.bw, a.bw, a.bw, E, (a.bw + 1) / 2 * 2 + G * bc,
                    &ring))
    return kBadArgs;
  auto kern = chunk_carry_kernel<T, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ring.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, G * bc, ring.bytes, st>>>(a.tmat, a.shat, a.s, a.P, a.bw, ring.R,
                                      ring.S, ring.cap, G);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The three launches of a sweep; one (phase 1) when it has a single chunk
// or no carry.  The plan rounds bw up to whole 16-byte rows, so the carry
// kernel takes one element at a time only when bw = B is not.
template <typename T>
int launch_sweep(const Sweep<T>& a, cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool v1 = a.B % V == 0 && aligned16(a.f) && aligned16(a.wt) &&
                  aligned16(a.wct) && aligned16(a.g);
  const bool v2 = a.bw % V == 0 && aligned16(a.tmat) && aligned16(a.shat);
  int rc = v1 ? launch_walk<T, V>(a, 0, st) : launch_walk<T, 1>(a, 0, st);
  if (rc != 0 || a.P == 1 || a.bw == 0) return rc;
  rc = v2 ? launch_carry<T, V>(a, st) : launch_carry<T, 1>(a, st);
  if (rc != 0) return rc;
  return v1 ? launch_walk<T, V>(a, 1, st) : launch_walk<T, 1>(a, 1, st);
}

bool bad_args(long long nb, int B, int bw, int m, int P, int tri) {
  return nb < 1 || nb > 0x7fffffffLL || B < 1 || B > kMaxBlock || bw < 0 ||
         bw > B || m < 1 || P < 1 || (nb + m - 1) / m != P || tri < 0 ||
         tri > 2;
}

template <typename T>
int sweep_typed(const void* f, const void* wt, const void* wct,
                const void* tmat, void* y, void* g, void* shat, void* s,
                long long nb, int B, int bw, int m, int P, int forward,
                int tri, cudaStream_t st) {
  Sweep<T> a{static_cast<const T*>(f), static_cast<const T*>(wt),
             static_cast<const T*>(wct), static_cast<const T*>(tmat),
             static_cast<T*>(y), static_cast<T*>(g), static_cast<T*>(shat),
             static_cast<T*>(s), nb, B, bw, m, P, forward != 0 ? 1 : 0, tri};
  return launch_sweep<T>(a, st);
}

// ---------------------------------------------------------------------------
// The diagonal-form route: one sweep over the ILU(0) factor's own
// diagonals (see the note at the top of this file).
// ---------------------------------------------------------------------------
namespace diag {

constexpr int kK = 8;           // off-diagonal offsets a triangle may have
constexpr int kThreads = 128;   // warp 0 walks; warps 1-3 stage
constexpr int kHelpers = kThreads - 32;
constexpr int kTile = 512;      // positions of a tile
constexpr int kStages = 4;      // tiles in the ring: 3 load while 1 walks
constexpr int kMaxR = 4;        // rows a lane of the walk takes a step
constexpr int kCarryCols = 128; // phase 2: columns of a pass (at most) ...
constexpr int kCarryG = 8;      // ... times row groups
constexpr int kCarryThreads = kCarryCols * kCarryG;
constexpr int kCarryRegTail = 128;   // tails whose T_c fits registers:
constexpr int kCarryM = kCarryRegTail / kCarryG;   // rows a thread
constexpr int kMaxTail = 1024;  // tb: the route's bandwidth limit
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxPolls = 1LL << 22;   // ~seconds: a carry block that
                                             // waits longer goes on with the
                                             // sentinel's NaN, which the
                                             // answer then shows

struct Offsets {
  int o[kK];   // descending, each in 1..tb
};

// mode 0: every chunk from a zero entering tail, its exit tail to shat;
// mode 1: chunks 1.. again from the tails in s;
// mode 2: the transfer matrices: chunk blockIdx.x from the unit tail
//         e_{blockIdx.y} with f = 0, its exit tail to row blockIdx.y of
//         T_c (P - 1 chunks).
template <typename T>
struct Args {
  const T* f;      // n (null in mode 2)
  const T* vals;   // (nk, n): vals[k n + i], the entry of row i at column
                   // i - o[k] (forward) or i + o[k] (backward)
  const T* diag;   // n, U's diagonal (backward; null forward: unit L)
  T* s;            // (P, tb) entering tails, row c for chunk c (phase 2
                   // writes them)
  T* y;            // n
  T* shat;         // (P, tb) exit tails
  T* tmat;         // (P - 1, tb, tb)
  T* hand;         // (P, tb): phase 2's hand-over, the sentinel between
                   // launches
  long long n;
  int nk, tb, L, forward, mode, hmask;
  int g, R, tile;   // lanes and rows a lane of a walk step; positions a
                    // tile (whole steps, at most kTile)
  Offsets off;
};

// One chunk of L positions in sweep order (row p forward, n - 1 - p
// backward).  f, the factor's values and (backward) U's diagonal stream
// through a ring of kStages tiles of kTile positions, copied by warps 1-3
// with cp.async three tiles ahead of the walk; each copier scales the
// backward rows it copied by 1 / u_ii once they land, and writes the
// previous tile's y.  The walk's values sit in a ring `hist` of hmask + 1
// >= tb + 2 kTile.  Warp 0 walks a tile in steps of g R rows, lane j
// rows j R .. j R + R - 1 of the step (g a power of two, at most 32; g R
// at most every offset but the chain's, so those terms read earlier
// steps): acc_i = f'_i - sum_k v'_k[i] y_{i - o[k]} (descending offsets);
// then, with an offset-1 chain (ONE), y_i = acc_i - v'_1[i] y_{i-1}: each
// lane composes its rows' affine maps y -> A y + B, an inclusive scan over
// the lanes (Hillis-Steele, log2 g shuffles) from the last step's last y
// gives each lane the y entering its rows, and the lane walks them.  One
// barrier a tile.
template <typename T, int NK, bool ONE>
__global__ void __launch_bounds__(kThreads)
chunk_walk_kernel(const Args<T> a) {
  constexpr int NL = ONE ? NK - 1 : NK;   // terms before the chain's
  constexpr int W = (NK + 2) * kTile;     // a stage: f, values, diagonal
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);   // kStages x W
  T* hist = stage + kStages * W;
  const int tid = threadIdx.x;
  const long long c = blockIdx.x + (a.mode == 1 ? 1 : 0);
  const long long p0 = c * a.L;
  const int len = static_cast<int>(min(static_cast<long long>(a.L),
                                       a.n - p0));
  const int ntiles = (len + a.tile - 1) / a.tile;
  const bool writes_y =
      a.mode == 1 || (a.mode == 0 && (c == 0 || a.tb == 0));
  for (int k = tid; k < a.tb; k += kThreads) {
    T v = T(0);
    if (a.mode == 1)
      v = a.s[c * a.tb + k];
    else if (a.mode == 2 && k == static_cast<int>(blockIdx.y))
      v = T(1);
    hist[(k - a.tb) & a.hmask] = v;
  }
  auto row_of = [&](int q) {
    const long long p = p0 + q;
    return a.forward ? p : a.n - 1 - p;
  };

  // warps 1-3: copier h handles positions h, h + kHelpers, ... of a tile
  const int h = tid - 32;
  auto fetch = [&](int t) {
    if (t < ntiles) {
      T* b = stage + (t % kStages) * W;
      const int q0 = t * a.tile, cnt = min(a.tile, len - q0);
      for (int i = h; i < cnt; i += kHelpers) {
        const long long row = row_of(q0 + i);
        if (a.f)
          cp_async<sizeof(T)>(b + i, a.f + row);
        else
          b[i] = T(0);
#pragma unroll
        for (int k = 0; k < NK; ++k)
          cp_async<sizeof(T)>(b + (1 + k) * kTile + i, a.vals + k * a.n + row);
        if (!a.forward)
          cp_async<sizeof(T)>(b + (NK + 1) * kTile + i, a.diag + row);
      }
    }
    cp_commit();
  };
  auto scale = [&](int t) {   // backward: rows by 1 / u_ii, once landed
    if (a.forward || t >= ntiles) return;
    T* b = stage + (t % kStages) * W;
    const int cnt = min(a.tile, len - t * a.tile);
    for (int i = h; i < cnt; i += kHelpers) {
      const T r = T(1) / b[(NK + 1) * kTile + i];
#pragma unroll
      for (int k = 0; k <= NK; ++k) b[k * kTile + i] *= r;
    }
  };
  auto write_y = [&](int t, int first, int step) {
    if (!writes_y) return;
    const int q0 = t * a.tile, cnt = min(a.tile, len - q0);
    for (int i = first; i < cnt; i += step)
      a.y[row_of(q0 + i)] = hist[(q0 + i) & a.hmask];
  };

  if (tid >= 32) {
    for (int t = 0; t < kStages - 1; ++t) fetch(t);
    cp_wait(kStages - 2);
    scale(0);
  }
  __syncthreads();
  T prev = hist[-1 & a.hmask];   // y at position -1 (the chain's)
  for (int t = 0; t < ntiles; ++t) {
    if (tid < 32) {
      const T* b = stage + (t % kStages) * W;
      const int q0 = t * a.tile, cnt = min(a.tile, len - q0);
      for (int r0 = 0; r0 < cnt; r0 += a.g * a.R) {
        const int rows = min(a.g * a.R, cnt - r0);
        const int first = r0 + tid * a.R;   // this lane's first row
        // acc: row r's terms before the chain's; (pa, pb): the map from the
        // y entering the lane to row r's y, so the rows apply at once
        T acc[kMaxR], pa[kMaxR], pb[kMaxR];
        T A = T(1), B = T(0);               // the lane's map
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          const int i = first + r;
          if (r >= a.R || i >= r0 + rows) break;
          const int q = q0 + i;
          T v = b[i];
#pragma unroll
          for (int k = 0; k < NL; ++k)
            v = fma_t(-b[(1 + k) * kTile + i],
                      hist[(q - a.off.o[k]) & a.hmask], v);
          acc[r] = v;
          if constexpr (ONE) {
            const T am = -b[NK * kTile + i];
            B = fma_t(am, B, v);
            A *= am;
            pa[r] = A;
            pb[r] = B;
          }
        }
        T in = prev;   // y entering this lane's rows
        if constexpr (ONE) {
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            if (d >= a.g) break;
            const T Ap = __shfl_up_sync(kFull, A, d);
            const T Bp = __shfl_up_sync(kFull, B, d);
            if (tid >= d) {
              B = fma_t(A, Bp, B);
              A *= Ap;
            }
          }
          const T out = fma_t(A, prev, B);   // y at the lane's last row
          const T up = __shfl_up_sync(kFull, out, 1);
          if (tid > 0) in = up;
          prev = __shfl_sync(kFull, out, (rows - 1) / a.R);
        }
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          const int i = first + r;
          if (r >= a.R || i >= r0 + rows) break;
          T y = acc[r];
          if constexpr (ONE) y = fma_t(pa[r], in, pb[r]);
          hist[(q0 + i) & a.hmask] = y;
        }
        __syncwarp();
      }
    } else {
      if (t > 0) write_y(t - 1, h, kHelpers);
      cp_wait(kStages - 3);
      scale(t + 1);
      fetch(t + kStages - 1);
    }
    __syncthreads();
  }
  cp_wait(0);
  if (ntiles > 0) write_y(ntiles - 1, tid, kThreads);
  if (a.mode == 0) {
    for (int k = tid; k < a.tb; k += kThreads)
      a.shat[c * a.tb + k] = hist[(len - a.tb + k) & a.hmask];
  } else if (a.mode == 2) {
    T* row = a.tmat + (c * a.tb + blockIdx.y) * a.tb;
    for (int k = tid; k < a.tb; k += kThreads)
      row[k] = hist[(len - a.tb + k) & a.hmask];
  }
}

// Phase 2's hand-over: each value of s_c travels alone, through a slot
// that holds a NaN no arithmetic makes (the sentinel) between launches.
__device__ __forceinline__ bool is_sentinel(double v) {
  return __double_as_longlong(v) == 0x7ff4dead0badbeefLL;
}
__device__ __forceinline__ bool is_sentinel(float v) {
  return __float_as_int(v) == 0x7fa0beef;
}
__device__ __forceinline__ void sentinel(double* v) {
  *v = __longlong_as_double(0x7ff4dead0badbeefLL);
}
__device__ __forceinline__ void sentinel(float* v) {
  *v = __int_as_float(0x7fa0beef);
}
__device__ __forceinline__ double load_relaxed(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];\n"
               : "=d"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ float load_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n"
               : "=f"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_relaxed(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.f64 [%0], %1;\n" ::"l"(p), "d"(v)
               : "memory");
}
__device__ __forceinline__ void store_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;\n" ::"l"(p), "f"(v)
               : "memory");
}

// Phase 2: block c of P - 1, all resident at once (a cooperative launch),
// makes s_{c+1} = s^_c + s_c . T_c.  Thread (j, q) of a block of kCarryG
// row groups of `cols` columns (the tail in whole warps, at most
// kCarryCols) sums column j over the rows k = q mod kCarryG: it loads those
// entries of T_c once, into registers where tb <= kCarryRegTail (M rows a
// thread, M > 0), else it reads them from T_c in global memory (M = 0), so
// a step reads no more than s_c.  Each block loads its T_c and s^_c while
// the chain runs, then reads s_c from block c - 1's hand-over slots (s_0 =
// 0), each thread polling its values until they are not the sentinel and
// putting the sentinel back; sums its rows as four interleaved partial
// sums; adds the groups' partials by a tree (q + 4, + 2, + 1, in that
// order); and writes s_{c+1} for phase 3 and, but in the last block, into
// its own slots.  Each value is one aligned word, so no fence orders the
// hand-over.
template <typename T, int M>
__global__ void __launch_bounds__(kCarryThreads)
chunk_carry_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = a.tb;
  const long long c = blockIdx.x;
  const int cols = blockDim.x / kCarryG;    // the tail in warps, at most
                                            // kCarryCols
  const int j = threadIdx.x % cols, q = threadIdx.x / cols;
  T* sv = reinterpret_cast<T*>(smem_raw);   // s_c
  T* red = sv + kMaxTail;                   // kCarryG x cols partials
  const T* tg = a.tmat + c * tb * tb;
  T treg[M > 0 ? M : 1];
  if constexpr (M > 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = q + m * kCarryG;
      treg[m] = j < tb && k < tb ? tg[k * tb + j] : T(0);
    }
  }
  for (int j0 = 0; j0 < tb; j0 += cols) {
    const int jj = j0 + j;
    const T hat = jj < tb && q == 0 ? a.shat[c * tb + jj] : T(0);
    if (j0 == 0) {
      for (int k = threadIdx.x; k < tb; k += blockDim.x) {
        T v = T(0);
        if (c > 0) {
          T* slot = a.hand + c * tb + k;
          long long polls = 0;
          do {
            v = load_relaxed(slot);
          } while (is_sentinel(v) && ++polls < kMaxPolls);
          T z;
          sentinel(&z);
          store_relaxed(slot, z);
        }
        sv[k] = v;
      }
      __syncthreads();
    }
    T acc[4] = {T(0), T(0), T(0), T(0)};
    if constexpr (M > 0) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int k = q + m * kCarryG;
        if (k < tb) acc[m & 3] = fma_t(sv[k], treg[m], acc[m & 3]);
      }
    } else if (jj < tb) {
      for (int k = q, m = 0; k < tb; k += kCarryG, ++m)
        acc[m & 3] = fma_t(sv[k], tg[static_cast<long long>(k) * tb + jj],
                           acc[m & 3]);
    }
    T* r = red + q * cols + j;
    *r = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    for (int half = kCarryG / 2; half > 0; half /= 2) {
      __syncthreads();
      if (q < half) *r += r[half * cols];
    }
    if (q == 0 && jj < tb) {
      const T out = hat + *r;
      a.s[(c + 1) * tb + jj] = out;
      if (c + 1 < gridDim.x) store_relaxed(a.hand + (c + 1) * tb + jj, out);
    }
    __syncthreads();
  }
}

// Phase 2's launch: T_c in registers where the tail fits kCarryRegTail.
template <typename T>
int launch_carry(const Args<T>& a, int P, cudaStream_t st) {
  const size_t bytes =
      (kMaxTail + static_cast<size_t>(kCarryG) * kCarryCols) * sizeof(T);
  void* kern = a.tb <= kCarryRegTail
                   ? reinterpret_cast<void*>(chunk_carry_kernel<T, kCarryM>)
                   : reinterpret_cast<void*>(chunk_carry_kernel<T, 0>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args<T> args = a;
  void* params[] = {&args};
  int cols = (a.tb + 31) / 32 * 32;
  cols = cols < kCarryCols ? cols : kCarryCols;
  err = cudaLaunchCooperativeKernel(kern, dim3(static_cast<unsigned>(P - 1)),
                                    dim3(static_cast<unsigned>(cols * kCarryG)),
                                    params, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NK, bool ONE>
int launch_walk_nk(const Args<T>& a, unsigned gx, unsigned gy,
                   cudaStream_t st) {
  const size_t bytes =
      (kStages * (NK + 2) * kTile + static_cast<size_t>(a.hmask) + 1) *
      sizeof(T);
  auto kern = chunk_walk_kernel<T, NK, ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(gx, gy), kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NK>
int launch_walk_k(const Args<T>& a, unsigned gx, unsigned gy,
                  cudaStream_t st) {
  if constexpr (NK > 0) {
    if (a.off.o[NK - 1] == 1) return launch_walk_nk<T, NK, true>(a, gx, gy, st);
  }
  return launch_walk_nk<T, NK, false>(a, gx, gy, st);
}

template <typename T>
int launch_walk(const Args<T>& a, unsigned gx, unsigned gy,
                cudaStream_t st) {
  switch (a.nk) {
    case 0: return launch_walk_k<T, 0>(a, gx, gy, st);
    case 1: return launch_walk_k<T, 1>(a, gx, gy, st);
    case 2: return launch_walk_k<T, 2>(a, gx, gy, st);
    case 3: return launch_walk_k<T, 3>(a, gx, gy, st);
    case 4: return launch_walk_k<T, 4>(a, gx, gy, st);
    case 5: return launch_walk_k<T, 5>(a, gx, gy, st);
    case 6: return launch_walk_k<T, 6>(a, gx, gy, st);
    case 7: return launch_walk_k<T, 7>(a, gx, gy, st);
    case 8: return launch_walk_k<T, 8>(a, gx, gy, st);
    default: return kBadArgs;
  }
}

bool bad_args(long long n, int nk, const int* offs, int tb, int L, int P,
              int forward, const void* diag) {
  if (n < 1 || nk < 0 || nk > kK || tb < 0 || tb > kMaxTail || L < 1 ||
      P < 1 || (n + L - 1) / L != P || (forward == 0 && diag == nullptr))
    return true;
  for (int k = 0; k < nk; ++k)
    if (offs[k] < 1 || offs[k] > tb || (k > 0 && offs[k] >= offs[k - 1]))
      return true;
  return false;
}

template <typename T>
Args<T> args_of(const void* f, const void* vals, const void* dg,
                const void* tmat, void* y, void* shat, void* s, void* hand,
                long long n, int nk, const int* offs, int tb, int L,
                int forward) {
  Args<T> a{static_cast<const T*>(f), static_cast<const T*>(vals),
            static_cast<const T*>(dg), static_cast<T*>(s),
            static_cast<T*>(y), static_cast<T*>(shat),
            static_cast<T*>(const_cast<void*>(tmat)), static_cast<T*>(hand),
            n, nk, tb, L,
            forward != 0 ? 1 : 0, 0, 0, 32, 1, kTile, {}};
  int H = 1;
  while (H < tb + 2 * kTile) H *= 2;
  a.hmask = H - 1;
  // a walk step: g lanes (a power of two, at most 32) of R rows, g R at
  // most every offset but the chain's; a tile whole steps
  const int nl = nk > 0 && offs[nk - 1] == 1 ? nk - 1 : nk;
  const int shortest = nl > 0 ? offs[nl - 1] : 32 * kMaxR;
  while (a.g > shortest) a.g /= 2;
  a.R = shortest / a.g < kMaxR ? shortest / a.g : kMaxR;
  a.tile = kTile / (a.g * a.R) * (a.g * a.R);
  for (int k = 0; k < kK; ++k) a.off.o[k] = k < nk ? offs[k] : 0;
  return a;
}

// The three launches of a sweep; one where there is a single chunk or no
// tail to carry.
template <typename T>
int sweep(Args<T> a, int P, cudaStream_t st) {
  a.mode = 0;
  int rc = launch_walk(a, static_cast<unsigned>(P), 1, st);
  if (rc != 0 || P == 1 || a.tb == 0) return rc;
  rc = launch_carry(a, P, st);
  if (rc != 0) return rc;
  a.mode = 1;
  return launch_walk(a, static_cast<unsigned>(P - 1), 1, st);
}

template <typename T>
int transfer(Args<T> a, int P, cudaStream_t st) {
  if (P == 1 || a.tb == 0) return 0;
  a.mode = 2;
  a.f = nullptr;
  return launch_walk(a, static_cast<unsigned>(P - 1),
                     static_cast<unsigned>(a.tb), st);
}

}  // namespace diag

}  // namespace

extern "C" {

// B4b. Replaces _banded_sweep / _sweep_kernel (pallas_trisolve.py:73, :46);
// twice, B4a (_fused_msolve / _fused_kernel, :149, :110).
// dtype: 0 = float32, 1 = float64.  f, y: nb*B; wt, wct: (nb, B, B);
// tmat: (P, bw, bw); scratch g: nb*B, shat and s: P*bw.  y must not alias
// f.  m blocks per chunk, P = ceil(nb / m) chunks; tri: 0 full Wt, 1 rows
// k <= j, 2 rows k >= j.
int cmt_banded_sweep(int dtype, const void* f, const void* wt,
                     const void* wct, const void* tmat, void* y, void* g,
                     void* shat, void* s, long long nb, int block, int bw,
                     int m, int chunks, int forward, int tri, void* stream) {
  if (bad_args(nb, block, bw, m, chunks, tri)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sweep_typed<float>(f, wt, wct, tmat, y, g, shat, s, nb, block, bw,
                              m, chunks, forward, tri, st);
  if (dtype == 1)
    return sweep_typed<double>(f, wt, wct, tmat, y, g, shat, s, nb, block,
                               bw, m, chunks, forward, tri, st);
  return kBadArgs;
}

// B4b of the diagonal-form route; twice, B4a.  dtype: 0 = float32,
// 1 = float64.  f, y: n (y must not alias f); vals: (nk, n), the factor's
// values by offset; offs: nk distances, descending, host memory; diag: n,
// U's diagonal (backward only, else null); tmat: (chunks - 1, tb, tb);
// scratch shat and s: chunks * tb; hand: chunks * tb, every element the
// sentinel NaN (0x7ff4dead0badbeef / 0x7fa0beef; so again after the
// sweep).  rows positions a chunk, chunks = ceil(n / rows);
// chunks - 1 blocks of phase 2 must fit on the card at once.
int cmt_diag_sweep(int dtype, const void* f, const void* vals,
                   const void* dg, const void* tmat, void* y, void* shat,
                   void* s, void* hand, long long n, int nk, const int* offs,
                   int tb, int rows, int chunks, int forward, void* stream) {
  if (diag::bad_args(n, nk, offs, tb, rows, chunks, forward, dg))
    return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return diag::sweep(diag::args_of<float>(f, vals, dg, tmat, y, shat, s,
                                            hand, n, nk, offs, tb, rows,
                                            forward),
                       chunks, st);
  if (dtype == 1)
    return diag::sweep(diag::args_of<double>(f, vals, dg, tmat, y, shat, s,
                                             hand, n, nk, offs, tb, rows,
                                             forward),
                       chunks, st);
  return kBadArgs;
}

// The transfer matrices T_c (c < chunks - 1) of one sweep into tmat, row k
// of T_c the exit tail of chunk c from the unit tail e_k with f = 0; in
// the arrays' dtype (the route makes them in float64).
int cmt_diag_transfer(int dtype, const void* vals, const void* dg,
                      void* tmat, long long n, int nk, const int* offs,
                      int tb, int rows, int chunks, int forward,
                      void* stream) {
  if (diag::bad_args(n, nk, offs, tb, rows, chunks, forward, dg))
    return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return diag::transfer(
        diag::args_of<float>(nullptr, vals, dg, tmat, nullptr, nullptr,
                             nullptr, nullptr, n, nk, offs, tb, rows,
                             forward),
        chunks, st);
  if (dtype == 1)
    return diag::transfer(
        diag::args_of<double>(nullptr, vals, dg, tmat, nullptr, nullptr,
                              nullptr, nullptr, n, nk, offs, tb, rows,
                              forward),
        chunks, st);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
