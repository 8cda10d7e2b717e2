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
// each output tile from nine neighbouring tile views in VMEM.  Here the
// kernel is bound by device memory: x read once and y written once, plus
// one (rp, cp) grid per variable coefficient.  The parent design (one
// thread per cell of the padded grid, each x element fetched by three
// thread blocks through L2, 4-byte accesses, the ring's cells running the
// full guard) reached 25-35% of that bound.  What this design does (the
// geometry is the wrapper's, ops/_kernels.py: stencil2d_plan):
//   * x comes from device memory once.  Each thread block takes a strip of
//     `width` columns and marches down (or, every other run, up) a run of
//     rows, keeping the 2 hr + 1 rows a row needs (hr = max|dr| of the
//     actual terms, 1 for the 5-point Laplacian) and `hc` columns on each
//     side of its strip in a ring of `stages` rows in shared memory; each
//     new row is loaded once, ahead of use.  Runs march in opposite
//     directions, so the 2 hr rows two neighbouring runs share are loaded
//     by both at about the same time and the second load hits L2.  A term
//     that reaches past the ring (only where the ring would not fit shared
//     memory) reads x from device memory.
//   * The coefficient grids stream beside x, in a ring of their own: the
//     load that brings x's row i + hr (down the march) also brings the row
//     of each grid for output row i.  A coefficient row is read by one
//     step only, so that ring holds only the rows loading ahead and the
//     step's own (stages - 2 hr), not x's halo.  At 3163^2 with five
//     variable terms in f64 a load is 5/6 coefficient rows: a ring that
//     gave them x's depth held two blocks an SM and took 0.32 ms on an
//     H100, this one holds three and takes 0.25 (the bound: 0.227).
//   * A step computes `step_rows` rows, 8 cells a thread, so that the
//     step's fixed costs (its barrier waits, one __syncthreads, the terms'
//     reads from shared memory) are shared by 8 cells; where that ring
//     would leave fewer than two blocks on an SM, and with variable
//     coefficients, a step computes one row.
//   * 16-byte accesses: where rows and tile columns are whole 16-byte words
//     (vec > 1), a stage comes by TMA bulk copies completing on its
//     mbarrier, and each computed row goes through a staging row in shared
//     memory to y as 16-byte words.  Otherwise threads copy and store one
//     element at a time.
//   * Only the computed region [0, r_eff) x [0, cw) is marched (with the
//     mask, the cells past (r, c)); everything else, the zero tile ring
//     included, is written as zeros without loading x or running the terms,
//     a part after each step, between the march's loads.
//   * Conflict-free shared-memory reads (thread t computes columns t + 256u
//     of the strip), terms held in shared memory and read a term ahead, and
//     32-bit indices (the wrapper bounds the grid).
// Products and sums use the _rn intrinsics, in term order, with the
// coefficients rounded to T on the host, so the kernel equals its plain
// PyTorch twin bit for bit.
//
// The launcher is extern "C" for ctypes: it launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError() (or
// kBadArgs for arguments the kernel does not take).

#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

using cmt::add_rn;
using cmt::mul_rn;

constexpr int kMaxTerms = 64;
constexpr int kBadArgs = -1;
constexpr int kThreads = 256;
constexpr int kMaxPer = 4;   // columns of a strip per thread (width <= 1024)

template <typename T>
struct Terms2D {
  int n;
  int dr[kMaxTerms];
  int dc[kMaxTerms];
  int var[kMaxTerms];  // index into the coefficient stack, -1 for a scalar
  T c[kMaxTerms];
};

struct Geometry {
  int cols, tr, tc, rp, cp;  // the padded grid has rp + 2 tr rows of cols
  int r_eff, c_eff, cw;      // computed rows, unmasked and computed columns
  int vec;                   // elements per copy and store (1 or 16 bytes)
  int width, strips, rows;   // a block's strip of columns and run of rows
  int hr, hc;                // the ring's row and column halos
  int stages, slot;          // ring stages and elements of x's stage
  int step_rows;             // rows a step computes: 1 or 8 / P
  int n_var;                 // coefficient grids
};

// P: columns of the strip per thread, a compile-time constant so that each
// term's P reads issue back to back.  Thread t computes columns t + 256u
// (u < P) of its strip; past the strip's end it reads shared memory that
// launch_pr allocates for that (256 P elements after the barriers) and
// stores nothing.
template <typename T, int P, int R>
__global__ void __launch_bounds__(kThreads, 4)
stencil2d_kernel(const T* __restrict__ x, const T* __restrict__ coeffs,
                 T* __restrict__ y, const __grid_constant__ Terms2D<T> t,
                 const Geometry g) {
  using V = typename cmt::Vec16<T>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the terms, one past the last read ahead of its use
  __shared__ int4 s_term[kMaxTerms + 1];   // (dr, dc, var, -)
  __shared__ T s_c[kMaxTerms + 1];
  T* ring = reinterpret_cast<T*>(smem_raw);
  // the coefficient ring: stages - 2 hr stages of n_var rows of the strip
  const int cst = g.stages - 2 * g.hr;
  const int cslot = g.n_var * g.width;
  T* cring = ring + g.stages * g.slot;
  T* staged = cring + cst * cslot;   // two steps' rows of output
  std::uint64_t* bars =
      reinterpret_cast<std::uint64_t*>(staged + 2 * R * g.width);
  const int tid = threadIdx.x;
  const bool bulk = g.vec > 1;
  const int cols = g.cols;
  const int n = t.n;
  if (tid <= n) {
    s_term[tid] = tid < n ? make_int4(t.dr[tid], t.dc[tid], t.var[tid], 0)
                          : make_int4(0, 0, -1, 0);
    s_c[tid] = tid < n ? t.c[tid] : T(0);
  }

  // this block's strip [j0, j0 + ws) and run of output rows [i0, i1)
  const int j0 = (blockIdx.x % g.strips) * g.width;
  const int ws = min(g.width, g.cw - j0);
  const int i0 = (blockIdx.x / g.strips) * g.rows;
  const int i1 = min(g.r_eff, i0 + g.rows);
  const int hr = g.hr, hc = g.hc, stages = g.stages;
  const int xl = ws + 2 * hc;   // of x's stage this strip fills xl
  // Loads run down the rows (even runs) or up them (odd runs), so that the
  // runs above and below load the rows they share at about the same time
  // and the second load finds them in L2.  Step m computes output row
  // first_out + dir * m; load k brings x's row anchor + dir * k, in slot
  // (tr + row) % stages, and from k = 2 hr on the grids' rows of output
  // row first_out + dir * (k - 2 hr), in slot (k - 2 hr) % cst of theirs,
  // on the same barrier.
  const int steps = i1 - i0;
  const int nst = steps + 2 * hr;
  const int dir = (blockIdx.x / g.strips) & 1 ? -1 : 1;
  const int anchor = dir > 0 ? i0 - hr : i1 - 1 + hr;
  const int first_out = dir > 0 ? i0 : i1 - 1;
  const long long grid_len = static_cast<long long>(g.rp) * g.cp;
  auto issue = [&](int k) {
    const int row = g.tr + anchor + dir * k;   // a row of the padded grid
    const int s = row % stages;
    T* dst = ring + s * g.slot;
    const T* src = x + row * cols + g.tc + j0 - hc;
    const int oi = first_out + dir * (k - 2 * hr);
    const int nv = k >= 2 * hr ? g.n_var : 0;
    T* cdst = cring + (k >= 2 * hr ? (k - 2 * hr) % cst : 0) * cslot;
    if (bulk) {
      const unsigned xb = static_cast<unsigned>(xl * sizeof(T));
      const unsigned cb = static_cast<unsigned>(ws * sizeof(T));
      cmt::mbar_expect(bars + s, xb + nv * cb);
      cmt::bulk_copy(dst, src, xb, bars + s);
      for (int v = 0; v < nv; ++v)
        cmt::bulk_copy(cdst + v * g.width,
                       coeffs + v * grid_len + oi * g.cp + j0, cb, bars + s);
    } else {
      for (int e = tid; e < xl; e += kThreads) dst[e] = src[e];
      for (int v = 0; v < nv; ++v)
        for (int e = tid; e < ws; e += kThreads)
          cdst[v * g.width + e] = coeffs[v * grid_len + oi * g.cp + j0 + e];
    }
  };
  if (bulk && tid == 0) {
    for (int s = 0; s < stages; ++s) cmt::mbar_init(bars + s);
    cmt::mbar_fence_init();
  }
  if (!bulk || tid == 0)
    for (int k = 0; k < min(stages, nst); ++k) issue(k);

  // This block's share [z0, z1) of the zeros outside the computed region
  // [tr, tr + r_eff) x [tc, tc + cw), in units of vec elements (the top and
  // bottom rows whole, then the left and right parts of each computed row),
  // written a part at each step, between the march's loads.
  const int n_top = g.tr * cols / g.vec;
  const int bot = (g.tr + g.r_eff) * cols / g.vec;
  const int n_flat = n_top + (g.rp + 2 * g.tr) * cols / g.vec - bot;
  const int per_row = (cols - g.cw) / g.vec;
  const int n_zero = n_flat + g.r_eff * per_row;
  const int z0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  n_zero / gridDim.x);
  const int z1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  n_zero / gridDim.x);
  const int z_step = (z1 - z0 + steps - 1) / steps;
  auto zeros = [&](int u0, int u1) {
    for (int u = u0 + tid; u < u1; u += kThreads) {
      int e;
      if (u < n_flat) {
        e = (u < n_top ? u : u - n_top + bot) * g.vec;
      } else {
        const int w = u - n_flat;
        const int row = w / per_row;
        const int o = (w - row * per_row) * g.vec;
        e = (g.tr + row) * cols + (o < g.tc ? o : o + g.cw);
      }
      if (bulk)
        *reinterpret_cast<V*>(y + e) = cmt::zero16<T>();
      else
        y[e] = T(0);
    }
  };
  __syncthreads();   // the barriers, the terms (and unaligned stages) ready

  // term q's P values coef * x at row i: x from the ring (or, past it,
  // from device memory), a variable coefficient from the grids' rows crow
  auto term = [&](int4 tq, T cq, int cs, int i, const T* crow, T (&v)[P]) {
    const int dr = tq.x, dc = tq.y, var = tq.z;
    if (dr <= hr && dr >= -hr && dc <= hc && dc >= -hc) {
      int s = cs + dr;
      s += s < 0 ? stages : 0;
      s -= s >= stages ? stages : 0;
      const T* xr = ring + s * g.slot + hc + dc + tid;
#pragma unroll
      for (int u = 0; u < P; ++u) v[u] = xr[u * kThreads];
    } else {
      const T* xr = x + (g.tr + i + dr) * cols + g.tc + j0 + dc + tid;
#pragma unroll
      for (int u = 0; u < P; ++u)
        v[u] = tid + u * kThreads < ws ? __ldg(xr + u * kThreads) : T(0);
    }
    if (var >= 0) {
      const T* cv = crow + var * g.width + tid;
#pragma unroll
      for (int u = 0; u < P; ++u) v[u] = mul_rn(cv[u * kThreads], v[u]);
    } else {
#pragma unroll
      for (int u = 0; u < P; ++u) v[u] = mul_rn(cq, v[u]);
    }
  };

  int ready = 0;   // loads this thread has seen complete
  int ready_slot = (g.tr + anchor) % stages;   // the slot of load `ready`
  for (int k = 0; k < steps; k += R) {
    const int nr = min(R, steps - k);   // rows of this step
    if (bulk)
      for (; ready < k + nr + 2 * hr; ++ready) {
        cmt::mbar_wait(bars + ready_slot, (ready / stages) & 1);
        ready_slot += dir;
        ready_slot += ready_slot < 0 ? stages : 0;
        ready_slot -= ready_slot >= stages ? stages : 0;
      }
    // the step's rows i[r] = first_out + dir * (k + r), the last repeated
    // past nr; x's row i[r] in slot cs[r], the grids' rows of row i[r]
    // (which came with x's row i[r] + dir * hr) at crow[r]
    const int cc0 = k % cst;
    int i[R], cs[R];
    const T* crow[R];
    const int c0 = (g.tr + first_out + dir * k) % stages;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rr = min(r, nr - 1);
      i[r] = first_out + dir * (k + rr);
      int c = c0 + dir * rr;
      c += c < 0 ? stages : 0;
      c -= c >= stages ? stages : 0;
      cs[r] = c;
      const int cc = cc0 + rr;
      crow[r] = cring + (cc >= cst ? cc - cst : cc) * cslot;
    }
    T acc[R][P];
#pragma unroll
    for (int r = 0; r < R; ++r)
      term(s_term[0], s_c[0], cs[r], i[r], crow[r], acc[r]);
    int4 tq = s_term[1];
    T cq = s_c[1];
    for (int q = 1; q < n; ++q) {
      const int4 tn = s_term[q + 1];
      const T cn = s_c[q + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T v[P];
        term(tq, cq, cs[r], i[r], crow[r], v);
#pragma unroll
        for (int u = 0; u < P; ++u) acc[r][u] = add_rn(acc[r][u], v[u]);
      }
      tq = tn;
      cq = cn;
    }
    T* out = staged + ((k / R) & 1) * R * g.width;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int e = tid + u * kThreads;
        if (e < ws) out[r * g.width + e] = j0 + e < g.c_eff ? acc[r][u] : T(0);
      }
    // every read of loads k .. k + nr - 1 (x's rows behind the march) and
    // every write of `out` done: their slots take loads k + stages ..
    __syncthreads();
    if (!bulk || tid == 0)
      for (int r = 0; r < nr && k + r + stages < nst; ++r)
        issue(k + r + stages);
    for (int r = 0; r < nr; ++r) {
      T* dst = y + (g.tr + i[r]) * cols + g.tc + j0;
      const T* src = out + r * g.width;
      if (bulk) {
        const V* ov = reinterpret_cast<const V*>(src);
        V* dv = reinterpret_cast<V*>(dst);
        for (int v = tid; v < ws / g.vec; v += kThreads) dv[v] = ov[v];
      } else {
        for (int e = tid; e < ws; e += kThreads) dst[e] = src[e];
      }
    }
    zeros(min(z1, z0 + k * z_step), min(z1, z0 + (k + nr) * z_step));
  }
}

template <typename T, int P, int R>
int launch_pr(const void* x, const void* coeffs, void* y,
              const Terms2D<T>& t, const Geometry& g, int ctas,
              cudaStream_t stream) {
  static size_t allowed = 0;
  // a step's loads stay put until its rows are done, and threads that copy
  // a stage themselves (vec 1) fill it a step before its first reader
  if (g.stages < 2 * g.hr + 2 * R) return kBadArgs;
  // x's ring, the coefficients' ring, two steps' output rows, the
  // barriers, and 256 P elements that threads past a strip's end read
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(g.stages) * g.slot +
                   static_cast<size_t>(g.stages - 2 * g.hr) * g.n_var *
                       g.width +
                   2 * R * g.width + P * kThreads) +
      sizeof(std::uint64_t) * g.stages;
  if (smem > 48 * 1024 && smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        stencil2d_kernel<T, P, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  stencil2d_kernel<T, P, R><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(coeffs),
      static_cast<T*>(y), t, g);
  return static_cast<int>(cudaGetLastError());
}

// P columns a thread, and one row a step or 8 / P (8 cells a thread).
template <typename T, int P>
int launch_p(const void* x, const void* coeffs, void* y, const Terms2D<T>& t,
             const Geometry& g, int ctas, int step_rows,
             cudaStream_t stream) {
  if (step_rows == 1)
    return launch_pr<T, P, 1>(x, coeffs, y, t, g, ctas, stream);
  if (step_rows == 8 / P)
    return launch_pr<T, P, 8 / P>(x, coeffs, y, t, g, ctas, stream);
  return kBadArgs;
}

template <typename T>
int launch(const void* x, const void* coeffs, void* y, const Terms2D<T>& t,
           const Geometry& g, int ctas, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int rows = g.rp + 2 * g.tr;
  const bool ok =
      (g.vec == 1 || (g.vec == kVec && g.cols % kVec == 0 &&
                      g.tc % kVec == 0 && g.width % kVec == 0 &&
                      g.hc % kVec == 0 && g.cw % kVec == 0)) &&
      g.width >= 1 && g.width <= kThreads * kMaxPer && g.strips >= 1 &&
      g.strips * g.width >= g.cw && g.rows >= 1 && g.hr >= 0 &&
      g.hr <= g.tr && g.hc >= 0 && g.hc <= g.tc &&
      g.slot == g.width + 2 * g.hc &&
      g.r_eff >= 1 && g.r_eff <= g.rp && g.c_eff >= 1 && g.c_eff <= g.cw &&
      g.cw <= g.cp &&
      ctas == g.strips * ((g.r_eff + g.rows - 1) / g.rows) &&
      static_cast<long long>(rows) * g.cols < (1LL << 31) &&
      static_cast<long long>(g.n_var) * g.rp * g.cp < (1LL << 31);
  if (!ok) return kBadArgs;
  if (g.width <= kThreads)
    return launch_p<T, 1>(x, coeffs, y, t, g, ctas, g.step_rows, stream);
  if (g.width <= 2 * kThreads)
    return launch_p<T, 2>(x, coeffs, y, t, g, ctas, g.step_rows, stream);
  return launch_p<T, kMaxPer>(x, coeffs, y, t, g, ctas, g.step_rows,
                              stream);
}

template <typename T>
int entry(const void* x, const void* coeffs, void* y, const int* dr,
          const int* dc, const int* var, const void* c, int nterms,
          Geometry g, int ctas, cudaStream_t s) {
  if (nterms < 1 || nterms > kMaxTerms || g.tr <= 0 || g.tc <= 0 ||
      g.rp <= 0 || g.cp <= 0 || g.rp % g.tr != 0 || g.cp % g.tc != 0)
    return kBadArgs;
  Terms2D<T> t;
  t.n = nterms;
  g.n_var = 0;
  for (int k = 0; k < nterms; ++k) {
    if (dr[k] < -g.tr || dr[k] > g.tr || dc[k] < -g.tc || dc[k] > g.tc ||
        var[k] < -1 || (var[k] >= 0 && var[k] != g.n_var))
      return kBadArgs;
    g.n_var += var[k] >= 0;
    t.dr[k] = dr[k];
    t.dc[k] = dc[k];
    t.var[k] = var[k];
    t.c[k] = static_cast<const T*>(c)[k];
  }
  if (g.n_var > 0 && coeffs == nullptr) return kBadArgs;
  g.cols = g.cp + 2 * g.tc;
  return launch<T>(x, coeffs, y, t, g, ctas, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  var[k] >= 0 names the coefficient grid
// of term k in `coeffs` ((n_var, rp, cp), in term order; may be null when
// no term has one); `c` holds the scalars in that dtype.  The geometry
// (r_eff .. ctas) is the wrapper's (ops/_kernels.py: stencil2d_plan).
int cmt_stencil2d_spmv(int dtype, const void* x, const void* coeffs, void* y,
                       const int* dr, const int* dc, const int* var,
                       const void* c, int nterms, int tr, int tc, int rp,
                       int cp, int r_eff, int c_eff, int cw, int vec,
                       int width, int strips, int rows, int step_rows,
                       int hr, int hc, int stages, int slot, int ctas,
                       void* stream) {
  Geometry g{};
  g.tr = tr;
  g.tc = tc;
  g.rp = rp;
  g.cp = cp;
  g.r_eff = r_eff;
  g.c_eff = c_eff;
  g.cw = cw;
  g.vec = vec;
  g.width = width;
  g.strips = strips;
  g.rows = rows;
  g.step_rows = step_rows;
  g.hr = hr;
  g.hc = hc;
  g.stages = stages;
  g.slot = slot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return entry<float>(x, coeffs, y, dr, dc, var, c, nterms, g, ctas, s);
  if (dtype == 1)
    return entry<double>(x, coeffs, y, dr, dc, var, c, nterms, g, ctas, s);
  return kBadArgs;
}

const char* cmt_cuda_error_string(int code) {
  if (code == kBadArgs) return "invalid kernel arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
