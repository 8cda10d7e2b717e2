"""Constant-coefficient grid stencils in the gap-strided block-halo layout.

Counterpart of :mod:`cuda_mat_tpu.ops.pallas_stencil` (its const-stencil
half), in three parts:

- **Host algebra** (numpy, copied from the JAX module so that both packages
  choose identical layouts): stencil detection, the gap-strided layout,
  Neumann-series polynomial expansion and the fused-layout planner.
- **Kernel front ends**: :func:`const_stencil_spmv_padded` (kernel B1),
  :func:`const_series_msolve_padded` (kernel B2),
  :func:`const_series_msolve_fma_padded` (kernel B5, B2 behind the loop's
  BLAS1 update) and :func:`const_stencil_spmv_dots_padded` (kernel B6, B1
  with dot products in its epilogue and their sum in the same launch), each
  beside its plain PyTorch twin
  (``*_plain``).  B1, B2 and B5 also take a batch ``(S, L)`` of the padded
  vectors of S row shards, shard i's base ``base + i·npad``, in one launch
  (the distributed solver's kernel engines); a batched twin equals S calls
  of the one-vector twin bit for bit.  A front end sends a CPU tensor to the twin and
  a CUDA tensor to the hand-written kernel (:mod:`._kernels`), or raises; it
  never falls back.  Each keeps a plain-int ``launches`` count of kernel
  launches, so a run can show that its path went through the kernels.
- :class:`ConstStencilOperator`, the matrix-free operator over padded
  vectors.

Layout: each grid row of C cells is stored with stride S = round_up(C +
max|dc|, 128), the extra cells zero, so a stencil read that crosses a row
seam lands in a zero gap cell; the R·S strided rows are padded to ``npad``
(a multiple of ``block``) with a zero tail, and one zero pad block sits on
each side.  Padded vectors are a fixed point of every operator here, so
the whole solver iteration runs in the layout.  The sizes ``sub`` (halo
sub-block, a multiple of 1024) and ``block`` (a multiple of lcm(sub, S))
are the JAX package's, chosen for the TPU; on Hopper they only fix pad
widths.  Keeping them makes the two packages' padded vectors identical.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cuda_mat_tpu_torch.ops import _kernels


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Host algebra (numpy; identical code to cuda_mat_tpu.ops.pallas_stencil)
# ---------------------------------------------------------------------------


def msolve_halo(terms_u) -> int:
    """Extension width ``hpad`` of the fused msolve's intermediate in the
    JAX layout: max|off'_u| rounded up to 1024.  The port's kernel needs only
    max|off'_u|; this width sizes the extended gap mask, so that both
    packages hold the same arrays."""
    h_u = max((abs(t[0]) for t in terms_u), default=0)
    return _round_up(max(h_u, 1), 1024)


def extend_gapmask(gapmask: np.ndarray, hpad: int) -> np.ndarray:
    """Periodic extension of the per-block gapmask to
    [−hpad, block + hpad) — block % stride == 0 makes the mask block-periodic,
    so wrapping is exact.  Built once at preconditioner setup (host)."""
    gm = np.asarray(gapmask)
    block = gm.shape[0]
    assert hpad <= block
    return np.concatenate([gm[block - hpad:], gm, gm[:hpad]])


def detect_const_stencil(dia, dc_max: int = 8, dr_max: int = 8):
    """Detect constant-coefficient 2-D grid-stencil structure in a DIA matrix.

    Returns ``(c_grid, terms)`` with ``terms = ((off, dc, scal), ...)`` when
    the matrix is exactly ``A[(gi,gj),(gi+dr,gj+dc)] = scal_k`` on an R×C
    grid (entries whose neighbor leaves the grid are zero), else ``None``.
    Candidates for C are the |offsets| > dc_max (an offset too large to be a
    within-row step must be a row step); the grid interpretation is verified
    exactly against the stored diagonal data, so a successful detection is a
    proof, not a heuristic.
    """
    if dia.n != dia.m or dia.ndiag == 0:
        return None
    n = dia.n
    offs = [int(o) for o in dia.offsets]
    cands = sorted({abs(o) for o in offs if abs(o) > dc_max}, reverse=True)
    if cands:
        # cheap short-circuit before the exact O(ndiag*n) verification: every
        # diagonal of a constant stencil has at most two distinct values
        # (the scalar + boundary zeros) — a strided sample proves most
        # non-stencil matrices are not candidates in O(ndiag * n/step)
        step = max(1, n // 4096)
        for d in range(len(offs)):
            if np.unique(dia.data[d, ::step]).size > 2:
                return None
    idx = np.arange(n, dtype=np.int64)
    for c in cands:
        if n % c or n // c < 2:
            continue
        gj = idx % c
        terms = []
        ok = True
        for d, off in enumerate(offs):
            dr = int(np.rint(off / c))
            dc = off - dr * c
            if abs(dc) > dc_max or abs(dr) > dr_max:
                ok = False
                break
            data = dia.data[d]
            valid = (gj + dc >= 0) & (gj + dc < c)
            # row-direction validity: i + off in [0, n) is already implied by
            # row-aligned DIA construction (out-of-range slots are 0) — but
            # those zero slots must not break the constant check, so restrict
            # to in-range rows as well
            lo, hi = max(0, -off), min(n, n - off)
            valid = valid & (idx >= lo) & (idx < hi)
            vals = data[valid]
            if vals.size == 0 or np.any(vals != vals[0]) \
                    or np.any(data[~valid] != 0):
                ok = False
                break
            terms.append((off, dc, float(vals[0])))
        if ok:
            return c, tuple(terms)
    return None


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


def stencil_layout(c_grid: int, n: int, terms,
                   block_target: int = 262144, min_sub: int = 0):
    """Choose the gap-strided layout (stride, sub, block, np_true, npad) for
    a grid with row length C.  Constraints: stride >= C + max|dc| (seam reads
    land in zero gap cells) and a multiple of 128; sub >= max strided offset
    and a multiple of 1024; block a multiple of both sub and stride
    (per-block-identical gap mask).

    ``min_sub``: widen the halo sub-block so operators with larger offsets
    (e.g. a fused Neumann-series stencil, max offset ~(k-1)*stride) share the
    layout."""
    dcmax = max((abs(t[1]) for t in terms), default=0)
    stride = _round_up(c_grid + dcmax, 128)
    r = n // c_grid
    np_true = r * stride
    if np_true >= 2 ** 31:
        # the JAX kernel's tail-mask iota compares in int32
        raise ValueError(f"strided dimension {np_true} overflows the int32"
                         " tail mask of the shared layout")
    # strided offsets: off' = dr*stride + dc
    soffs = [((t[0] - t[1]) // c_grid) * stride + t[1] for t in terms]
    sub = _round_up(max(max(abs(o) for o in soffs), min_sub, 1), 1024)
    base = _lcm(sub, stride)
    if base > (1 << 19):
        raise ValueError(
            f"stencil layout base block {base} exceeds the layout budget"
            f" (C={c_grid})")
    m = max(1, min(block_target // base, -(-np_true // base)))
    block = base * m
    npad = _round_up(np_true, block)
    return stride, sub, block, np_true, npad, tuple(
        (so, float(t[2])) for so, t in zip(soffs, terms))


def const_factor_terms(dia, c_grid: int, stride: int):
    """Deep-interior constant-stencil approximation of a banded matrix on an
    R×C grid: sample each diagonal at a row where every offset is in-range
    (grid center) and return ``(terms, strided_terms)`` in the formats of
    :class:`ConstStencilOperator` (``(off, dc, scal)`` / ``(off', scal)``).

    Used for ILU(0) Neumann factors of constant stencils, whose diagonals
    converge geometrically to interior fixed points away from the boundary
    (the approximation perturbs only a boundary layer of the
    *preconditioner*)."""
    n = dia.n
    r = n // c_grid
    assert n % c_grid == 0
    i0 = (r // 2) * c_grid + c_grid // 2
    terms = []
    sterms = []
    for k, off in enumerate(int(o) for o in dia.offsets):
        dr = int(np.rint(off / c_grid))
        dc = off - dr * c_grid
        if abs(dc) > stride - c_grid and dc != 0:
            raise ValueError(f"offset {off}: |dc|={abs(dc)} exceeds the gap"
                             f" width {stride - c_grid}")
        if not (0 <= i0 + off < n and 0 <= (i0 % c_grid) + dc < c_grid):
            raise ValueError(f"offset {off} has no interior sample row on an"
                             f" {r}x{c_grid} grid")
        scal = float(dia.data[k, i0])
        terms.append((off, dc, scal))
        sterms.append((dr * stride + dc, scal))
    return tuple(terms), tuple(sterms)


def neumann_poly_terms(terms, k: int, c_grid: int, stride: int):
    """Expand the truncated Neumann series ``P = Σ_{j<k} (−N)^j`` of a
    constant-stencil ``N`` into a single constant stencil.

    Stencil composition is polynomial multiplication over (dr, dc) offsets:
    ``(N²)`` terms are all pairwise offset sums with coefficient products.
    On the gap-strided layout the composition is *exact* as long as every
    accumulated ``|dc| <= stride − c_grid``: a within-row offset that leaves
    the true columns lands in a zero gap cell, which is precisely the value
    the sequential application would have read after its gap re-masking
    (and row offsets beyond the grid land in the zero pad/tail).  One kernel
    launch then applies the whole series.

    ``terms``: ((off, dc, scal), ...) of N.  Returns the same format for P,
    or raises ValueError when an accumulated |dc| exceeds the gap width.
    """
    gap = stride - c_grid
    acc = {(0, 0): 1.0}                      # I
    power = {(t[0], t[1]): t[2] for t in terms}   # N^1 keyed by (off, dc)
    cur = dict(power)
    for j in range(1, k):
        sign = -1.0 if j % 2 else 1.0
        for (off, dc), v in cur.items():
            acc[(off, dc)] = acc.get((off, dc), 0.0) + sign * v
        if j + 1 < k:
            nxt = {}
            for (o1, d1), v1 in cur.items():
                for (o2, d2), v2 in power.items():
                    key = (o1 + o2, d1 + d2)
                    nxt[key] = nxt.get(key, 0.0) + v1 * v2
            cur = nxt
    out = []
    for (off, dc), v in sorted(acc.items()):
        if abs(dc) > gap and dc != 0:
            raise ValueError(
                f"series term dc={dc} exceeds the gap width {gap}"
                f" (stride {stride}, C {c_grid}); apply the series"
                " term-by-term instead")
        if v != 0.0:
            out.append((off, dc, float(v)))
    return tuple(out)


def compose_stencil_terms(ta, tb, c_grid: int, stride: int):
    """Product stencil ``C = A·B`` of two constant stencils (polynomial
    multiplication over (dr, dc) offsets) — exact on the gap-strided layout
    while every accumulated ``|dc| <= stride − c_grid`` (see
    :func:`neumann_poly_terms` for why).  Raises ValueError past the gap."""
    gap = stride - c_grid
    out = {}
    for (o1, d1, v1) in ta:
        for (o2, d2, v2) in tb:
            k = (o1 + o2, d1 + d2)
            out[k] = out.get(k, 0.0) + v1 * v2
    res = []
    for (off, dc), v in sorted(out.items()):
        if abs(dc) > gap and dc != 0:
            raise ValueError(f"composed term dc={dc} exceeds the gap width"
                             f" {gap} (stride {stride}, C {c_grid})")
        if v != 0.0:
            res.append((off, dc, float(v)))
    return tuple(res)


def restride_dia(dia, c_grid: int, stride: int):
    """Re-index an n = R·C banded matrix into the gap-strided coordinates
    (n' = R·S): entry (i, j) moves to (i', j') with i' = (i//C)·S + i%C.
    Gap rows and columns are structurally zero, so the result is banded
    again, with offsets dr·C + dc mapped to dr·S + dc.

    Builds the exact Neumann factor operators (N_l, N_u) that compose with a
    :class:`ConstStencilOperator`'s padded vectors: the DIA data's zero
    slots mask the gaps and the tail, so a plain banded DIA operator over
    the restrided matrix keeps the padding a fixed point."""
    from cuda_mat_tpu_torch.formats.dia import DIAMatrix

    n = dia.n
    assert n % c_grid == 0
    r = n // c_grid
    np_true = r * stride
    offs = [int(o) for o in dia.offsets]
    new_offs = []
    for off in offs:
        dr = int(np.rint(off / c_grid))
        dc = off - dr * c_grid
        if abs(dc) > stride - c_grid and dc != 0:
            raise ValueError(f"offset {off}: |dc|={abs(dc)} exceeds the gap"
                             f" width {stride - c_grid}")
        new_offs.append(dr * stride + dc)
    order = np.argsort(new_offs)
    data = np.zeros((dia.ndiag, np_true), dtype=dia.data.dtype)
    idx = np.arange(n, dtype=np.int64)
    pos = (idx // c_grid) * stride + (idx % c_grid)
    for k, d in enumerate(order):
        data[k, pos] = dia.data[d]
    return DIAMatrix(np_true, np_true,
                     np.asarray([new_offs[d] for d in order], np.int32),
                     data, dia.nnz)


def strided_offsets(terms, c_grid: int, stride: int):
    """((off', scal), ...) for :func:`const_stencil_spmv_padded` from
    true-coordinate ``(off, dc, scal)`` terms."""
    return tuple((((t[0] - t[1]) // c_grid) * stride + t[1], float(t[2]))
                 for t in terms)


# The JAX package sizes ``block`` from its TPU kernels' on-chip working set
# (an nterms-term stencil holds about nterms + 6 block-sized buffers, the
# fused msolve MSOLVE_EXTRA_BUFS more).  The port keeps the same constants so
# that plan_const_neumann_layout returns the same layout in both packages.
_VMEM_BUDGET = 12 << 20


def stencil_vmem_block_cap(nterms: int, itemsize: int = 4) -> int:
    """Largest block of the JAX layout plan for an ``nterms``-term stencil."""
    return _VMEM_BUDGET // (itemsize * (nterms + 6))


MSOLVE_EXTRA_BUFS = 4        # const_series_msolve_padded
FMA3_MSOLVE_EXTRA_BUFS = 9   # fma variant, 3 input streams + p output


def plan_const_neumann_layout(terms, k: int, c_grid: int, stride: int,
                              prefer_mono: bool = False,
                              fuse_kernel: bool = True,
                              fuse_blas1: bool = False):
    """Symbolically expand the Neumann-series pattern on A's own offsets
    (ILU(0) factors share A's sparsity) and return
    ``(min_sub, block_target, terms_upper_bound)`` such that the fused
    series — plus the mono composition when ``prefer_mono`` and it fits the
    gap — obey the halo constraint and the layout's block cap.  Returns None
    when the series cannot fuse at all (|dc| past the gap at the
    per-triangle level).

    ``fuse_kernel``: additionally size the layout for the one-launch fused
    msolve kernel (:func:`const_series_msolve_padded`): the halo sub-block
    must cover ``max|off_l| + hpad`` (the P_l window of the extended u
    region).  ``fuse_blas1``: size for the BLAS1-prologue variant's larger
    working set."""
    lower = tuple((o, d, 1.0) for (o, d, _) in terms if o < 0)
    upper = tuple((o, d, 1.0) for (o, d, _) in terms if o > 0)
    if not lower or not upper:
        return None
    try:
        pl = neumann_poly_terms(lower, k, c_grid, stride)
        pu = neumann_poly_terms(upper, k, c_grid, stride)
    except ValueError:
        return None
    nmax = max(len(pl), len(pu), len(terms))
    if prefer_mono:
        try:
            nmax = max(nmax,
                       len(compose_stencil_terms(pu, pl, c_grid, stride)))
        except ValueError:
            pass  # mono exceeds the gap; per-triangle series still fuses
    soffs_l = [((t[0] - t[1]) // c_grid) * stride + t[1] for t in pl]
    soffs_u = [((t[0] - t[1]) // c_grid) * stride + t[1] for t in pu]
    min_sub = max(abs(o) for o in soffs_l + soffs_u)
    if fuse_kernel:
        hpad = msolve_halo(tuple((o, 1.0) for o in soffs_u))
        min_sub = max(min_sub, max(abs(o) for o in soffs_l) + hpad)
        extra = FMA3_MSOLVE_EXTRA_BUFS if fuse_blas1 else MSOLVE_EXTRA_BUFS
        nmax = max(nmax, len(pl) + len(pu) + extra)
    return min_sub, stencil_vmem_block_cap(nmax), nmax


# ---------------------------------------------------------------------------
# Kernel front ends and their plain twins
# ---------------------------------------------------------------------------


def _coef(scal: float, dtype: torch.dtype) -> float:
    """``scal`` rounded to ``dtype`` (the JAX kernels' jnp.asarray(scal,
    dtype)); the kernels round the same way, so twin and kernel multiply by
    the same value."""
    return torch.tensor(scal, dtype=dtype).item()


def _check_layout(x_pad: torch.Tensor, block: int, sub: int, terms,
                  batch: bool = False) -> int:
    if x_pad.dim() != 1 and not (batch and x_pad.dim() == 2):
        shapes = "1-D, or (S, L) for S shards" if batch else "1-D"
        raise ValueError(f"padded vectors are {shapes}, got shape"
                         f" {tuple(x_pad.shape)}")
    npad = x_pad.shape[-1] - 2 * block
    if npad < 0 or npad % block or block % sub:
        raise ValueError(f"length {x_pad.shape[-1]} does not fit block"
                         f" {block} / sub {sub}")
    if not terms or max(abs(t[0]) for t in terms) > sub:
        raise ValueError("stencil offsets must be non-empty and within the"
                         " halo sub-block")
    return npad


def _global_rows(x_pad: torch.Tensor, block: int, base: int, q0: int,
                 n: int) -> torch.Tensor:
    """Global strided rows of the local rows ``[q0, q0 + n)``: ``(n,)`` for
    one padded vector, ``(S, n)`` for a batch (shard i's base ``base +
    i·npad``)."""
    q = torch.arange(q0, q0 + n, device=x_pad.device) + base
    if x_pad.dim() == 1:
        return q
    npad = x_pad.shape[-1] - 2 * block
    return q + npad * torch.arange(x_pad.shape[0],
                                   device=x_pad.device)[:, None]


def _zero_outside(v: torch.Tensor, rows: torch.Tensor, hi: int,
                  lo=None) -> torch.Tensor:
    """``v`` with +0 where ``rows`` lies outside ``[lo, hi)`` (no lower
    bound without ``lo``): the JAX kernels' ``where(mask, v, zeros)``."""
    keep = rows < hi if lo is None else (rows >= lo) & (rows < hi)
    return torch.where(keep, v, torch.zeros_like(v))


def _gap_rows(v: torch.Tensor, gapmask: torch.Tensor) -> torch.Tensor:
    """``v`` (``(..., m·block)``, starting at a block's first row) times
    the gap mask of each of its rows."""
    block = gapmask.shape[0]
    return (v.reshape(*v.shape[:-1], -1, block) * gapmask).reshape(v.shape)


def const_stencil_spmv_padded_plain(x_pad: torch.Tensor,
                                    gapmask: torch.Tensor, terms,
                                    np_true: int, block: int, sub: int,
                                    base: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of kernel B1, in the JAX kernel's op order:
    ``acc = Σ_k c_k·x[j + off'_k]`` left to right, times the gap mask, with
    the pad blocks and global strided rows ``>= np_true`` written as 0.
    ``x_pad``: one padded vector, or a batch ``(S, L)``."""
    npad = x_pad.shape[-1] - 2 * block
    acc = None
    for off, scal in terms:
        term = _coef(scal, x_pad.dtype) * x_pad[..., block + off:
                                                block + off + npad]
        acc = term if acc is None else acc + term
    acc = _gap_rows(acc, gapmask)
    last = base + (x_pad.shape[0] - 1) * npad if x_pad.dim() == 2 else base
    if last + npad > np_true:   # a tail inside the (last) shard
        acc = _zero_outside(acc, _global_rows(x_pad, block, base, 0, npad),
                            np_true)
    y = torch.zeros_like(x_pad)
    y[..., block:block + npad] = acc
    return y



def const_stencil_spmv_padded(x_pad: torch.Tensor, gapmask: torch.Tensor,
                              terms, np_true: int, block: int, sub: int,
                              base: int = 0) -> torch.Tensor:
    """``y_pad = A x_pad`` for a constant-coefficient grid stencil on
    gap-strided block-halo padded vectors (counterpart of
    ``cuda_mat_tpu.ops.pallas_stencil.const_stencil_spmv_padded``).

    ``terms``: (strided offset, scalar) pairs; ``gapmask``: (block,) 0/1;
    ``np_true``: R·S global strided length; ``base``: global strided row of
    ``x_pad[block]`` (0 on one device).  ``x_pad`` may be a batch ``(S,
    L)`` of S shards' padded vectors, shard i's base ``base + i·npad``: one
    launch for all.  CPU tensors run the plain twin, CUDA tensors kernel
    B1."""
    _check_layout(x_pad, block, sub, terms, batch=True)
    if tuple(gapmask.shape) != (block,):
        raise ValueError(f"gapmask must have shape ({block},)")
    if x_pad.device.type == "cpu":
        return const_stencil_spmv_padded_plain(x_pad, gapmask, terms,
                                               np_true, block, sub, base)
    y = _kernels.const_stencil_spmv(x_pad, gapmask, terms, np_true, block,
                                    base)
    const_stencil_spmv_padded.launches += 1
    return y


const_stencil_spmv_padded.launches = 0


def const_series_msolve_padded_plain(x_pad: torch.Tensor,
                                     inv_d_pad: torch.Tensor,
                                     gapmask_ext: torch.Tensor, terms_l,
                                     terms_u, np_true: int, block: int,
                                     sub: int, base: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of kernel B2, in the JAX kernel's op order
    (``_msolve_series_interior``, cuda_mat_tpu/ops/pallas_stencil.py:474):
    ``u = (Σ_k c_k·x[q + off'_k])·gap·inv_d`` over the rows P_u
    reads, ``[−h_u, npad + h_u)``, pad blocks included, zeroed where the
    global row ``base + q`` lies outside ``[0, np_true)``; then ``y =
    P_u u`` through :func:`const_stencil_spmv_padded_plain`.  At ``base =
    0`` this is the JAX "series" mode, u zero in the pad blocks; on a
    shard past the first, the rows before it are the neighbour's, its x
    (the halo) and inv_d in the pad block.  ``x_pad``: one padded vector,
    or a batch ``(S, L)``."""
    hpad = (gapmask_ext.shape[0] - block) // 2
    gap = gapmask_ext[hpad:hpad + block]
    npad = x_pad.shape[-1] - 2 * block
    h_l = max(abs(t[0]) for t in terms_l)
    # u's rows that P_u reads (none past the pad blocks: a layout with
    # h_l + h_u > block leaves the rest 0, as the pad blocks were)
    e = min(max(abs(t[0]) for t in terms_u), max(block - h_l, 0))
    lo = block - e
    acc = None
    for off, scal in terms_l:
        term = _coef(scal, x_pad.dtype) * x_pad[..., lo + off:
                                                lo + off + npad + 2 * e]
        acc = term if acc is None else acc + term
    g = gap[torch.arange(-e, npad + e, device=gap.device) % block]
    u = acc * g * inv_d_pad[..., lo:lo + npad + 2 * e]
    u = _zero_outside(u, _global_rows(x_pad, block, base, -e, npad + 2 * e),
                      np_true, 0)
    u_pad = torch.zeros_like(x_pad)
    u_pad[..., lo:lo + npad + 2 * e] = u
    return const_stencil_spmv_padded_plain(u_pad, gap, terms_u, np_true,
                                           block, sub, base)


def const_series_msolve_padded(x_pad: torch.Tensor, inv_d_pad: torch.Tensor,
                               gapmask_ext: torch.Tensor, terms_l, terms_u,
                               np_true: int, block: int, sub: int,
                               base: int = 0) -> torch.Tensor:
    """One-launch fused Neumann-series msolve
    ``y = P_u · (inv_d ∘ (P_l x))`` on gap-strided block-halo padded vectors
    (counterpart of ``cuda_mat_tpu.ops.pallas_stencil.
    const_series_msolve_padded``).

    ``terms_l``/``terms_u``: (strided offset, scalar) pairs of the two
    series polynomials; ``inv_d_pad``: 1/diag(U) in the same layout;
    ``gapmask_ext``: the (block + 2·hpad,) mask of :func:`extend_gapmask`;
    ``base``: as in :func:`const_stencil_spmv_padded`, and ``x_pad`` (with
    ``inv_d_pad``) may be a batch ``(S, L)`` likewise.  CPU tensors run the
    plain twin, CUDA tensors kernel B2."""
    _check_layout(x_pad, block, sub, terms_l, batch=True)
    _check_layout(x_pad, block, sub, terms_u, batch=True)
    if inv_d_pad.shape != x_pad.shape:
        raise ValueError("inv_d_pad must match x_pad's shape")
    hpad = (gapmask_ext.shape[0] - block) // 2
    if gapmask_ext.dim() != 1 or gapmask_ext.shape[0] != block + 2 * hpad \
            or hpad < 0:
        raise ValueError("gapmask_ext must have shape (block + 2*hpad,)")
    if x_pad.device.type == "cpu":
        return const_series_msolve_padded_plain(
            x_pad, inv_d_pad, gapmask_ext, terms_l, terms_u, np_true, block,
            sub, base)
    y = _kernels.const_series_msolve(x_pad, inv_d_pad, gapmask_ext, terms_l,
                                     terms_u, np_true, block, base)
    const_series_msolve_padded.launches += 1
    return y


const_series_msolve_padded.launches = 0


def spmv_dots_partials_plain(y_pad: torch.Tensor, ws, with_self: bool,
                             block: int) -> torch.Tensor:
    """Kernel B6's partials of ``<w, y>`` (each weight in ``ws``) and, with
    ``with_self``, ``<y, y>``, as a (len / DOTS_BLOCK, n_dots) array: each
    product cut into rows of DOTS_BLOCK and summed within each row by the
    halving tree ``v[:, :h] + v[:, h:]`` (h = DOTS_BLOCK / 2, ..., 1); the
    pad blocks' rows 0, as y is there.  They depend on nothing but the
    vectors: not on the card or on the kernel's launch geometry."""
    prods = [w * y_pad for w in ws] + ([y_pad * y_pad] if with_self else [])
    parts = []
    for v in prods:
        v = v.view(-1, _kernels.DOTS_BLOCK)
        while v.shape[1] > 1:
            h = v.shape[1] // 2
            v = v[:, :h] + v[:, h:]
        parts.append(v)
    p = torch.cat(parts, dim=1)
    pad = block // _kernels.DOTS_BLOCK
    p[:pad] = 0
    p[p.shape[0] - pad:] = 0
    return p


def dots_sum_plain(partials: torch.Tensor) -> torch.Tensor:
    """Kernel B6's sum of its partials, column by column, in the kernel's
    order: sum t of DOTS_BLOCK takes rows t, t + DOTS_BLOCK, ... one after
    another (0 where there is none), then the DOTS_BLOCK sums go through
    the halving tree."""
    b = _kernels.DOTS_BLOCK
    g = partials.shape[0]
    acc = partials.new_zeros((b, partials.shape[1]))
    acc[:min(g, b)] = partials[:b]
    for r in range(b, g, b):
        k = min(b, g - r)
        acc[:k] = acc[:k] + partials[r:r + k]
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return acc[0]


def const_stencil_spmv_dots_padded_plain(x_pad: torch.Tensor,
                                         gapmask: torch.Tensor, ws, terms,
                                         np_true: int, block: int, sub: int,
                                         with_self: bool = False,
                                         base: int = 0):
    """Plain PyTorch twin of kernel B6: B1's twin for y, then
    :func:`spmv_dots_partials_plain` summed by :func:`dots_sum_plain`."""
    y = const_stencil_spmv_padded_plain(x_pad, gapmask, terms, np_true,
                                        block, sub, base)
    return y, dots_sum_plain(spmv_dots_partials_plain(y, ws, with_self,
                                                      block))


def const_stencil_spmv_dots_padded(x_pad: torch.Tensor, gapmask: torch.Tensor,
                                   ws, terms, np_true: int, block: int,
                                   sub: int, with_self: bool = False,
                                   base: int = 0):
    """``(y_pad, dots)`` with ``y_pad = A x_pad`` (the values of
    :func:`const_stencil_spmv_padded`) and ``dots = (<w, y>, [<y, y>])``
    for the one weight vector in ``ws`` (or none), the second when
    ``with_self`` (counterpart of ``cuda_mat_tpu.ops.pallas_stencil.
    const_stencil_spmv_dots_padded``, whose loop passes one weight): the
    dots are taken in the kernel's epilogue as partials of 256 rows and
    summed in the same launch.  Pads and gaps of y and of padded weights
    are zero, so the partials are the true-coordinate dots.  CPU tensors
    run the plain twin, CUDA tensors kernel B6."""
    _check_layout(x_pad, block, sub, terms)
    ws = tuple(ws)
    if len(ws) > 1 or not (ws or with_self):
        raise ValueError("one weight vector at most, and at least one dot")
    if tuple(gapmask.shape) != (block,) or any(w.shape != x_pad.shape
                                               for w in ws):
        raise ValueError(f"gapmask must have shape ({block},) and the"
                         " weight x_pad's shape")
    if x_pad.device.type == "cpu":
        return const_stencil_spmv_dots_padded_plain(
            x_pad, gapmask, ws, terms, np_true, block, sub, with_self, base)
    out = _kernels.const_stencil_spmv_dots(x_pad, gapmask, ws, terms, np_true,
                                           block, base, with_self)
    const_stencil_spmv_dots_padded.launches += 1
    return out


const_stencil_spmv_dots_padded.launches = 0


def fma_combine(a, c1, b, c2=None, c=None):
    """``a + c1·(b + c2·c)``, or ``a + c1·b`` without ``c``: kernel B5's
    prologue, one rounding per operation in this order."""
    return a + c1 * b if c is None else a + c1 * (b + c2 * c)


def const_series_msolve_fma_padded_plain(a_pad, c1, b_pad, c2, c_pad,
                                         inv_d_pad, gapmask_ext, terms_l,
                                         terms_u, np_true: int, block: int,
                                         sub: int, base: int = 0):
    """Plain PyTorch twin of kernel B5: the combination over the whole
    vectors, B2's twin on it, and p returned with zero pad blocks (the JAX
    kernel writes its pad blocks as 0, pallas_stencil.py:596-599; the
    halos in the inputs' pad blocks reach y only)."""
    p = fma_combine(a_pad, c1, b_pad, c2, c_pad)
    y = const_series_msolve_padded_plain(
        p, inv_d_pad, gapmask_ext, terms_l, terms_u, np_true, block, sub,
        base)
    p[..., :block] = 0
    p[..., p.shape[-1] - block:] = 0
    return p, y


def const_series_msolve_fma_padded(a_pad: torch.Tensor, c1,
                                   b_pad: torch.Tensor, c2=None, c_pad=None,
                                   inv_d_pad=None,
                                   gapmask_ext=None, terms_l=None,
                                   terms_u=None, np_true: int = 0,
                                   block: int = 0, sub: int = 0,
                                   base: int = 0):
    """BLAS1-prologue fused msolve (counterpart of ``cuda_mat_tpu.ops.
    pallas_stencil.const_series_msolve_fma_padded``), one launch, two
    outputs::

        p = a + c1·(b + c2·c)          (or a + c1·b when c_pad is None)
        y = P_u · (inv_d ∘ (P_l p))

    returning ``(p_pad, y_pad)``.  ``c1``/``c2``: scalars, as 0-d tensors
    on the vectors' device (the loop's β, −α, −ω), which the kernel reads
    on the device; a Python number is uploaded first.  Same layout as
    :func:`const_series_msolve_padded`, a batch ``(S, L)`` too.  CPU
    tensors run the plain twin, CUDA tensors kernel B5."""
    _check_layout(a_pad, block, sub, terms_l, batch=True)
    _check_layout(a_pad, block, sub, terms_u, batch=True)
    vecs = [b_pad, inv_d_pad] + ([] if c_pad is None else [c_pad])
    if any(v.shape != a_pad.shape for v in vecs):
        raise ValueError("b_pad, c_pad and inv_d_pad must match a_pad's shape")
    hpad = (gapmask_ext.shape[0] - block) // 2
    if gapmask_ext.dim() != 1 or gapmask_ext.shape[0] != block + 2 * hpad \
            or hpad < 0:
        raise ValueError("gapmask_ext must have shape (block + 2*hpad,)")
    if a_pad.device.type == "cpu":
        return const_series_msolve_fma_padded_plain(
            a_pad, c1, b_pad, c2, c_pad, inv_d_pad, gapmask_ext, terms_l,
            terms_u, np_true, block, sub, base)

    def on_device(s):
        return torch.as_tensor(s, dtype=a_pad.dtype, device=a_pad.device)

    out = _kernels.const_series_msolve_fma(
        a_pad, on_device(c1), b_pad, None if c_pad is None else on_device(c2),
        c_pad, inv_d_pad, gapmask_ext, terms_l, terms_u, np_true, block, base)
    const_series_msolve_fma_padded.launches += 1
    return out


const_series_msolve_fma_padded.launches = 0


def reset_launch_counts() -> None:
    """Set the four kernels' launch counts to 0."""
    const_stencil_spmv_padded.launches = 0
    const_series_msolve_padded.launches = 0
    const_stencil_spmv_dots_padded.launches = 0
    const_series_msolve_fma_padded.launches = 0


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstStencilOperator:
    """Matrix-free operator for a constant-coefficient grid stencil over
    gap-strided block-halo padded vectors on ``device`` (counterpart of
    ``cuda_mat_tpu.ops.pallas_stencil.ConstStencilOperator``).

    Factor operators built to compose with this one (the Neumann series
    N_l/N_u) share its layout through ``dataclasses.replace`` with other
    terms."""

    gapmask: torch.Tensor      # [block] 0/1, zeroes gap cells
    terms: Tuple[Tuple[int, int, float], ...]  # true-coord (off, dc, scal)
    strided_terms: Tuple[Tuple[int, float], ...]  # (off', scal)
    c_grid: int                # grid row length C
    stride: int                # strided row length S >= C
    n: int                     # true dimension (R*C)
    np_true: int               # strided dimension (R*S)
    npad: int                  # block-padded strided dimension
    block: int
    sub: int                   # halo sub-block
    vec_dtype: torch.dtype
    device: torch.device

    @property
    def m(self) -> int:
        return self.n

    @property
    def r(self) -> int:
        return self.n // self.c_grid

    @property
    def nnz(self) -> int:
        """Nonzeros of the matrix the stencil stands for (terms whose
        neighbour leaves the grid count none), as the JAX operator's
        (cuda_mat_tpu/ops/pallas_stencil.py:884)."""
        nz = 0
        for off, dc, _ in self.terms:
            lo, hi = max(0, -off), min(self.n, self.n - off)
            cnt = hi - lo
            if dc:
                gj = np.arange(lo, hi, dtype=np.int64) % self.c_grid
                cnt = int(np.count_nonzero((gj + dc >= 0)
                                           & (gj + dc < self.c_grid)))
            nz += cnt
        return nz

    @classmethod
    def from_dia(cls, dia, dtype=torch.float32, device="cuda",
                 block_target: int = 262144, min_sub: int = 0
                 ) -> "ConstStencilOperator":
        det = detect_const_stencil(dia)
        if det is None:
            raise ValueError(
                "matrix is not a constant-coefficient grid stencil")
        c_grid, terms = det
        stride, sub, block, np_true, npad, sterms = stencil_layout(
            c_grid, dia.n, terms, block_target, min_sub)
        device = torch.device(device)
        gap = torch.zeros(block, dtype=dtype)
        gap.view(block // stride, stride)[:, :c_grid] = 1.0
        return cls(gap.to(device), terms, sterms, c_grid, stride, dia.n,
                   np_true, npad, block, sub, dtype, device)

    def pad_vec(self, v) -> torch.Tensor:
        """True-coordinate vector (length n, host or device) → padded
        vector on ``device``."""
        v2 = torch.as_tensor(v).to(self.vec_dtype).reshape(self.r,
                                                           self.c_grid)
        out = torch.zeros(self.npad + 2 * self.block, dtype=self.vec_dtype,
                          device=self.device)
        out[self.block:self.block + self.np_true].view(
            self.r, self.stride)[:, :self.c_grid] = v2.to(self.device)
        return out

    def unpad_vec(self, v_pad: torch.Tensor) -> torch.Tensor:
        g = v_pad[self.block:self.block + self.np_true].view(self.r,
                                                             self.stride)
        return g[:, :self.c_grid].reshape(-1)

    def matvec(self, x_pad: torch.Tensor) -> torch.Tensor:
        return const_stencil_spmv_padded(x_pad, self.gapmask,
                                         self.strided_terms, self.np_true,
                                         self.block, self.sub)

    def matvec_dots(self, x_pad: torch.Tensor, ws, with_self: bool = False):
        """``(A x, (<w, Ax> for w in ws) [+ <Ax, Ax>])`` in one launch —
        see :func:`const_stencil_spmv_dots_padded`."""
        return const_stencil_spmv_dots_padded(
            x_pad, self.gapmask, ws, self.strided_terms, self.np_true,
            self.block, self.sub, with_self)
