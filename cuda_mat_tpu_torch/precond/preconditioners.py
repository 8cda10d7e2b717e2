"""Preconditioners with an ``msolve`` method (counterpart of
:mod:`cuda_mat_tpu.precond.preconditioners`): the identity, Jacobi, exact
ILU(0) through the banded triangular solver (kernels B4a/B4b) where the
band fits one block and the generic blocked solver elsewhere, the adapter
that runs a true-n preconditioner on padded vectors, and the Neumann-series
ILU(0) — on a padded operator's layout, constant factors on the gap-strided
stencil layout (kernels B1/B2/B5) or the exact factors as banded DIA operators
(kernel B3), restrided into the stencil layout where A is a stencil; or on
true-n vectors, the exact factors as unpadded operators (``make_operator``).

For the Neumann series, with ``L = I + N_l`` (unit lower) and
``U = D(I + N_u)``, ``N_u = D⁻¹ · strict_upper``:

    L⁻¹ ≈ Σ_{j<k} (−N_l)ʲ        U⁻¹ ≈ (Σ_{j<k} (−N_u)ʲ) D⁻¹

The factors are ILU(0) or relaxed MILU(0) values computed on the host
(numpy, or the native factorizer).  The reference supports exactly one
preconditioner, ILU(0) applied by two triangular solves
(pbicgstab.cu:92-98, :356-363), and none for its other two entry points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.reorder import bandwidth
from cuda_mat_tpu_torch.native import loader as _native
from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops.banded_trisolve import BandedTriSolver
from cuda_mat_tpu_torch.ops.dia_spmv import PallasDIAOperator
from cuda_mat_tpu_torch.ops.operators import make_operator
from cuda_mat_tpu_torch.ops.stencil import (
    ConstStencilOperator, compose_stencil_terms, const_factor_terms,
    const_series_msolve_fma_padded, const_series_msolve_padded,
    extend_gapmask, fma_combine, msolve_halo, neumann_poly_terms,
    restride_dia, strided_offsets)
from cuda_mat_tpu_torch.ops.trisolve import BlockTriangularSolver
from cuda_mat_tpu_torch.reference.cpu_solvers import ilu0_factorize


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """M = I (the unpreconditioned paths, reference pbicgstab.cu:425-754)."""

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        return f


@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M = diag(A): one multiply per application.  ``inv_diag`` lies in the
    layout of the vectors it multiplies (true-n, or a padded operator's
    ``pad_vec(1 / diag)`` with zero pads)."""

    inv_diag: torch.Tensor

    @classmethod
    def from_csr(cls, csr, dtype=torch.float64, *,
                 device) -> "JacobiPreconditioner":
        d = csr.diagonal()
        if np.any(d == 0):
            raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
        return cls(torch.as_tensor(1.0 / d).to(dtype=dtype, device=device))

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * f


@dataclasses.dataclass(frozen=True)
class ILU0Preconditioner:
    """ILU(0): zero-fill incomplete factors on A's pattern, applied on
    true-n vectors by the banded triangular solver (:class:`~cuda_mat_tpu_
    torch.ops.banded_trisolve.BandedTriSolver`) or the generic blocked one
    (:class:`~cuda_mat_tpu_torch.ops.trisolve.BlockTriangularSolver`).
    Factorization happens once at setup on the host, as the reference
    times it apart (pbicgstab.cu:356-363); the native factorizer is used
    when it builds."""

    tri: object  # BandedTriSolver | BlockTriangularSolver

    @classmethod
    def from_csr(cls, csr, block: int = 256, dtype=torch.float64, *, device,
                 milu_omega: float = 0.0) -> "ILU0Preconditioner":
        """``block``: the trisolve block B; ``device``: where the block
        arrays live, and so which route the msolve takes (the kernels on a
        card, the plain twins on the CPU).  ``milu_omega``: relaxed
        modified-ILU(0) factor values (0 = reference-parity ILU(0)).

        The JAX package picks its engine by backend: the Pallas banded
        kernel on a TPU when the band fits the block, else the generic
        blocked solver.  Here the band decides on every device: the banded
        engine (kernels B4a/B4b) when the bandwidth is at most ``block``,
        else :class:`~cuda_mat_tpu_torch.ops.trisolve.BlockTriangularSolver`
        (stock torch ops, as the JAX package's XLA loop)."""
        # the block inverses are O(n·B) floats: refuse what would eat
        # gigabytes at setup (the JAX package's guard and message)
        nb = -(-csr.n // block)
        w_bytes = 2 * nb * block * block * dtype.itemsize
        if w_bytes > (2 << 30):
            raise ValueError(
                f"ILU(0) blocked trisolve would precompute {w_bytes / 2**30:.1f}"
                f" GiB of block inverses (n={csr.n}, block={block}); use"
                f" precond='jacobi', solve_refined, or the distributed"
                f" bjacobi_ilu0 for systems this large")
        engine = BandedTriSolver if bandwidth(csr) <= block \
            else BlockTriangularSolver
        return cls(engine.from_factor(csr, _factorize(csr, milu_omega),
                                      block=block, dtype=dtype,
                                      device=device))

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        return self.tri.msolve(f)


@dataclasses.dataclass(frozen=True)
class PaddedPreconditioner:
    """A true-n preconditioner run on a padded operator's vectors: unpad at
    the msolve boundary, re-pad the result with exact zeros, so the padding
    stays a fixed point of the whole iteration and the matvec keeps its
    padded layout.  Two O(n) copies per application, next to the O(n·B)
    sweep traffic.  Reference role: the L/U solves feeding csrmv at
    pbicgstab.cu:92-104."""

    inner: object    # preconditioner over true-n vectors
    op: object       # padded operator providing pad_vec / unpad_vec

    def msolve(self, f_pad: torch.Tensor) -> torch.Tensor:
        return self.op.pad_vec(self.inner.msolve(self.op.unpad_vec(f_pad)))


@dataclasses.dataclass(frozen=True)
class NeumannILUPreconditioner:
    """``msolve`` applies the truncated Neumann-series ILU(0) to a padded
    vector.  Modes (``fused``), as in the JAX package (the exact factors as
    DIA operators take the sequential mode, on kernel B3):

    - ``"mono"``: only on request (``prefer_mono``): the whole M⁻¹ ≈
      P_u·d*·P_l, the diagonal too approximated by its interior constant
      d*, composed into ONE stencil ``nl`` and applied by one launch of
      kernel B1;
    - ``"kernel"``: the whole msolve ``P_u·(inv_d ∘ P_l·x)`` in ONE launch of
      kernel B2, the intermediate kept in shared memory;
    - ``"series"``: each triangle's series expanded into one stencil
      (``nl``/``nu`` are P_l/P_u), applied by two launches of kernel B1;
    - ``False`` (sequential): ``2(k−1)`` launches of B1 (or B3) on the
      factor operators N_l/N_u.

    The first mode whose layout constraints hold is taken; the others are
    the fallbacks the JAX package itself takes.  Without a padded layout
    the sequential mode runs on true-n vectors, ``nl``/``nu`` unpadded
    operators of the exact factors."""

    nl: object             # N_l operator, P_l when fused, all of M⁻¹ (mono)
    nu: object             # N_u operator, or P_u when fused; None (mono)
    inv_d: torch.Tensor    # padded 1/diag(U); empty (mono)
    terms: int             # k (total series terms; k=1 degrades to Jacobi)
    fused: object = False  # False | "series" | "kernel" | "mono"
    gap_ext: object = None  # (block + 2·hpad,) extended gapmask ("kernel")
    fma_fits: bool = False  # kernel B5 takes the "kernel" layout

    @classmethod
    def from_csr(cls, csr, terms: int = 3, pad_like=None,
                 const_factors: bool = True, prefer_mono: bool = False,
                 milu_omega: float = 0.0, dtype=torch.float32,
                 device="cuda") -> "NeumannILUPreconditioner":
        """``pad_like``: A's padded operator — the factors are built in its
        layout, dtype and device.  On a
        :class:`~cuda_mat_tpu_torch.ops.stencil.ConstStencilOperator` with
        ``const_factors``, the factors become constant stencils (B1/B2/B5,
        and with ``prefer_mono`` the "mono" mode where it fits kernel B1);
        otherwise they are the exact factors as banded
        :class:`~cuda_mat_tpu_torch.ops.dia_spmv.PallasDIAOperator`
        operators (B3), restrided into the stencil layout where
        ``pad_like`` is one, applied in the sequential mode.  ``milu_omega``: relaxed MILU(0)
        factor values (0 = reference-parity ILU(0)).  Raises ValueError when
        the factors do not fit ``pad_like``'s layout.

        Without ``pad_like`` the factors become unpadded operators of
        ``dtype`` on ``device`` in :func:`~cuda_mat_tpu_torch.ops.operators.
        make_operator`'s format, applied in the sequential mode to true-n
        vectors (the JAX package's path off the padded layout)."""
        low, up, diag = neumann_factors(csr, milu_omega)
        if pad_like is None:
            return cls(make_operator(low, dtype=dtype, device=device),
                       make_operator(up, dtype=dtype, device=device),
                       torch.as_tensor(1.0 / diag).to(dtype=dtype,
                                                      device=device), terms)
        stencil = isinstance(pad_like, ConstStencilOperator)
        if stencil and const_factors:
            return cls._const_factors(low, up, diag, terms, pad_like,
                                      prefer_mono)
        low_d = low.to_dia(max_diags=128)
        up_d = up.to_dia(max_diags=128)
        if stencil:
            # re-index the factors into the stencil's strided coordinates;
            # the restrided data's zero slots mask the gaps and the tail
            low_d = restride_dia(low_d, pad_like.c_grid, pad_like.stride)
            up_d = restride_dia(up_d, pad_like.c_grid, pad_like.stride)
        nl, nu = (PallasDIAOperator.from_dia(
            f, dtype=pad_like.vec_dtype, block=pad_like.block,
            device=pad_like.device) for f in (low_d, up_d))
        if (nl.npad, nl.block) != (pad_like.npad, pad_like.block) or \
                (nu.npad, nu.block) != (pad_like.npad, pad_like.block):
            raise ValueError("factor padding does not match the operator")
        return cls(nl, nu, pad_like.pad_vec(1.0 / diag), terms)

    @classmethod
    def _const_factors(cls, low, up, diag, terms, pad_like,
                       prefer_mono: bool) -> "NeumannILUPreconditioner":
        """The deep-interior constant stencils of the factors, in the first
        of the modes ("mono" if asked for), "kernel", "series", sequential
        whose layout holds."""
        nl = _const_factor_operator(low, pad_like)
        nu = _const_factor_operator(up, pad_like)
        fl = _fused_series_operator(nl, terms)
        fu = _fused_series_operator(nu, terms)
        if fl is not None and fu is not None and prefer_mono:
            mono = _mono_operator(fl, fu, diag, pad_like)
            if mono is not None:
                return cls(mono, None,
                           torch.zeros(0, dtype=pad_like.vec_dtype,
                                       device=pad_like.device),
                           terms, fused="mono")
        inv_d = pad_like.pad_vec(1.0 / diag)
        if fl is None or fu is None:
            return cls(nl, nu, inv_d, terms)
        itemsize = torch.empty((), dtype=pad_like.vec_dtype).element_size()
        tl, tu = fl.strided_terms, fu.strided_terms
        if _kernels.msolve_fits(pad_like.block, tl, tu, itemsize):
            gap_ext = torch.as_tensor(extend_gapmask(
                pad_like.gapmask.cpu().numpy(), msolve_halo(tu))).to(
                    pad_like.device)
            return cls(fl, fu, inv_d, terms, fused="kernel", gap_ext=gap_ext,
                       fma_fits=_kernels.msolve_fma_fits(
                           pad_like.block, tl, tu, itemsize))
        return cls(fl, fu, inv_d, terms, fused="series")

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        if self.fused == "mono":
            return self.nl.matvec(f)
        if self.fused == "kernel":
            op = self.nl
            return const_series_msolve_padded(
                f, self.inv_d, self.gap_ext, op.strided_terms,
                self.nu.strided_terms, op.np_true, op.block, op.sub)
        if self.fused:
            return self.nu.matvec(self.inv_d * self.nl.matvec(f))
        y = f
        term = f
        for _ in range(self.terms - 1):
            term = -self.nl.matvec(term)
            y = y + term
        g = self.inv_d * y
        x = g
        term = g
        for _ in range(self.terms - 1):
            term = -self.nu.matvec(term)
            x = x + term
        return x

    def msolve_fma(self, a, c1, b, c2=None, c=None):
        """``(p, M⁻¹ p)`` with ``p = a + c1·(b + c2·c)`` (or ``a + c1·b``
        without ``c``): the loop's BLAS1 update folded into one launch of
        kernel B5 where it takes the "kernel" layout (:attr:`fma_fits`),
        else the combination and :meth:`msolve`, as in the JAX package.
        ``c1``/``c2`` are the loop's 0-d device tensors."""
        if self.fused == "kernel" and self.fma_fits:
            op = self.nl
            return const_series_msolve_fma_padded(
                a, c1, b, c2, c, self.inv_d, self.gap_ext, op.strided_terms,
                self.nu.strided_terms, op.np_true, op.block, op.sub)
        p = fma_combine(a, c1, b, c2, c)
        return p, self.msolve(p)


def _mono_operator(fl, fu, diag, pad_like):
    """The whole M⁻¹ ≈ P_u·d*·P_l as one stencil sharing ``pad_like``'s
    layout, d* the diagonal's value at the grid centre (the JAX package's
    composition), or None where the composition leaves the gap or takes
    more terms or a wider halo than kernel B1 takes."""
    d_star = float(diag[(pad_like.r // 2) * pad_like.c_grid
                        + pad_like.c_grid // 2])
    try:
        mt = compose_stencil_terms(
            fu.terms, tuple((o, d, v / d_star) for (o, d, v) in fl.terms),
            pad_like.c_grid, pad_like.stride)
    except ValueError:
        return None
    st = strided_offsets(mt, pad_like.c_grid, pad_like.stride)
    if len(mt) > _kernels.MAX_TERMS or max(abs(s[0]) for s in st) \
            > pad_like.sub:
        return None
    return dataclasses.replace(pad_like, terms=mt, strided_terms=st)


def _fused_series_operator(n_op, k: int):
    """Whole-series stencil ``P = Σ_{j<k} (−N)^j`` sharing ``n_op``'s layout,
    or None when a polynomial offset exceeds the layout's gap width or halo
    sub-block, or the series has more terms than kernel B1 takes (the
    sequential series still applies)."""
    try:
        pt = neumann_poly_terms(n_op.terms, k, n_op.c_grid, n_op.stride)
    except ValueError:
        return None
    st = strided_offsets(pt, n_op.c_grid, n_op.stride)
    if max(abs(s[0]) for s in st) > n_op.sub or len(pt) > _kernels.MAX_TERMS:
        return None
    return dataclasses.replace(n_op, terms=pt, strided_terms=st)


def _const_factor_operator(factor_csr, pad_like):
    """Matrix-free constant-stencil operator for an ILU factor, sharing
    ``pad_like``'s gap-strided layout (same block/sub/gapmask/padding)."""
    fd = factor_csr.to_dia(max_diags=128)
    terms, sterms = const_factor_terms(fd, pad_like.c_grid, pad_like.stride)
    if max(abs(s[0]) for s in sterms) > pad_like.sub:
        raise ValueError("factor offsets exceed the operator's halo sub-block")
    return dataclasses.replace(pad_like, terms=terms, strided_terms=sterms)


def neumann_factors(csr, milu_omega: float = 0.0):
    """ILU(0)-factorize ``csr`` and split the factor for the Neumann series:
    returns ``(N_l, N_u, diag)`` where ``N_l`` is the strict lower triangle of
    M (unit-lower L = I + N_l), ``N_u`` is D⁻¹·strict-upper (U = D(I + N_u)),
    both as host CSR, and ``diag`` is D.  ``milu_omega`` > 0 switches to
    relaxed modified ILU(0) (:func:`milu0_factorize`)."""
    mvals = _factorize(csr, milu_omega)
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    lower = cols < rows
    upper = cols > rows
    diag = np.zeros(csr.n)
    diag[rows[cols == rows]] = mvals[cols == rows]
    if np.any(diag == 0):
        raise ValueError("ILU(0) factor has a zero diagonal")
    if not lower.any() or not upper.any():
        raise ValueError("matrix has an empty strict triangle; use"
                         " precond='jacobi'")
    low = CSRMatrix.from_coo(COOMatrix(
        csr.n, csr.n, rows[lower].astype(np.int32),
        cols[lower].astype(np.int32), mvals[lower]))
    upv = mvals[upper] / diag[rows[upper]]  # D^-1 * strict upper
    up = CSRMatrix.from_coo(COOMatrix(
        csr.n, csr.n, rows[upper].astype(np.int32),
        cols[upper].astype(np.int32), upv))
    return low, up, diag


def _factorize(csr, milu_omega: float = 0.0) -> np.ndarray:
    """Native factorizer when it builds, else the numpy loops (minutes at
    millions of rows — large runs should check ``native.loader.available``
    first)."""
    if _native.available():
        if milu_omega:
            return _native.milu0_factorize(csr, milu_omega)
        return _native.ilu0_factorize(csr)
    if milu_omega:
        return milu0_factorize(csr, milu_omega)
    return ilu0_factorize(csr)


def milu0_factorize(csr, omega: float) -> np.ndarray:
    """Relaxed modified ILU(0) (pure-numpy fallback; the native
    ``cmt_milu0`` agrees to accumulation-order ulps): the IKJ elimination of
    :func:`~cuda_mat_tpu_torch.reference.cpu_solvers.ilu0_factorize`
    restricted to the pattern, but each row's *dropped* fill is summed and
    ``omega`` times it is subtracted from the row's diagonal.  ``omega=1``
    preserves A's row sums through L·U (classic MILU); ``0 < omega < 1``
    keeps the factor diagonally dominant enough for the truncated Neumann
    series."""
    n = csr.n
    m = csr.data.astype(np.float64).copy()
    indptr, indices = csr.indptr, csr.indices
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        js = indices[lo:hi]
        k = np.searchsorted(js, i)
        if k >= js.shape[0] or js[k] != i:
            raise ValueError(
                f"MILU(0) requires a stored nonzero diagonal (row {i})")
        diag_pos[i] = lo + k
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        dropped = 0.0
        for kk in range(lo, int(diag_pos[i])):
            k = indices[kk]
            pivot = m[diag_pos[k]]
            if pivot == 0.0:
                raise ValueError(f"MILU(0) zero pivot at row {k}")
            m[kk] = m[kk] / pivot
            lik = m[kk]
            klo, khi = int(diag_pos[k]) + 1, indptr[k + 1]
            if klo >= khi:
                continue
            row_i_js = indices[kk + 1:hi]
            row_k_js = indices[klo:khi]
            pos = np.searchsorted(row_i_js, row_k_js)
            ok = pos < row_i_js.shape[0]
            ok[ok] &= row_i_js[pos[ok]] == row_k_js[ok]
            upd = lik * m[klo:khi]
            m[kk + 1 + pos[ok]] -= upd[ok]
            dropped += float(upd[~ok].sum())
        m[diag_pos[i]] -= omega * dropped
    return m


def make_preconditioner(kind: str, csr, block: int = 256, dtype=torch.float64,
                        terms: int = 3, milu_omega: float = 0.0, *, device):
    """A preconditioner over true-n vectors on ``device``, by name."""
    if kind in (None, "none", "identity"):
        return IdentityPreconditioner()
    if kind == "jacobi":
        return JacobiPreconditioner.from_csr(csr, dtype=dtype, device=device)
    if kind == "ilu0":
        return ILU0Preconditioner.from_csr(csr, block=block, dtype=dtype,
                                           device=device,
                                           milu_omega=milu_omega)
    if kind == "ilu0_neumann":
        return NeumannILUPreconditioner.from_csr(csr, terms=terms,
                                                 milu_omega=milu_omega,
                                                 dtype=dtype, device=device)
    raise ValueError(f"unknown preconditioner {kind!r}")
