"""BiCGSTAB in PyTorch (counterpart of :mod:`cuda_mat_tpu.solvers.bicgstab`).

Three entry points mirror the reference's (pbicgstab.h:113-120):
:func:`bicgstab` (the h-form loop, no preconditioner),
:func:`bicgstab_split` (``A = A0 + diag(d)``) and
:func:`bicgstab_lu_precond` (ILU(0)), plus :func:`solve` /
:func:`make_solver`, which pick the preconditioner from ``SolverConfig``
(none, jacobi, ilu0, ilu0_neumann) and apply its RCM reordering.  Any
square matrix solves: a proven constant-coefficient grid stencil runs on
the gap-strided stencil (kernel B1) and any other banded matrix on the
banded DIA operator (kernel B3), both over padded vectors; the rest, and
any ``format="csr"|"ell"|"dia"|"bell"|"dense"``, on the unpadded
operators of ``make_operator`` over true-n vectors.  A device operator —
padded, such as ``StencilOperator2D`` (kernel B7), or unpadded — may stand
in place of the matrix.  Only ``debug=True`` is not ported (ROADMAP A10).

Both loops keep the JAX package's update order exactly — the preconditioned
one its flat, select-based body, the first-half convergence exit that does
not bump the counter, NaN as BREAKDOWN and the ``(2·maxit,)`` residual
history; the h-form its ``|omega|`` breakdown guard and ``(maxit,)``
history.  Scalars stay on the device as 0-d tensors.  The host reads
``status`` and ``i`` once per iteration (one ``torch.stack([...]).tolist()``)
to decide whether to go on; everything else is queued without waiting.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cuda_mat_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.formats.reorder import (permute_csr, permute_vector,
                                                rcm_permutation,
                                                unpermute_vector)
from cuda_mat_tpu_torch.ops.dia_spmv import PallasDIAOperator
from cuda_mat_tpu_torch.ops.operators import (DIA_MAX_DIAGS, SplitOperator,
                                              is_banded, is_padded,
                                              make_operator)
from cuda_mat_tpu_torch.ops.stencil import (ConstStencilOperator,
                                            detect_const_stencil,
                                            plan_const_neumann_layout)
from cuda_mat_tpu_torch.precond.preconditioners import (
    IdentityPreconditioner, JacobiPreconditioner, NeumannILUPreconditioner,
    PaddedPreconditioner, make_preconditioner)
from cuda_mat_tpu_torch.solvers.result import SolveResult, SolverStatus
from cuda_mat_tpu_torch.utils.timing import device_sync

_RUNNING = 0
_CONVERGED = 1
_BREAKDOWN = 2

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class _HState(NamedTuple):
    i: torch.Tensor
    status: torch.Tensor
    x: torch.Tensor
    x0: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    norm: torch.Tensor
    hist: torch.Tensor


class _PState(NamedTuple):
    i: torch.Tensor
    status: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    nrmr: torch.Tensor
    hist: torch.Tensor
    rw: torch.Tensor       # the shadow residual r̂ = r_0
    nrmr0: torch.Tensor


class _Consts(NamedTuple):
    """Device constants of one solve, made once so that no select or
    comparison in the loop uploads a Python number."""
    zero: torch.Tensor
    one: torch.Tensor
    tol: torch.Tensor
    running: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor


def loop_constants(dt: torch.dtype, device, tol: float) -> _Consts:
    def f(v):
        return torch.tensor(v, dtype=dt, device=device)

    def s(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return _Consts(f(0.0), f(1.0), f(tol), s(_RUNNING), s(_CONVERGED),
                   s(_BREAKDOWN))


def hform_core(matvec, dot, x0, b, tol: float, btol: float, maxit: int):
    """h-form BiCGSTAB loop (reference gpu_pbicgstab2, pbicgstab.cu:488-573),
    generic over ``matvec``/``dot``: scalar recurrences rho/alpha/omega, the
    explicit intermediate h = x0 + αp̂, the convergence check, then the
    |omega| breakdown guard.  Returns ``(x, status, iters, norm, norm0,
    hist)`` as device tensors; the host polls ``status`` and ``i`` once per
    iteration, as in :func:`precond_core`."""
    c = loop_constants(b.dtype, b.device, tol)
    btol_t = torch.tensor(btol, dtype=b.dtype, device=b.device)
    r0 = b - matvec(x0)
    norm0 = torch.sqrt(dot(r0, r0))
    z = torch.zeros_like(b)
    st = _HState(torch.zeros((), dtype=torch.int32, device=b.device),
                 c.running, z, x0, r0, z, z, c.one, c.one, c.one, norm0,
                 torch.full((maxit,), -1.0, dtype=b.dtype, device=b.device))
    status, i = _RUNNING, 0
    while i < maxit and status == _RUNNING:
        rho_ = dot(r0, st.r)
        beta = (rho_ / st.rho) * (st.alpha / st.omega)
        p_ = st.r + beta * (st.p - st.omega * st.v)
        v_ = matvec(p_)
        alpha = rho_ / dot(r0, v_)
        h = st.x0 + alpha * p_
        s = st.r - alpha * v_
        t = matvec(s)
        omega = dot(t, s) / dot(t, t)
        x = h + omega * s
        r_ = s - omega * t
        norm = torch.sqrt(dot(r_, r_))
        conv = norm < c.tol * norm0
        broke = (~conv) & ((torch.abs(omega) < btol_t) | torch.isnan(omega))
        st.hist[i] = norm
        st = _HState(st.i + 1,
                     torch.where(conv, c.converged,
                                 torch.where(broke, c.breakdown, c.running)),
                     x, x, r_, p_, v_, rho_, alpha, omega, norm, st.hist)
        status, i = torch.stack([st.status, st.i]).tolist()
    return st.x, st.status, st.i, st.norm, norm0, st.hist


def precond_init(matvec, dot, x0, b, maxit: int, c: _Consts) -> _PState:
    """Initial state of :func:`precond_core` (reference pbicgstab.cu:75-81)."""
    r = b - matvec(x0)
    nrmr0 = torch.sqrt(dot(r, r))
    i0 = torch.zeros((), dtype=torch.int32, device=b.device)
    return _PState(i0, c.running, x0, r, r,
                   torch.zeros_like(b), c.zero, c.one, c.one, nrmr0,
                   torch.full((2 * maxit,), -1.0, dtype=b.dtype,
                              device=b.device), r, nrmr0)


def precond_step(matvec, msolve, dot, st: _PState, i: int, c: _Consts,
                 matvec_dots=None, msolve_fma=None,
                 check_halves: bool = True) -> _PState:
    """One iteration of the preconditioned loop (reference gpu_pbicgstab,
    pbicgstab.cu:83-150): two M-solve + SpMV half-steps with a convergence
    check after each.  ``i`` is the host's copy of ``st.i``, used to place
    this iteration's pair in the history.

    Flat body: the reference's two data-dependent branches (the i==0 p-init
    and the first-half exit) are selects around unconditionally executed
    compute, and every divisor is select-guarded so the dead half-iteration
    after a first-half exit can never make NaN or Inf.

    The JAX package's opt-in variants: ``matvec_dots(x, ws, with_self)``
    takes each matvec's dots with it (kernel B6); ``msolve_fma(a, c1, b,
    c2, c)`` folds the p-update ``r + β(p − ωv)`` and the r1-production
    ``r − αv`` into the msolve (kernel B5) — the same values, since
    ``x + (−a)·y`` rounds as ``x − a·y``; ``check_halves=False`` drops the
    first-half check (its dot, sqrt, compare and selects), so convergence
    is tested after whole iterations only and the first-half history slots
    stay −1."""
    one = c.one
    rhop = st.rho
    rho = dot(st.rw, st.r)
    first = st.i == 0
    beta = torch.where(first, c.zero,
                       (rho / torch.where(first, one, rhop))
                       * (st.alpha / st.omega))
    if msolve_fma is None:
        p = st.r + beta * (st.p - st.omega * st.v)
        pw = msolve(p)
    else:
        p, pw = msolve_fma(st.r, beta, st.p, -st.omega, st.v)
    if matvec_dots is None:
        v = matvec(pw)
        den_a = dot(st.rw, v)
    else:
        v, parts = matvec_dots(pw, (st.rw,))
        den_a = parts[0]
    alpha = rho / den_a
    if msolve_fma is None:
        r1 = st.r - alpha * v
    else:
        r1, s = msolve_fma(st.r, -alpha, v)
    x1 = st.x + alpha * pw
    if check_halves:
        nrmr1 = torch.sqrt(dot(r1, r1))
        conv1 = nrmr1 < c.tol * st.nrmr0
    if msolve_fma is None:
        s = msolve(r1)
    if matvec_dots is None:
        t = matvec(s)
        num_o = dot(t, r1)
        den_o = dot(t, t)
    else:
        t, parts = matvec_dots(s, (r1,), with_self=True)
        num_o, den_o = parts[0], parts[1]
    if check_halves:
        omega_c = (torch.where(conv1, one, num_o)
                   / torch.where(conv1, one, den_o))
        omega = torch.where(conv1, st.omega, omega_c)
        x2 = torch.where(conv1, x1, x1 + omega_c * s)
        r2 = torch.where(conv1, r1, r1 - omega_c * t)
        nrmr2 = torch.where(conv1, nrmr1, torch.sqrt(dot(r2, r2)))
        conv2 = (~conv1) & (nrmr2 < c.tol * st.nrmr0)
        # the reference's preconditioned loop has no NaN guard and would
        # spin to maxit on a float breakdown — surface BREAKDOWN instead
        broke = (~conv1) & (~conv2) & (torch.isnan(nrmr2)
                                       | torch.isnan(alpha))
        status = torch.where(conv1 | conv2, c.converged,
                             torch.where(broke, c.breakdown, c.running))
        i_next = torch.where(conv1, st.i, st.i + 1)
        pair = torch.stack([nrmr1, torch.where(conv1, -one, nrmr2)])
    else:
        # ω is not guarded here, as in the JAX package (ROADMAP C2)
        omega = num_o / den_o
        x2 = x1 + omega * s
        r2 = r1 - omega * t
        nrmr2 = torch.sqrt(dot(r2, r2))
        conv2 = nrmr2 < c.tol * st.nrmr0
        broke = (~conv2) & (torch.isnan(nrmr2) | torch.isnan(alpha))
        status = torch.where(conv2, c.converged,
                             torch.where(broke, c.breakdown, c.running))
        i_next = st.i + 1
        pair = torch.stack([-one, nrmr2])
    st.hist[2 * i:2 * i + 2] = pair
    return _PState(i_next, status, x2, r2, p, v, rho, alpha, omega, nrmr2,
                   st.hist, st.rw, st.nrmr0)


def precond_core(matvec, msolve, dot, x0, b, tol: float, maxit: int,
                 matvec_dots=None, msolve_fma=None,
                 check_halves: bool = True):
    """Preconditioned BiCGSTAB loop (reference gpu_pbicgstab,
    pbicgstab.cu:45-154), generic over ``matvec``/``msolve``/``dot``, with
    the opt-in variants of :func:`precond_step`.  Returns ``(x, status,
    iters, nrmr, nrmr0, hist)`` as device tensors.

    The host polls ``status`` and ``i`` once per iteration; that read waits
    for the iteration to finish, so the device idles while the host queues
    the next one."""
    c = loop_constants(b.dtype, b.device, tol)
    st = precond_init(matvec, dot, x0, b, maxit, c)
    status, i = _RUNNING, 0
    while i < maxit and status == _RUNNING:
        st = precond_step(matvec, msolve, dot, st, i, c, matvec_dots,
                          msolve_fma, check_halves)
        status, i = torch.stack([st.status, st.i]).tolist()
    return st.x, st.status, st.i, st.nrmr, st.nrmr0, st.hist


# ---------------------------------------------------------------------------
# Host-facing wrappers
# ---------------------------------------------------------------------------


_HFORM = (None, "none", "identity")        # no preconditioner: h-form loop
_PADDED_FORMATS = ("pallas_dia", "stencil")


def _dtype_of(config: SolverConfig) -> torch.dtype:
    if config.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {config.dtype!r}")
    if config.debug:
        raise NotImplementedError("debug is not ported to cuda_mat_tpu_torch"
                                  " yet (ROADMAP A10)")
    return _DTYPES[config.dtype]


def _is_device_operator(a) -> bool:
    """A device operator passed in place of a matrix: a padded one (such as
    :class:`~cuda_mat_tpu_torch.ops.stencil2d.StencilOperator2D`) or an
    unpadded one of :mod:`~cuda_mat_tpu_torch.ops.operators`, whose
    ``pad_vec``/``unpad_vec`` are the identity."""
    return not isinstance(a, CSRMatrix) and all(
        hasattr(a, k) for k in ("pad_vec", "unpad_vec", "matvec"))


def _as_op(a, dtype: torch.dtype, device, format: Optional[str] = None):
    """The operator of ``a``.  First the JAX ``_as_op``'s TPU branch, taken
    on every device: a proven constant-coefficient grid stencil runs
    matrix-free (kernel B1) unless ``format="pallas_dia"``; any other
    banded matrix — by :func:`~cuda_mat_tpu_torch.ops.operators.is_banded`,
    or any band of at most 16 diagonals under ``format="stencil"|
    "pallas_dia"`` — as banded DIA (kernel B3).
    Everything else falls through to
    :func:`~cuda_mat_tpu_torch.ops.operators.make_operator`, as in the JAX
    package: the unpadded operators, by its rule or by ``format="csr"|
    "ell"|"dia"|"bell"|"dense"``.

    A device operator is taken as it is, in its own dtype and on its own
    device (``format`` is not read, as in the JAX package); a ``device``
    that names another device raises ValueError."""
    if _is_device_operator(a):
        own = torch.device(a.device)
        same_index = (own.index is None or device.index is None
                      or own.index == device.index)
        if own.type != device.type or not same_index:
            raise ValueError(f"the operator lives on {own}, not on {device}")
        return a
    if not isinstance(a, CSRMatrix):
        raise TypeError(f"expected a CSRMatrix or a padded device operator,"
                        f" got {type(a).__name__}")
    if a.n != a.m:
        raise ValueError(
            f"square matrix is expected, got {a.n}x{a.m}")  # cf. example.cpp:257-260
    if format not in (None,) + _PADDED_FORMATS:
        return make_operator(a, dtype=dtype, format=format, device=device)
    if format is None and not is_banded(a):
        return make_operator(a, dtype=dtype, device=device)
    dia = a.to_dia(max_diags=DIA_MAX_DIAGS)
    if format != "pallas_dia":
        # detection is an exact proof, so the matrix-free operator is always
        # safe
        if detect_const_stencil(dia) is not None:
            try:
                return ConstStencilOperator.from_dia(dia, dtype=dtype,
                                                     device=device)
            except ValueError:
                # no stencil layout within its budget; DIA still applies
                if format == "stencil":
                    raise
        elif format == "stencil":
            raise ValueError("matrix is not a constant-coefficient grid"
                             " stencil; drop format='stencil'")
    return PallasDIAOperator.from_dia(dia, dtype=dtype, device=device)


def _build_setup(a, op, dt: torch.dtype, config: SolverConfig):
    """Build the preconditioner from host factors (the reference's setup
    phase: analysis + factorization, pbicgstab.cu:335-363).  Returns
    ``(op, pre)``, ``pre`` None for the h-form loop.

    An unpadded operator takes the preconditioner on true-n vectors.  On a
    padded one, exact ILU(0) keeps the operator's layout: its triangular
    solves work on true-n vectors, adapted at the msolve boundary.  Jacobi
    multiplies by 1/diag in the padded layout.  The Neumann series builds
    its factors in the operator's layout (with constant factors on a
    stencil it re-plans that layout for its fused series stencils first);
    where they do not fit it, the JAX package's fallback replaces the
    operator by an unpadded one and runs the series on true-n vectors."""
    kind = config.precond
    if kind in _HFORM:
        return op, None
    if not isinstance(a, CSRMatrix):
        # a device operator: any preconditioner request runs the identity,
        # as the JAX package's _build_setup does (ROADMAP C7)
        return op, IdentityPreconditioner()
    if not is_padded(op):
        return op, _true_n_preconditioner(a, op.device, dt, config)
    if kind == "ilu0":
        return op, PaddedPreconditioner(
            _true_n_preconditioner(a, op.device, dt, config), op)
    if kind == "jacobi":
        diag = a.diagonal()
        if np.any(diag == 0):
            raise ValueError(
                "Jacobi preconditioner requires a nonzero diagonal")
        return op, JacobiPreconditioner(op.pad_vec(1.0 / diag))
    if kind != "ilu0_neumann":
        raise ValueError(f"unknown preconditioner {kind!r}")
    if config.neumann_const_factors and isinstance(op, ConstStencilOperator):
        plan = plan_const_neumann_layout(op.terms, config.neumann_terms,
                                         op.c_grid, op.stride,
                                         fuse_blas1=config.fuse_blas1)
        if plan is not None and (plan[0] > op.sub or op.block > plan[1]):
            # widen the halo sub-block to the polynomials' offsets and cap
            # the block as the JAX package does; a layout that cannot be
            # built keeps the first one, and the sequential series applies
            try:
                op = ConstStencilOperator.from_dia(
                    a.to_dia(max_diags=DIA_MAX_DIAGS), dtype=dt,
                    device=op.device, min_sub=plan[0], block_target=plan[1])
            except ValueError:
                pass
    try:
        pre = NeumannILUPreconditioner.from_csr(
            a, terms=config.neumann_terms, pad_like=op,
            const_factors=config.neumann_const_factors,
            milu_omega=config.milu_omega)
    except ValueError:
        op = make_operator(a, dtype=dt, device=op.device)
        pre = _true_n_preconditioner(a, op.device, dt, config)
    return op, pre


def _true_n_preconditioner(a, device, dt: torch.dtype, config: SolverConfig):
    return make_preconditioner(config.precond, a, block=config.trisolve_block,
                               dtype=dt, terms=config.neumann_terms,
                               milu_omega=config.milu_omega, device=device)


def host_matvec_f64(a: CSRMatrix, x) -> np.ndarray:
    """``A x`` in float64 on the host (bincount over the CSR entries); used
    by the true-residual report and iterative refinement."""
    x64 = np.asarray(x, np.float64)
    rows = np.repeat(np.arange(a.n), a.row_lengths)
    return np.bincount(rows, weights=np.asarray(a.data, np.float64)
                       * x64[a.indices], minlength=a.n)


def _attach_true_residual(res: SolveResult, a, b, config: SolverConfig,
                          d=None) -> SolveResult:
    # a device operator has no host matrix: residual_true stays None
    if config.true_residual and isinstance(a, CSRMatrix):
        bb = np.asarray(b, np.float64)
        if d is not None:                     # split form A = A0 + diag(d)
            bb = bb - np.asarray(d, np.float64) * np.asarray(res.x,
                                                             np.float64)
        res.residual_true = float(np.linalg.norm(bb - host_matvec_f64(a,
                                                                      res.x)))
    return res


def _check_shapes(op, b):
    b = np.asarray(b)
    if b.ndim != 1 or b.shape[0] != op.n:
        raise ValueError(
            f"b must be a vector of length n={op.n}, got shape {b.shape}"
        )  # cf. example.cpp:320-328


def _finish(op, out, dt_alg: float, dt_setup: float) -> SolveResult:
    x, status, iters, nrmr, nrmr0, hist = out
    status = int(status)
    if status == _RUNNING:
        status = SolverStatus.MAXIT
    return SolveResult(
        x=op.unpad_vec(x).cpu().numpy(), status=SolverStatus(status),
        iters=int(iters), residual=float(nrmr), residual0=float(nrmr0),
        dt_alg=dt_alg, dt_setup=dt_setup, residual_history=hist.cpu().numpy())


class PreparedSolver:
    """Operator + preconditioner built once on one device; :meth:`solve`
    runs any number of right-hand sides through them (the reference's
    setup/solve split, pbicgstab.cu:335-363 vs :366).  With a permutation
    ``perm`` the operator holds the reordered matrix: each solve permutes b
    and x0 and scatters x back, and ``a`` stays the caller's matrix, so the
    true residual is the caller's."""

    def __init__(self, a, op, pre, config: SolverConfig, dt_setup: float,
                 perm=None):
        self.a = a
        self.op = op
        self.pre = pre          # None: the h-form loop
        self._config = config
        self.dt_setup = dt_setup
        self._perm = perm       # RCM: new index k holds input row perm[k]

    @property
    def n(self) -> int:
        return self.op.n

    @property
    def device(self) -> torch.device:
        return self.op.device

    def _prep_vec(self, v) -> torch.Tensor:
        v = np.asarray(v)
        if self._perm is not None:
            v = permute_vector(v, self._perm)
        return self.op.pad_vec(v)

    def solve(self, b, x0: Optional[np.ndarray] = None) -> SolveResult:
        """Solve ``A x = b``; ``x0`` defaults to all-ones (reference
        pbicgstab.cu:306-308, :827-832)."""
        cfg = self._config
        _check_shapes(self.op, b)
        bd = self._prep_vec(b)
        x0d = self._prep_vec(np.ones(self.op.n) if x0 is None else x0)
        # dtAlg excludes H2D transfers (reference pbicgstab.h:108-109)
        device_sync(self.device)
        t1 = time.perf_counter()
        if self.pre is None:
            out = hform_core(self.op.matvec, torch.dot, x0d, bd, cfg.tol,
                             cfg.breakdown_tol, cfg.maxit)
        else:
            # the opt-in variants engage where the operator and the
            # preconditioner offer them (the JAX package's _precond_solve)
            mvd = getattr(self.op, "matvec_dots", None) \
                if cfg.fused_dots else None
            mfma = self.pre.msolve_fma \
                if cfg.fuse_blas1 and getattr(self.pre, "fma_fits", False) \
                else None
            out = precond_core(self.op.matvec, self.pre.msolve, torch.dot,
                               x0d, bd, cfg.tol, cfg.maxit, matvec_dots=mvd,
                               msolve_fma=mfma,
                               check_halves=cfg.check_halves)
        device_sync(self.device)
        t2 = time.perf_counter()
        res = _finish(self.op, out, t2 - t1, self.dt_setup)
        if self._perm is not None:
            res.x = unpermute_vector(res.x, self._perm)
        return _attach_true_residual(res, self.a, b, cfg)


def make_solver(a, config: SolverConfig = DEFAULT_CONFIG,
                format: Optional[str] = None,
                device="cuda") -> PreparedSolver:
    """Build the operator and preconditioner once on ``device`` (a
    ``torch.device`` or its name; CPU runs the kernels' plain twins).
    ``format``: None, ``"stencil"``, ``"pallas_dia"`` or one of
    ``make_operator``'s (see :func:`_as_op`).  ``config.reorder="rcm"``
    permutes a CSR matrix once by reverse Cuthill–McKee and builds both on
    the permuted one.  ``debug=True`` raises NotImplementedError (ROADMAP
    A10)."""
    t0 = time.perf_counter()
    dt = _dtype_of(config)
    perm, a_in, cfg = None, a, config
    if cfg.reorder not in (None, "none") and isinstance(a, CSRMatrix):
        if cfg.reorder != "rcm":
            raise ValueError(f"unknown reorder {cfg.reorder!r}")
        perm = rcm_permutation(a)
        a_in = permute_csr(a, perm)
        cfg = cfg.replace(reorder="none")
    op = _as_op(a_in, dt, torch.device(device), format)
    op, pre = _build_setup(a_in, op, dt, cfg)
    device_sync(op.device)
    return PreparedSolver(a, op, pre, cfg, time.perf_counter() - t0,
                          perm=perm)


def solve(a, b, config: SolverConfig = DEFAULT_CONFIG,
          x0: Optional[np.ndarray] = None, format: Optional[str] = None,
          device="cuda") -> SolveResult:
    """One-shot convenience over :func:`make_solver`; ``config.precond``
    selects none/jacobi/ilu0/ilu0_neumann."""
    return make_solver(a, config, format, device=device).solve(b, x0=x0)


def bicgstab(a, b, config: SolverConfig = DEFAULT_CONFIG,
             x0: Optional[np.ndarray] = None, format: Optional[str] = None,
             device="cuda") -> SolveResult:
    """Plain BiCGSTAB, the h-form loop, x0 = all-ones by default (reference
    wrapper pbicgstab.cu:756-922, x0 init at :827-832)."""
    cfg = config if config.precond in _HFORM \
        else config.replace(precond="none")
    return solve(a, b, cfg, x0=x0, format=format, device=device)


def bicgstab_split(a0, d, x0, b, config: SolverConfig = DEFAULT_CONFIG,
                   format: Optional[str] = None,
                   device="cuda") -> SolveResult:
    """BiCGSTAB on the split form ``(A0 + diag(d)) x = b`` with
    caller-supplied x0 (reference pbicgstab.cu:926-1088; the SpMV is the
    fused d∘x + A0·x).  ``d`` lies in A0's operator's layout: on a padded
    one its pads are zero, so d∘x keeps the padding a fixed point."""
    dt = _dtype_of(config)
    t0 = time.perf_counter()
    base = _as_op(a0, dt, torch.device(device), format)
    op = SplitOperator(base, base.pad_vec(np.asarray(d)))
    _check_shapes(op, b)
    bd = base.pad_vec(np.asarray(b))
    x0d = base.pad_vec(np.asarray(x0))
    device_sync(base.device)
    t1 = time.perf_counter()
    out = hform_core(op.matvec, torch.dot, x0d, bd, config.tol,
                     config.breakdown_tol, config.maxit)
    device_sync(base.device)
    t2 = time.perf_counter()
    return _attach_true_residual(_finish(base, out, t2 - t1, t1 - t0), a0, b,
                                 config, d=d)


def bicgstab_lu_precond(a, b, config: SolverConfig = DEFAULT_CONFIG,
                        format: Optional[str] = None,
                        device="cuda") -> SolveResult:
    """ILU(0)-preconditioned BiCGSTAB, x0 = all-ones (reference
    bicgstab_lu_precond, pbicgstab.cu:157-409; x0 at :306-308).  Unlike the
    reference — which always returns true (:408) — the result carries real
    convergence status."""
    return solve(a, b, config.replace(precond="ilu0"), format=format,
                 device=device)
