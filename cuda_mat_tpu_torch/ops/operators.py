"""The unpadded sparse operators, ``make_operator`` and the split-form
operator (counterpart of :mod:`cuda_mat_tpu.ops.operators`).

Each unpadded operator is a frozen dataclass of device tensors with
``matvec(x)`` over true-n vectors, replacing the reference's
``cusparseDcsrmv`` call sites (reference pbicgstab.cu:67,104,132,469,501,
528).  The JAX package computes all of them in XLA, so here they are stock
torch ops, each of which sums in a fixed order on every call (the solver
reads a residual every step, so a matvec whose sum order moved between
calls would move the iteration count between runs):

- :class:`CSROperator` — gather, multiply, and a segment sum of each row
  over the row pointer (``torch.segment_reduce``; no atomics);
- :class:`ELLOperator` — one rectangular gather and a row reduction;
- :class:`DIAOperator` — shifted multiply-adds over the true-n vector, no
  gather;
- :class:`BELLOperator` — a block gather of x and one batched GEMV per block
  row over its padded blocks (cuBLAS, full f32: no TF32);
- :class:`DenseOperator` — ``torch.mv``.

Each also has ``n``, ``m``, ``device``, ``vec_dtype`` and an identity
``pad_vec``/``unpad_vec`` pair (a host array becomes a tensor of
``vec_dtype`` on ``device``, and back), so that the solver, the pad adapter
and refinement take them as they take the padded kernel operators — the
port's counterpart of the JAX package's ``padded`` flag.  The solver's
``_is_device_operator`` therefore also takes an unpadded operator passed in
place of a matrix, as the JAX ``_as_op`` takes any device operator.

:func:`make_operator` follows the JAX package's off-TPU rule on every
device: DIA for at most 16 diagonals holding nnz ≥ 0.4·ndiag·n
(:func:`is_banded`), else ELL
when padding every row to the longest costs at most 4× the nonzeros, else
CSR; BELL and dense only on request.  Its TPU branch (dense or BELL because
the TPU gathers slowly, cuda_mat_tpu/ops/operators.py:241) does not carry
over: Hopper gathers at memory speed.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _to(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(dtype=dtype, device=device)


class _TrueN:
    """Identity vector adapters of an operator over true-n vectors; the
    class defines ``vec_dtype`` and ``device``."""

    padded: ClassVar[bool] = False

    def pad_vec(self, v) -> torch.Tensor:
        """A host array → a new tensor of ``vec_dtype`` on ``device``."""
        return torch.tensor(np.asarray(v), dtype=self.vec_dtype,
                            device=self.device)

    def unpad_vec(self, v: torch.Tensor) -> torch.Tensor:
        return v


@dataclasses.dataclass(frozen=True)
class CSROperator(_TrueN):
    """CSR SpMV: ``y[i] = Σ_{k in row i} data[k]·x[indices[k]]``, each row
    summed in a fixed order over the row pointer (the JAX package sums a
    segment per precomputed row id)."""

    data: torch.Tensor     # [nnz]
    indices: torch.Tensor  # int32[nnz]
    indptr: torch.Tensor   # int32[n + 1]
    n: int
    m: int

    @property
    def vec_dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        prod = self.data * x.index_select(0, self.indices)
        # unsafe: the row pointer was checked on the host (verify_pattern);
        # the checks would read device values back on every call
        return torch.segment_reduce(prod, "sum", offsets=self.indptr,
                                    unsafe=True)


@dataclasses.dataclass(frozen=True)
class ELLOperator(_TrueN):
    """ELL SpMV: ``y = Σ_k values[:, k]·x[cols[:, k]]`` — one rectangular
    gather and a row reduction."""

    values: torch.Tensor  # [n, K]
    cols: torch.Tensor    # int32[n, K]
    m: int

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def vec_dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xg = x.index_select(0, self.cols.view(-1)).view(self.cols.shape)
        return (self.values * xg).sum(1)


@dataclasses.dataclass(frozen=True)
class DIAOperator(_TrueN):
    """Banded (DIA) SpMV: ``y = Σ_d data[d]·shift(x, off_d)`` — no gather;
    the diagonals are added in the JAX package's order (ascending
    offsets), one fused multiply-add launch each."""

    data: torch.Tensor           # [ndiag, n] row-aligned
    offsets: Tuple[int, ...]     # ascending
    m: int

    @property
    def n(self) -> int:
        return self.data.shape[1]

    @property
    def vec_dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        y = torch.zeros(n, dtype=torch.result_type(self.data, x),
                        device=x.device)
        for d, off in enumerate(self.offsets):
            lo, hi = max(0, -off), min(n, self.m - off)
            if hi > lo:
                y[lo:hi].addcmul_(self.data[d, lo:hi], x[lo + off:hi + off])
        return y


@dataclasses.dataclass(frozen=True)
class BELLOperator(_TrueN):
    """Blocked-ELL SpMV: the BSR block rows padded to a uniform ``kmax``
    blocks (padding blocks are zero and point at block column 0), so

        y_r = Σ_k  block(r, k) · xb[cols[r, k]]

    is one gather of whole ``bs``-element blocks of x and one batched GEMV:
    block row r's blocks lie side by side, ``values[r, a, k·bs + b]``, and
    multiply the gathered blocks of x as one ``(bs, kmax·bs)`` matrix."""

    values: torch.Tensor  # [nbr, bs, kmax·bs]
    cols: torch.Tensor    # int32[nbr, kmax]
    n: int
    m: int

    @property
    def bs(self) -> int:
        return self.values.shape[1]

    @property
    def vec_dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def from_csr(cls, csr, bs: int = 128, dtype=torch.float32, *,
                 device="cuda") -> "BELLOperator":
        bsr = csr.to_bsr(block=bs)
        nbr = bsr.nbrows
        counts = np.diff(bsr.indptr)
        kmax = max(int(counts.max()) if nbr else 1, 1)
        values = np.zeros((nbr, bs, kmax, bs), dtype=_np_dtype(dtype))
        cols = np.zeros((nbr, kmax), dtype=np.int32)
        rows_of_block = np.repeat(np.arange(nbr), counts)
        pos = np.arange(len(bsr.indices)) - bsr.indptr[rows_of_block]
        values[rows_of_block, :, pos, :] = bsr.blocks
        cols[rows_of_block, pos] = bsr.indices
        return cls(torch.from_numpy(values.reshape(nbr, bs, kmax * bs)).to(
            device), torch.from_numpy(cols).to(device), csr.n, csr.m)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        bs, (nbr, kmax) = self.bs, self.cols.shape
        nbc = -(-self.m // bs)
        xp = torch.zeros(nbc * bs, dtype=x.dtype, device=x.device)
        xp[: self.m] = x[: self.m]
        xg = xp.view(nbc, bs).index_select(0, self.cols.view(-1))
        y = torch.bmm(self.values, xg.view(nbr, kmax * bs, 1))
        return y.view(-1)[: self.n]


@dataclasses.dataclass(frozen=True)
class DenseOperator(_TrueN):
    """Dense matvec (cuBLAS GEMV) — for tiny systems and tests."""

    a: torch.Tensor  # [n, m]

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[1]

    @property
    def vec_dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mv(self.a, x)


@dataclasses.dataclass(frozen=True)
class SplitOperator:
    """Split-form operator ``A = A0 + diag(d)``: ``matvec(x) = d∘x + A0·x``
    (the reference's mult_spec + csrmv accumulate pair,
    pbicgstab.cu:675-676).  ``d`` lies in ``a0``'s vector layout: on a
    padded ``a0`` it is padded alongside the vectors with zero pads, so the
    padding stays a fixed point."""

    a0: object          # any operator
    d: torch.Tensor     # in a0's layout

    @property
    def n(self) -> int:
        return self.a0.n

    @property
    def m(self) -> int:
        return self.a0.m

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.d * x + self.a0.matvec(x)


def is_padded(op) -> bool:
    """Whether ``op`` runs on padded vectors (every kernel operator) rather
    than true-n ones (the operators of this module)."""
    return getattr(op, "padded", True)


# make_operator's rule, the JAX package's defaults: DIA for at most
# DIA_MAX_DIAGS distinct diagonals holding nnz ≥ DIA_MIN_DENSITY·ndiag·n,
# else ELL when max_row·n ≤ ELL_MAX_EXPAND·nnz, else CSR
DIA_MAX_DIAGS = 16
DIA_MIN_DENSITY = 0.4
ELL_MAX_EXPAND = 4.0


def is_banded(csr) -> bool:
    """Whether ``csr`` is banded by the DIA rule: at most
    ``DIA_MAX_DIAGS`` distinct diagonals holding nnz ≥
    ``DIA_MIN_DENSITY``·ndiag·n.  :func:`make_operator` then picks DIA, and
    the solver the banded kernels."""
    coo = csr.to_coo()
    ndiag = np.unique(coo.cols.astype(np.int64)
                      - coo.rows.astype(np.int64)).shape[0]
    return 0 < ndiag <= DIA_MAX_DIAGS and \
        csr.nnz >= DIA_MIN_DENSITY * ndiag * csr.n


def make_operator(csr, dtype=torch.float64, format: Optional[str] = None,
                  *, device="cuda"):
    """The unpadded operator of a host CSR matrix on ``device``.

    ``format`` forces one of ``"csr"``, ``"ell"``, ``"dia"``, ``"bell"``
    and ``"dense"``; by default DIA where :func:`is_banded`, else ELL when
    max_row·n ≤ ``ELL_MAX_EXPAND``·nnz, else CSR (the JAX package's rule off
    the TPU).  The JAX signature's thresholds are the module's constants
    here, and its ``dense_budget_bytes``, read only by the TPU branch, is
    not taken."""
    if format is None:
        max_row = int(csr.row_lengths.max()) if csr.n else 1
        if is_banded(csr):
            format = "dia"
        elif csr.n and max_row * csr.n <= ELL_MAX_EXPAND * max(csr.nnz, 1):
            format = "ell"
        else:
            format = "csr"
    if format == "bell":
        return BELLOperator.from_csr(csr, dtype=dtype, device=device)
    if format == "dense":
        return DenseOperator(_to(csr.to_dense(), dtype, device))
    if format == "dia":
        dia = csr.to_dia()
        return DIAOperator(_to(dia.data, dtype, device),
                           tuple(int(o) for o in dia.offsets), csr.m)
    if format == "ell":
        ell = csr.to_ell()
        return ELLOperator(_to(ell.values, dtype, device),
                           torch.from_numpy(ell.cols).to(device), csr.m)
    if format == "csr":
        return CSROperator(_to(csr.data, dtype, device),
                           torch.from_numpy(csr.indices).to(device),
                           torch.from_numpy(csr.indptr).to(device),
                           csr.n, csr.m)
    raise ValueError(f"unknown operator format {format!r}")
