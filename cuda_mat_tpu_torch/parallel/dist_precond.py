"""Distributed block-Jacobi ILU(0) (counterpart of
:mod:`cuda_mat_tpu.parallel.dist_precond`,
cuda_mat_tpu/parallel/dist_precond.py:1-88).

Exact ILU(0) is a global sequential recurrence and does not distribute.
Block Jacobi does: each row shard factorizes its own diagonal block
``A_ss`` by ILU(0) and applies ``M⁻¹ = diag(M_0⁻¹ … M_{p-1}⁻¹)``, with no
communication.  Couplings across shards leave M (not A), which weakens the
preconditioner as the shard count grows.  A process's S shards solve
together: block b of every shard is one batched step of
:class:`~cuda_mat_tpu_torch.ops.trisolve.BlockTriangularSolver`, so an
msolve takes one shard's launches whatever S is.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cuda_mat_tpu_torch.formats.coo import COOMatrix
from cuda_mat_tpu_torch.formats.csr import CSRMatrix
from cuda_mat_tpu_torch.ops.trisolve import (BlockTriangularSolver,
                                             _block_setup_tri)
from cuda_mat_tpu_torch.parallel.partition import RowPartitionedBanded
from cuda_mat_tpu_torch.utils import timing


def _local_block_csr(part: RowPartitionedBanded, shard: int) -> CSRMatrix:
    """CSR of shard ``shard``'s diagonal block A_ss in local indices, from
    the padded DIA data (dist_precond.py:27-44; padded rows are identity,
    so every row has a diagonal and ILU(0) is well posed)."""
    sr = part.shard_rows
    lo = shard * sr
    rows, cols, vals = [], [], []
    for k, off in enumerate(part.offsets):
        seg = part.data[k, lo:lo + sr]
        r = np.arange(sr)
        c = r + off
        ok = (c >= 0) & (c < sr) & (seg != 0)
        rows.append(r[ok])
        cols.append(c[ok])
        vals.append(seg[ok])
    return CSRMatrix.from_coo(COOMatrix(
        sr, sr, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals)))


def build_block_jacobi_ilu(part: RowPartitionedBanded, trisolve_block: int,
                           dtype, milu_omega: float = 0.0
                           ) -> Tuple[np.ndarray, ...]:
    """Each shard's ILU(0) and blocked-trisolve arrays, stacked on a
    leading shard axis (dist_precond.py:47-78): ``(w_lo, vals_lo, cols_lo,
    w_up, vals_up, cols_up)``, shaped ``(ndev, nb, B, B)`` and ``(ndev, nb,
    B, K)``, K padded with zeros to the widest shard's.  ``dtype``: the
    values' numpy or torch dtype (indices stay int32).  ``milu_omega``:
    relaxed modified-ILU(0) values per shard."""
    from cuda_mat_tpu_torch.precond.preconditioners import _factorize

    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    per_shard = []
    for s in range(part.ndev):
        local = _local_block_csr(part, s)
        with timing.span("precond.factor"):
            mvals = _factorize(local, milu_omega)
        lo = _block_setup_tri(local, mvals, trisolve_block, lower=True)
        up = _block_setup_tri(local, mvals, trisolve_block, lower=False)
        per_shard.append((lo, up))

    def stack(idx_tri, idx_arr, pad_k=False):
        arrs = [ps[idx_tri][idx_arr] for ps in per_shard]
        if pad_k:
            kmax = max(a.shape[-1] for a in arrs)
            arrs = [np.pad(a, ((0, 0), (0, 0), (0, kmax - a.shape[-1])))
                    for a in arrs]
        return np.stack(arrs).astype(
            np.int32 if arrs[0].dtype.kind == "i" else np.dtype(dtype))

    return (stack(0, 0), stack(0, 1, True), stack(0, 2, True),
            stack(1, 0), stack(1, 1, True), stack(1, 2, True))


def local_solver_from_stacked(w_lo, vals_lo, cols_lo, w_up, vals_up, cols_up,
                              shard_rows: int, trisolve_block: int
                              ) -> BlockTriangularSolver:
    """The solver of this process's shards from their ``(S, ...)`` slices
    of the stacked arrays, as device tensors (dist_precond.py:81-88, where
    each shard holds a ``(1, ...)`` slice).  Its msolve takes ``(S,
    shard_rows)`` vectors."""
    return BlockTriangularSolver(w_lo, vals_lo, cols_lo.long(), w_up, vals_up,
                                 cols_up.long(), n=shard_rows,
                                 block=trisolve_block)
