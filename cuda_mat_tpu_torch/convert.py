"""Carry the JAX package's prepared state into the port.

The system has no weights; its state is the prepared operator and
preconditioner.  These functions rebuild them on a torch device from plain
fields (numpy arrays and Python values), so that both packages can run on
exactly the same factors and the solver loop can be compared apart from the
factorization.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops.banded_trisolve import BandedTriSolver
from cuda_mat_tpu_torch.ops.dia_spmv import PallasDIAOperator
from cuda_mat_tpu_torch.ops.stencil import ConstStencilOperator
from cuda_mat_tpu_torch.ops.stencil2d import StencilOperator2D
from cuda_mat_tpu_torch.precond.preconditioners import NeumannILUPreconditioner


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a)).to(dtype=dtype, device=device)


def operator_from_numpy(fields: dict, device) -> ConstStencilOperator:
    """``fields``: the JAX ``ConstStencilOperator``'s fields — ``gapmask``
    (numpy), ``terms``, ``strided_terms``, ``c_grid``, ``stride``, ``n``,
    ``np_true``, ``npad``, ``block``, ``sub`` and ``vec_dtype`` (a dtype
    name)."""
    dtype = getattr(torch, str(np.dtype(fields["vec_dtype"])))
    device = torch.device(device)
    return ConstStencilOperator(
        gapmask=_tensor(fields["gapmask"], dtype, device),
        terms=tuple(tuple(t) for t in fields["terms"]),
        strided_terms=tuple(tuple(t) for t in fields["strided_terms"]),
        c_grid=int(fields["c_grid"]), stride=int(fields["stride"]),
        n=int(fields["n"]), np_true=int(fields["np_true"]),
        npad=int(fields["npad"]), block=int(fields["block"]),
        sub=int(fields["sub"]), vec_dtype=dtype, device=device)


def preconditioner_from_numpy(fields: dict, op: ConstStencilOperator,
                              device) -> NeumannILUPreconditioner:
    """``fields``: the JAX ``NeumannILUPreconditioner``'s state — ``inv_d``
    and ``gap_ext`` (numpy; ``gap_ext`` None unless ``fused == "kernel"``,
    ``inv_d`` empty when ``fused == "mono"``), the terms of both series
    operators (``nl_terms``, ``nl_strided_terms``, ``nu_terms``,
    ``nu_strided_terms``; in "mono" ``nl_*`` hold the composed M⁻¹ and
    ``nu_*`` are None), ``terms`` (k) and ``fused``.  The factor operators
    share ``op``'s layout.  The JAX ``fma_fits`` is not carried: whether
    kernel B5 takes the layout is decided here, for Hopper."""
    device = torch.device(device)

    def series(which):
        if fields.get(f"{which}_terms") is None:
            return None
        return dataclasses.replace(
            op, terms=tuple(tuple(t) for t in fields[f"{which}_terms"]),
            strided_terms=tuple(tuple(t)
                                for t in fields[f"{which}_strided_terms"]))

    nl, nu = series("nl"), series("nu")
    gap_ext = fields.get("gap_ext")
    fused = fields["fused"]
    fma_fits = fused == "kernel" and _kernels.msolve_fma_fits(
        op.block, nl.strided_terms, nu.strided_terms,
        torch.empty((), dtype=op.vec_dtype).element_size())
    return NeumannILUPreconditioner(
        nl, nu, _tensor(fields["inv_d"], op.vec_dtype, device),
        int(fields["terms"]), fused=fused,
        gap_ext=None if gap_ext is None
        else _tensor(gap_ext, op.vec_dtype, device), fma_fits=fma_fits)


def stencil2d_operator_from_numpy(fields: dict, device) -> StencilOperator2D:
    """``fields``: the JAX ``StencilOperator2D``'s fields — ``coeffs`` (a
    tuple of (rp, cp) numpy grids, possibly empty), ``offsets``, ``r``,
    ``c``, ``rp``, ``cp``, ``tr``, ``tc`` and ``vec_dtype`` (a dtype name).
    The grids are stacked into one (n_var, rp, cp) tensor of the vectors'
    dtype."""
    dtype = getattr(torch, str(np.dtype(fields["vec_dtype"])))
    device = torch.device(device)
    rp, cp = int(fields["rp"]), int(fields["cp"])
    grids = [np.asarray(g) for g in fields["coeffs"]]
    coeffs = np.stack(grids) if grids else np.zeros((0, rp, cp))
    return StencilOperator2D(
        coeffs=_tensor(coeffs, dtype, device),
        offsets=tuple((int(o[0]), int(o[1]),
                       None if o[2] is None else float(o[2]))
                      for o in fields["offsets"]),
        r=int(fields["r"]), c=int(fields["c"]), rp=rp, cp=cp,
        tr=int(fields["tr"]), tc=int(fields["tc"]), vec_dtype=dtype,
        device=device)


def banded_trisolver_from_numpy(fields: dict, device) -> BandedTriSolver:
    """``fields``: the JAX ``PallasBandedTriSolver``'s state — ``wt_lo``,
    ``wct_lo``, ``wt_up``, ``wct_up`` (numpy, (nb, B, B)), ``n``,
    ``block`` and ``unroll``.  The arrays keep their dtype and layout.  Its
    ``fused`` field has no counterpart: both of its values compute the same
    two sweeps, which is what the port's msolve runs."""
    arrays = [torch.as_tensor(np.array(fields[k])).to(device)
              for k in ("wt_lo", "wct_lo", "wt_up", "wct_up")]
    return BandedTriSolver(*arrays, n=int(fields["n"]),
                           block=int(fields["block"]),
                           unroll=int(fields["unroll"]))


def dia_operator_from_numpy(fields: dict, device) -> PallasDIAOperator:
    """``fields``: the JAX ``PallasDIAOperator``'s fields — ``data`` (a
    tuple of (npad,) numpy diagonals, or one (ndiag, npad) array),
    ``offsets``, ``n``, ``block``, ``sub`` and ``vec_dtype`` (a dtype
    name).  The diagonals are stacked into one (ndiag, npad) tensor of
    the vectors' dtype."""
    dtype = getattr(torch, str(np.dtype(fields["vec_dtype"])))
    device = torch.device(device)
    data = np.stack([np.asarray(d) for d in fields["data"]])
    return PallasDIAOperator(
        data=_tensor(data, dtype, device),
        offsets=tuple(int(o) for o in fields["offsets"]),
        n=int(fields["n"]), block=int(fields["block"]),
        sub=int(fields["sub"]), vec_dtype=dtype, device=device)
