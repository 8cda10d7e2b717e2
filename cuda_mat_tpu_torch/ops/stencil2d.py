"""2-D grid-stencil SpMV on tile-ring padded grids (counterpart of the 2-D
half of :mod:`cuda_mat_tpu.ops.pallas_stencil`): the front end
:func:`stencil_spmv_padded` (kernel B7) beside its plain PyTorch twin, and
:class:`StencilOperator2D`, the device operator built on it.

An R×C grid is stored as a flat ``(rp + 2·tr) × (cp + 2·tc)`` array: the
grid rounded up to whole ``tr × tc`` tiles, with one ring of zero tiles
around it.  The output is zero on the ring, so padded grids are a fixed
point of the operator and whole solver iterations run on them.  Each
stencil term is ``(dr, dc, scal)``: a scalar coefficient, or ``scal`` None
for a variable one, which takes the next (rp, cp) grid of a stacked
``(n_var, rp, cp)`` coefficient tensor.  Where any term is scalar and the
padded grid is larger than the true one, cells past (r, c) are masked to 0.
The tile sizes are the JAX package's, chosen for the TPU; on Hopper they
only fix the padding, kept so both packages' padded vectors are identical.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cuda_mat_tpu_torch.ops import _kernels
from cuda_mat_tpu_torch.ops.stencil import _coef


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _needs_mask(offsets, rp: int, cp: int, r: int, c: int) -> bool:
    return any(o[2] is not None for o in offsets) and (rp != r or cp != c)


def _check(coeffs, x_pad, offsets, tr, tc, rp, cp) -> None:
    if x_pad.dim() != 1 or x_pad.shape[0] != (rp + 2 * tr) * (cp + 2 * tc):
        raise ValueError(f"x_pad must be flat of length (rp + 2tr)(cp + 2tc)"
                         f" = {(rp + 2 * tr) * (cp + 2 * tc)}, got"
                         f" {tuple(x_pad.shape)}")
    if rp % tr or cp % tc:
        raise ValueError(f"grid {rp}x{cp} is not whole {tr}x{tc} tiles")
    if not offsets or any(abs(o[0]) > tr or abs(o[1]) > tc for o in offsets):
        raise ValueError("stencil offsets must be non-empty and within one"
                         " tile")
    n_var = sum(o[2] is None for o in offsets)
    if tuple(coeffs.shape) != (n_var, rp, cp):
        raise ValueError(f"coeffs must have shape ({n_var}, {rp}, {cp}),"
                         f" got {tuple(coeffs.shape)}")


def stencil_spmv_padded_plain(coeffs: torch.Tensor, x_pad: torch.Tensor,
                              offsets, tr: int, tc: int, rp: int, cp: int,
                              r: int, c: int) -> torch.Tensor:
    """Plain PyTorch twin of kernel B7, in the JAX kernel's op order: each
    term ``coeff·x`` over the shifted (rp, cp) window of the 2-D view of
    ``x_pad``, summed left to right, masked past (r, c) where
    :func:`stencil_spmv_padded` masks, and set into a zero ring."""
    x2 = x_pad.view(rp + 2 * tr, cp + 2 * tc)
    acc = None
    ci = 0
    for dr, dc, scal in offsets:
        win = x2[tr + dr:tr + dr + rp, tc + dc:tc + dc + cp]
        if scal is None:
            term = coeffs[ci] * win
            ci += 1
        else:
            term = _coef(scal, x_pad.dtype) * win
        acc = term if acc is None else acc + term
    if _needs_mask(offsets, rp, cp, r, c):
        acc[r:, :] = 0
        acc[:, c:] = 0
    y = torch.zeros_like(x2)
    y[tr:tr + rp, tc:tc + cp] = acc
    return y.view(-1)


def stencil_spmv_padded(coeffs: torch.Tensor, x_pad: torch.Tensor, offsets,
                        tr: int, tc: int, rp: int, cp: int, r: int,
                        c: int) -> torch.Tensor:
    """``y_pad = A x_pad`` on tile-ring padded grids (flat vectors;
    counterpart of ``cuda_mat_tpu.ops.pallas_stencil.stencil_spmv_padded``).

    ``offsets``: tuple of ``(dr, dc, scal or None)``; the None entries take
    the grids of ``coeffs`` ((n_var, rp, cp)) in order.  CPU tensors run the
    plain twin, CUDA tensors kernel B7."""
    _check(coeffs, x_pad, offsets, tr, tc, rp, cp)
    if x_pad.device.type == "cpu":
        return stencil_spmv_padded_plain(coeffs, x_pad, offsets, tr, tc, rp,
                                         cp, r, c)
    y = _kernels.stencil2d_spmv(coeffs, x_pad, offsets, tr, tc, rp, cp, r, c,
                                _needs_mask(offsets, rp, cp, r, c))
    stencil_spmv_padded.launches += 1
    return y


stencil_spmv_padded.launches = 0


def reset_launch_counts() -> None:
    """Set kernel B7's launch count to 0."""
    stencil_spmv_padded.launches = 0


@dataclasses.dataclass(frozen=True)
class StencilOperator2D:
    """Device operator for an R×C grid stencil over tile-ring padded grids
    (counterpart of ``cuda_mat_tpu.ops.pallas_stencil.StencilOperator2D``),
    with the solver loops' ``pad_vec``/``unpad_vec``/``matvec`` protocol:
    :func:`~cuda_mat_tpu_torch.solvers.bicgstab.solve` takes it in place of
    a matrix."""

    coeffs: torch.Tensor        # (n_var, rp, cp) variable-coefficient grids
    offsets: Tuple[Tuple[int, int, object], ...]  # (dr, dc, scal | None)
    r: int                      # true grid rows
    c: int                      # true grid cols
    rp: int                     # padded rows (a multiple of tr)
    cp: int                     # padded cols (a multiple of tc)
    tr: int                     # tile rows
    tc: int                     # tile cols
    vec_dtype: torch.dtype
    device: torch.device

    @property
    def n(self) -> int:
        return self.r * self.c

    @property
    def m(self) -> int:
        return self.n

    @classmethod
    def laplacian(cls, r: int, c: int, dtype=torch.float32, tr: int = 256,
                  tc: int = 512, constant: bool = True,
                  device="cuda") -> "StencilOperator2D":
        """5-point Laplacian (diagonal 4, neighbours −1) — the mat10000
        and bench family.  Every boundary is the zero ring, so
        ``constant=True`` needs no coefficient grid; ``constant=False``
        builds the same operator with one (rp, cp) grid per term, the form
        any grid stencil can take."""
        rp, cp = _round_up(r, tr), _round_up(c, tc)
        device = torch.device(device)
        if constant:
            offsets = ((-1, 0, -1.0), (0, -1, -1.0), (0, 0, 4.0),
                       (0, 1, -1.0), (1, 0, -1.0))
            coeffs = torch.zeros((0, rp, cp), dtype=dtype)
        else:
            diag = torch.zeros((rp, cp), dtype=dtype)
            diag[:r, :c] = 4.0
            row = torch.zeros((rp, cp), dtype=dtype)
            row[:r, :c] = -1.0
            offsets = ((-1, 0, None), (0, -1, None), (0, 0, None),
                       (0, 1, None), (1, 0, None))
            coeffs = torch.stack([row, row, diag, row, row])
        return cls(coeffs.to(device), offsets, r, c, rp, cp, tr, tc, dtype,
                   device)

    def pad_vec(self, v) -> torch.Tensor:
        """True-grid vector (length n, host or device) → flat padded grid
        on ``device``."""
        g = torch.zeros((self.rp + 2 * self.tr, self.cp + 2 * self.tc),
                        dtype=self.vec_dtype, device=self.device)
        v2 = torch.as_tensor(v).to(self.vec_dtype).reshape(self.r, self.c)
        g[self.tr:self.tr + self.r, self.tc:self.tc + self.c] = v2.to(
            self.device)
        return g.view(-1)

    def unpad_vec(self, v_pad: torch.Tensor) -> torch.Tensor:
        g = v_pad.view(self.rp + 2 * self.tr, self.cp + 2 * self.tc)
        return g[self.tr:self.tr + self.r,
                 self.tc:self.tc + self.c].reshape(-1)

    def matvec(self, x_pad: torch.Tensor) -> torch.Tensor:
        return stencil_spmv_padded(self.coeffs, x_pad, self.offsets, self.tr,
                                   self.tc, self.rp, self.cp, self.r, self.c)
