"""Banded (DIA) SpMV on block-halo padded vectors (counterpart of
:mod:`cuda_mat_tpu.ops.pallas_spmv`).

Row-aligned DIA data: diagonal ``d`` contributes ``data[d, i] · x[i + off_d]``,
no gather.  Vectors live padded: ``n`` rows padded to ``npad`` (a multiple of
``block``) with a zero tail, and one zero block of ``block`` rows on each
side, with ``block ≥ sub ≥`` the bandwidth, so every shifted read of x stays
inside the array.  The kernel writes zero pads, so padding is a fixed point
of the matvec and of every BLAS1 op, and the whole solver iteration runs on
padded vectors.  ``sub`` and ``block`` follow the JAX package's rules (its
TPU kernel streamed x in ``sub``-sized halo pieces); on Hopper they only fix
pad widths, and keeping them makes both packages' padded vectors identical.

The kernel front end :func:`dia_spmv_block_padded` (kernel B3) sits beside
its plain PyTorch twin; it sends a CPU tensor to the twin and a CUDA tensor
to the hand-written kernel (:mod:`._kernels`), or raises — it never falls
back — and keeps a plain-int ``launches`` count of kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cuda_mat_tpu_torch.ops import _kernels


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check(data: torch.Tensor, x_pad: torch.Tensor, offsets, block: int,
           sub: int) -> None:
    batch = x_pad.dim() == 2
    if data.dim() != 2 + batch or data.shape[0] != len(offsets) \
            or not offsets:
        raise ValueError(f"data must be (ndiag, npad) with one row per offset"
                         f" (or (ndiag, S, npad) for a batch (S, L) of x),"
                         f" got {tuple(data.shape)} for {len(offsets)}"
                         " offsets")
    npad = data.shape[-1]
    if npad % block or block % sub:
        raise ValueError(f"npad {npad}, block {block} and sub {sub} must"
                         " nest: block | npad, sub | block")
    if max(abs(o) for o in offsets) > sub:
        raise ValueError("diagonal offsets must lie within the halo"
                         f" sub-block {sub}")
    want = data.shape[1:-1] + (npad + 2 * block,)
    if tuple(x_pad.shape) != want:
        raise ValueError(f"x_pad must have shape {want}, got"
                         f" {tuple(x_pad.shape)}")
    if data.dtype != x_pad.dtype:
        raise ValueError(f"data and x_pad differ in dtype: {data.dtype} vs"
                         f" {x_pad.dtype}")


def dia_spmv_block_padded_plain(data: torch.Tensor, x_pad: torch.Tensor,
                                offsets, block: int,
                                sub: int) -> torch.Tensor:
    """Plain PyTorch twin of kernel B3, in the JAX kernel's op order: the
    first diagonal's product, then one add of each further diagonal's
    product in ascending-offset order, over the whole true-block range;
    both pad blocks written as 0.  A batch ``(S, L)`` of x takes ``data``
    ``(ndiag, S, npad)``, each shard on its own."""
    npad = data.shape[-1]
    acc = None
    for d, off in enumerate(offsets):
        term = data[d] * x_pad[..., block + off:block + off + npad]
        acc = term if acc is None else acc + term
    y = torch.zeros_like(x_pad)
    y[..., block:block + npad] = acc
    return y


def dia_spmv_block_padded(data: torch.Tensor, x_pad: torch.Tensor,
                          offsets: Tuple[int, ...], block: int,
                          sub: int) -> torch.Tensor:
    """``y_pad = A x_pad`` on block-halo padded vectors (counterpart of
    ``cuda_mat_tpu.ops.pallas_spmv.dia_spmv_block_padded``).

    ``data``: (ndiag, npad) row-aligned diagonals, zero past n; ``offsets``:
    ascending, each within ``sub``; ``x_pad``: (npad + 2·block,) with zero
    pad blocks.  A batch of S row shards, ``x_pad`` ``(S, npad + 2·block)``
    and ``data`` ``(ndiag, S, npad)``, runs in one launch, each shard on its
    own.  CPU tensors run the plain twin, CUDA tensors kernel B3."""
    _check(data, x_pad, offsets, block, sub)
    if x_pad.device.type == "cpu":
        return dia_spmv_block_padded_plain(data, x_pad, offsets, block, sub)
    y = _kernels.dia_spmv(data, x_pad, offsets, block)
    dia_spmv_block_padded.launches += 1
    return y


dia_spmv_block_padded.launches = 0


def reset_launch_counts() -> None:
    """Set the kernel's launch count to 0."""
    dia_spmv_block_padded.launches = 0


@dataclasses.dataclass(frozen=True)
class PallasDIAOperator:
    """Banded operator over block-halo padded vectors on ``device``, applied
    by kernel B3 (counterpart of ``cuda_mat_tpu.ops.pallas_spmv.
    PallasDIAOperator``, whose name it keeps).  ``matvec`` maps padded
    vectors to padded vectors; :meth:`pad_vec` / :meth:`unpad_vec` convert
    at the boundary."""

    data: torch.Tensor         # (ndiag, npad) row-aligned diagonals
    offsets: Tuple[int, ...]   # ascending
    n: int                     # true dimension
    block: int
    sub: int                   # halo sub-block (bandwidth <= sub <= block)
    vec_dtype: torch.dtype
    device: torch.device

    @property
    def m(self) -> int:
        return self.n

    @property
    def npad(self) -> int:
        return self.data.shape[1]

    @classmethod
    def from_dia(cls, dia, dtype=torch.float32, block: int = 32768,
                 device="cuda") -> "PallasDIAOperator":
        """The JAX package's layout: ``sub`` = the bandwidth rounded up to
        1024, ``block`` = max(block, sub) rounded up to a multiple of
        ``sub``, ``npad`` = n rounded up to ``block``.  (A diagonal matrix,
        bandwidth 0, gets sub = 1024; the JAX rule would make it 0.)"""
        offsets = tuple(int(o) for o in dia.offsets)
        sub = _round_up(max(dia.bandwidth, 1), 1024)
        block = _round_up(max(block, sub), sub)
        npad = _round_up(dia.n, block)
        data = np.zeros((len(offsets), npad),
                        dtype=str(dtype).removeprefix("torch."))
        data[:, :dia.n] = dia.data
        device = torch.device(device)
        return cls(torch.from_numpy(data).to(device), offsets, dia.n, block,
                   sub, dtype, device)

    def pad_vec(self, v) -> torch.Tensor:
        """True-coordinate vector (length n, host or device) → padded
        vector on ``device``."""
        v = torch.as_tensor(v)
        out = torch.zeros(self.npad + 2 * self.block, dtype=self.vec_dtype,
                          device=self.device)
        out[self.block:self.block + v.shape[0]] = v.to(self.vec_dtype).to(
            self.device)
        return out

    def unpad_vec(self, v_pad: torch.Tensor) -> torch.Tensor:
        return v_pad[self.block:self.block + self.n]

    def matvec(self, x_pad: torch.Tensor) -> torch.Tensor:
        return dia_spmv_block_padded(self.data, x_pad, self.offsets,
                                     self.block, self.sub)
