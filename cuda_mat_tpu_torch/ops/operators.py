"""Composite operators (counterpart of :mod:`cuda_mat_tpu.ops.operators`,
trimmed to :class:`SplitOperator`; the unpadded CSR/ELL/DIA/BELL/dense
operators and ``make_operator`` are not ported yet, ROADMAP A2/A8)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SplitOperator:
    """Split-form operator ``A = A0 + diag(d)``: ``matvec(x) = d∘x + A0·x``
    (the reference's mult_spec + csrmv accumulate pair,
    pbicgstab.cu:675-676).  On a padded ``a0``, ``d`` is padded alongside
    the vectors with zero pads, so the padding stays a fixed point."""

    a0: object          # a padded operator
    d: torch.Tensor     # in a0's layout

    @property
    def n(self) -> int:
        return self.a0.n

    @property
    def m(self) -> int:
        return self.a0.m

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.d * x + self.a0.matvec(x)
