"""A = the benchmark's CSR arrays, held as rows padded to the longest row
(ELL), applied by a gather, a multiply and a row sum in plain PyTorch, in
any dtype, in blocks of rows."""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 24


class CSROperator:
    def __init__(self, indptr, indices, data, device, dtype):
        indptr = torch.as_tensor(indptr, device=device).long()
        lengths = indptr[1:] - indptr[:-1]
        self.n = int(lengths.numel())
        width = int(lengths.max()) if self.n else 0
        row = torch.repeat_interleave(torch.arange(self.n, device=device),
                                      lengths)
        slot = torch.arange(row.numel(), device=device) - indptr[row]
        self.cols = torch.zeros((self.n, width), dtype=torch.long,
                                device=device)
        self.vals = torch.zeros((self.n, width), dtype=dtype, device=device)
        self.cols[row, slot] = torch.as_tensor(indices, device=device).long()
        self.vals[row, slot] = torch.as_tensor(data, device=device).to(dtype)
        self.dtype = dtype
        self.diag = torch.where(self.cols == torch.arange(
            self.n, device=device)[:, None], self.vals,
            torch.zeros((), dtype=dtype, device=device)).sum(dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.empty(self.n, dtype=self.dtype, device=x.device)
        for i in range(0, self.n, BLOCK_ROWS):
            j = min(i + BLOCK_ROWS, self.n)
            y[i:j] = (self.vals[i:j] * x[self.cols[i:j]]).sum(dim=1)
        return y
