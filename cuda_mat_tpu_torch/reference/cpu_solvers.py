"""Host numpy ILU(0) factorization (copy of
:func:`cuda_mat_tpu.reference.cpu_solvers.ilu0_factorize`), the fallback of
the native factorizer."""

from __future__ import annotations

import numpy as np


def ilu0_factorize(a) -> np.ndarray:
    """Incomplete LU with zero fill-in on the CSR pattern of ``a``.

    Returns the combined factor values ``m`` (same pattern/indices as ``a``):
    strictly-lower entries hold L (unit diagonal implied), diagonal + upper
    hold U — what ``cusparseDcsrilu0`` computes in place (reference
    pbicgstab.cu:316,357-359).  Requires a nonzero stored diagonal
    (reference pbicgstab.h:118).
    """
    n = a.n
    m = a.data.astype(np.float64).copy()
    indptr, indices = a.indptr, a.indices
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        js = indices[lo:hi]
        k = np.searchsorted(js, i)
        if k >= js.shape[0] or js[k] != i:
            raise ValueError(f"ILU(0) requires a stored nonzero diagonal (row {i})")
        diag_pos[i] = lo + k
    # row-wise IKJ elimination restricted to the sparsity pattern
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        for kk in range(lo, int(diag_pos[i])):
            k = indices[kk]
            pivot = m[diag_pos[k]]
            if pivot == 0.0:
                # lazy check: a stored-zero diagonal can become nonzero
                # during elimination before any row uses it
                raise ValueError(f"ILU(0) zero pivot at row {k}")
            m[kk] = m[kk] / pivot
            lik = m[kk]
            klo, khi = int(diag_pos[k]) + 1, indptr[k + 1]
            if klo >= khi:
                continue
            row_i_js = indices[kk + 1:hi]
            row_k_js = indices[klo:khi]
            pos_in_i = np.searchsorted(row_i_js, row_k_js)
            ok = (pos_in_i < row_i_js.shape[0])
            ok[ok] &= row_i_js[pos_in_i[ok]] == row_k_js[ok]
            m[kk + 1 + pos_in_i[ok]] -= lik * m[klo:khi][ok]
    return m
