"""Dense Givens-QR and linear-system analysis (numpy copy of
:mod:`cuda_mat_tpu.utils.dense_qr`).

Counterpart of the reference's dense host-side side module
(``Matrix.h``/``givens.h``/``util.h``): Givens-rotation QR
(givens.h:24-84), row-echelon rank (givens.h:88-97), the Kronecker–Capelli
consistency check (givens.h:101-112) and back substitution (the intended
semantics of givens.h:119-134, whose loop ``for(j=A.n-1; j>i; ++j)`` never
ends).  The reference excluded this module from its build
(CMakeLists.txt:17).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def givens_rotation(n: int, i: int, j: int, a: float, b: float) -> np.ndarray:
    """n×n Givens rotation G(i, j) that zeroes component j against i
    (reference givens.h:24-54)."""
    r = np.hypot(a, b)
    c, s = (1.0, 0.0) if r == 0 else (a / r, b / r)
    g = np.eye(n)
    g[i, i] = c
    g[j, j] = c
    g[i, j] = s
    g[j, i] = -s
    return g


def qr_givens(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """QR factorization via Givens rotations (reference givens.h:57-84).
    Returns (Q, R) with A = Q @ R, R upper triangular."""
    a = np.asarray(a, dtype=np.float64)
    m, n = a.shape
    r = a.copy()
    q = np.eye(m)
    for col in range(min(m, n)):
        for row in range(m - 1, col, -1):
            if r[row, col] != 0.0:
                g = givens_rotation(m, col, row, r[col, col], r[row, col])
                r = g @ r
                q = q @ g.T
    return q, r


def rank_row_echelon(a: np.ndarray, tol: float = 1e-12) -> int:
    """Rank via the row-echelon (triangularized) form (reference
    givens.h:88-97)."""
    _, r = qr_givens(a)
    return int(np.sum(np.max(np.abs(r), axis=1) > tol))


def is_consistent(a: np.ndarray, b: np.ndarray, tol: float = 1e-12) -> bool:
    """Kronecker–Capelli: Ax=b is consistent iff rank(A) == rank([A|b])
    (reference givens.h:101-112)."""
    a = np.asarray(a, dtype=np.float64)
    aug = np.hstack([a, np.asarray(b, dtype=np.float64).reshape(-1, 1)])
    return rank_row_echelon(a, tol) == rank_row_echelon(aug, tol)


def back_substitution(r: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Solve upper-triangular R x = y."""
    r = np.asarray(r, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = r.shape[1]
    x = np.zeros(n)
    for i in range(n - 1, -1, -1):
        x[i] = (y[i] - r[i, i + 1:n] @ x[i + 1:n]) / r[i, i]
    return x


def solve_qr(a: np.ndarray, b: np.ndarray,
             tol: float = 1e-12) -> Optional[np.ndarray]:
    """Dense solve via Givens QR; returns None for inconsistent systems."""
    if not is_consistent(a, b, tol):
        return None
    q, r = qr_givens(a)
    return back_substitution(r, q.T @ np.asarray(b, dtype=np.float64))
