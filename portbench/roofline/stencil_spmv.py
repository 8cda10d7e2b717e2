"""y = A x for a constant-coefficient grid stencil (kernel B1): x read once
and y written once over the true rows.  The matrix is no input: a stencil
operator carries its coefficients as constants, so neither values nor
indices are counted, and no padding.  Operations: a multiply and an add
per nonzero."""


def nbytes(rec) -> int:
    return 2 * rec.n * rec.itemsize


def nflops(rec) -> int:
    return 2 * rec.nnz


def per_solve(row) -> int:
    """BiCGSTAB's matvecs in a solve: the initial residual, then two an
    executed step."""
    return 1 + 2 * row.steps
