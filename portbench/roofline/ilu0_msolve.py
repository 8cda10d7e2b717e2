"""One application of the exact ILU(0) preconditioner, M^-1 x = U^-1 L^-1 x
(kernels B4a/B4b): the factor values on A's pattern read once (nnz(A)
values at the solve's precision: L's strict part and U with its
diagonal), the input read once and the output written once.  No indices,
no padding and no arrays of one implementation's blocking are counted.
Operations: a multiply and an add for each off-diagonal factor entry, and
a division a row."""


def nbytes(rec) -> int:
    return (rec.nnz + 2 * rec.n) * rec.itemsize


def nflops(rec) -> int:
    return 2 * (rec.nnz - rec.n) + rec.n


def per_solve(row) -> int:
    """Two preconditioner applications an executed step."""
    return 2 * row.steps
