"""One application of the Neumann-series ILU(0) preconditioner (kernel B2),
M^-1 x ~ P_u (inv_d * (P_l x)) with k-term series P_l, P_u of the strict
triangles: x and inv_d read once and y written once over the true rows;
the series' coefficients are constants, and no padding is counted.
Operations: Horner's form of each triangle's series, k - 1 products with
the triangle's off-diagonal entries (a multiply and an add each), and the
inv_d scaling."""


def nbytes(rec) -> int:
    return 3 * rec.n * rec.itemsize


def nflops(rec) -> int:
    k = int(rec.config["solver"]["neumann_terms"])
    return 2 * (k - 1) * (rec.nnz - rec.n) + rec.n


def per_solve(row) -> int:
    """Two preconditioner applications an executed step."""
    return 2 * row.steps
