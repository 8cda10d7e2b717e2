"""Iteration counts of the unpreconditioned h-form loop (``bicgstab``) on
the square 5-point Laplacian grid_laplacian(s, s), f64, tol 1e-6,
b = x0 = ones, with A on kernel B1 (the gap-strided stencil) and on kernel
B7 (``StencilOperator2D``).  They anchor the window chip_smoke.py holds
its 3163 × 3163 (10M-row) solves to.  The script imports only the port, so
it runs on the card's machine too:

    PYTHONPATH=. python tests/test_torch_hform_scan.py cpu 100 300 1000 2000
    PYTHONPATH=. python tests/test_torch_hform_scan.py cuda 1000 2000 2500 3163

prints, for each side s, both kernels' status, iterations and ms per
iteration.  The test checks the smallest grids on the CPU: both operators
apply the same A (B7's A·x equals B1's bit for bit on the Laplacian), so
only their dots, over vectors of other lengths, part the trajectories.
"""

import sys

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch as ct

CFG = ct.SolverConfig(maxit=20000, tol=1e-6, dtype="float64",
                      true_residual=False)


def scan(side: int, device, tr: int = 256, tc: int = 512):
    """``(B1 result, B7 result)`` of the h-form solve on an s × s grid;
    ``tr``/``tc``: B7's tiles (the defaults are the operator's)."""
    b = np.ones(side * side)
    r1 = ct.bicgstab(ct.grid_laplacian(side, side), b, CFG, device=device)
    op = ct.StencilOperator2D.laplacian(side, side, torch.float64, tr=tr,
                                        tc=tc, device=device)
    return r1, ct.solve(op, b, CFG, device=device)


@pytest.mark.parametrize("side", [30, 60])
def test_both_kernels_take_about_1_2_iterations_per_grid_row(side):
    """At these sides both take 1.1-1.3 iterations per grid row (the port's
    CPU runs: 120 at s = 100, 350 at 300, 1203 at 1000) and agree within
    15%, the window chip_smoke.py holds the 10M grid's solves to."""
    r1, r7 = scan(side, "cpu", tr=32, tc=128)
    assert r1.converged and r7.converged
    for r in (r1, r7):
        assert 1.0 * side <= r.iters <= 1.4 * side
    assert abs(r1.iters - r7.iters) <= 0.15 * r1.iters


if __name__ == "__main__":
    torch.set_num_threads(2)
    for s in map(int, sys.argv[2:]):
        res = scan(s, sys.argv[1])
        print(f"side {s}: " + ", ".join(
            f"{k} {r.status.name} {r.iters} it"
            f" {r.dt_alg * 1e3 / max(r.iters, 1):.4f} ms/iter"
            for k, r in zip(("B1", "B7"), res)), flush=True)
