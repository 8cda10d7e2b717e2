"""Iteration counts of Neumann-series ILU(0) BiCGSTAB with exact factors on
the narrow-band Laplacian family grid_laplacian(R, 100): k = 3, f32,
b = ones, x0 = ones, tol 1e-4, in two configurations —

- ``pallas_dia``: ``format="pallas_dia"``, A and both factors banded DIA
  operators (kernel B3 on the card);
- ``stencil_exact``: the stencil operator (B1) with
  ``neumann_const_factors=False``, the exact factors restrided into its
  gap-strided layout (B3).

They anchor the window chip_smoke.py holds its 10M-row solves (R = 100000)
to.  Run as a script, one package at a time, for larger R:

    PYTHONPATH=. python tests/test_torch_neumann_scan.py jax 500 1000 2000
    PYTHONPATH=. python tests/test_torch_neumann_scan.py port 500 1000 2000

prints the counts of the JAX package (Pallas in interpret mode) or of the
port (CPU, plain twins); a ``float64`` argument runs the same protocol in
f64.  ``... dots`` prints how far each package's f32 dot on the CPU lies
from the exact one as the length grows: XLA's CPU sums f32 dots of
padded vectors with an error growing about linearly in their length, torch
does not, so in f32 the JAX package's CPU counts are no anchor for the
port's.  Restriding only relabels rows, so both
configurations apply the same preconditioner.  The test checks the
smallest grid.
"""

import sys

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct

# configuration -> (format, neumann_const_factors)
CONFIGS = {"pallas_dia": ("pallas_dia", True),
           "stencil_exact": ("stencil", False)}


def _config(pkg, name, dtype="float32"):
    return pkg.SolverConfig(maxit=2000, tol=1e-4, dtype=dtype,
                            precond="ilu0_neumann", neumann_terms=3,
                            neumann_const_factors=CONFIGS[name][1])


def jax_solve(rows, name, dtype="float32"):
    a = jprob.grid_laplacian(rows, 100)
    return cm.solve(a, np.ones(a.n), _config(cm, name, dtype),
                    format=CONFIGS[name][0])


def port_solve(rows, name, dtype="float32"):
    a = ct.grid_laplacian(rows, 100)
    return ct.solve(a, np.ones(a.n), _config(ct, name, dtype),
                    format=CONFIGS[name][0], device="cpu")


def test_small_grid_counts_agree():
    """grid_laplacian(30, 100): the port converges in both configurations,
    within 2 iterations of each other and within the f32 slack (±15) of
    the JAX package's stencil-layout solve (its DIA solve, which the scan
    found equal at every size, runs Pallas in interpret mode at ~0.2 s
    per iteration)."""
    torch.set_num_threads(1)
    rj = jax_solve(30, "stencil_exact")
    assert rj.converged
    its = []
    for name in CONFIGS:
        rt = port_solve(30, name)
        assert rt.converged and np.isfinite(rt.x).all()
        assert abs(rt.iters - rj.iters) <= 15
        its.append(rt.iters)
    assert abs(its[0] - its[1]) <= 2


def dot_errors():
    """Relative error of each package's f32 dot of a vector with itself,
    values uniform in [0.5, 1.5) from seed 0, against the f64 sum."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for n in (50_000, 200_000, 1_000_000, 10_000_000):
        x = rng.uniform(0.5, 1.5, n).astype(np.float32)
        exact = float(np.dot(x.astype(np.float64), x.astype(np.float64)))
        j = float(jnp.dot(jnp.asarray(x), jnp.asarray(x)))
        t = float(torch.dot(torch.from_numpy(x), torch.from_numpy(x)))
        print(f"n {n}: f32 dot relative error jax {abs(j / exact - 1):.2e},"
              f" torch {abs(t / exact - 1):.2e}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "dots":
        dot_errors()
        sys.exit()
    which = sys.argv[1]
    solve = {"jax": jax_solve, "port": port_solve}[which]
    dtype = "float32"
    rows = []
    for arg in sys.argv[2:]:
        if arg.startswith("float"):
            dtype = arg
        else:
            rows.append(int(arg))
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    for r in rows or [500, 1000, 2000]:
        for name in CONFIGS:
            res = solve(r, name, dtype)
            print(f"rows {r * 100} {name} {dtype}: {which}"
                  f" {res.status.name} {res.iters} it", flush=True)
