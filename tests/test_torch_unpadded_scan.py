"""Iteration counts of the unpadded-operator solves whose windows
``chip_smoke.py``'s path 5 holds: the JAX package (CPU) beside the PyTorch
port (CPU) at several torch thread counts, which change the order of the
port's sums.

- the CLI's random system, ``random_diag_nonzero_system(n, 0.99,
  seed=0)``, b = ones, no preconditioner, f32, tol 1e-4: every solve breaks
  down (as the reference's does), at an iteration that moves with the sum
  order alone (``RANDOM_SYSTEM`` / ``BREAKDOWN_ITERS``);
- ``banded_laplacian(side)`` numbered at random (the permutation of
  ``np.random.default_rng(0)``), b = ones, f64, tol 1e-6: Jacobi, and RCM
  + Neumann-ILU k = 3 (``JACOBI_1M_ITERS`` / ``NEUMANN_1M_ITERS`` at side
  1000).

The same solves under symmetric renumberings P·A·Pᵀ (the permutations of
``np.random.default_rng(seed)``, seeds 1..K) are the same systems with b =
ones in other sum orders: their counts on the JAX package are the
reference's spread, the second witness for a count read on the card.

Run as a script:

    PYTHONPATH=. python tests/test_torch_unpadded_scan.py random 10000
    PYTHONPATH=. python tests/test_torch_unpadded_scan.py shuffled 316 1000
    PYTHONPATH=. python tests/test_torch_unpadded_scan.py renumbered random 10000 16
    PYTHONPATH=. python tests/test_torch_unpadded_scan.py renumbered shuffled 1000 6

(the random system at n = 10000 takes ~1 GB and a minute; the 1M-row
shuffled grid a few minutes a solve).  The tests check the smallest cases.
"""

import sys

import numpy as np
import pytest
import torch

import cuda_mat_tpu as cm
import cuda_mat_tpu.formats.reorder as jreorder
import cuda_mat_tpu.models.problems as jprob

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob

THREADS = (1, 2, 4, 8)
RANDOM_CFG = dict(maxit=2000, tol=1e-4, dtype="float32")
SHUFFLED = {"jacobi": dict(maxit=5000, tol=1e-6, precond="jacobi"),
            "rcm + neumann k=3": dict(maxit=2000, tol=1e-6,
                                      precond="ilu0_neumann",
                                      neumann_terms=3, reorder="rcm")}


def random_counts(n, formats=("csr", "ell"), threads=THREADS):
    """``{(package, format, threads): (status, iterations)}`` of the random
    system's unpreconditioned f32 solve."""
    a_j, _ = jprob.random_diag_nonzero_system(n, 0.99, seed=0)
    a_t, _ = tprob.random_diag_nonzero_system(n, 0.99, seed=0)
    b = np.ones(n)
    out = {}
    for fmt in formats:
        r = cm.solve(a_j, b, cm.SolverConfig(**RANDOM_CFG), format=fmt)
        out["jax", fmt, None] = (r.status.name, r.iters)
        for th in threads:
            torch.set_num_threads(th)
            r = ct.solve(a_t, b, ct.SolverConfig(**RANDOM_CFG), format=fmt,
                         device="cpu")
            out["port", fmt, th] = (r.status.name, r.iters)
    return out


def shuffled(side):
    a = jprob.banded_laplacian(side)
    a_j = jreorder.permute_csr(
        a, np.random.default_rng(0).permutation(a.n).astype(np.int64))
    return a_j, ct.CSRMatrix(a_j.n, a_j.m, a_j.data, a_j.indices,
                             a_j.indptr)


def shuffled_counts(side, threads=(1, 4)):
    """``{(package, solve, threads): (status, iterations)}`` on the
    shuffled grid."""
    a_j, a_t = shuffled(side)
    b = np.ones(a_t.n)
    out = {}
    for name, kw in SHUFFLED.items():
        r = cm.solve(a_j, b, cm.SolverConfig(**kw))
        out["jax", name, None] = (r.status.name, r.iters)
        for th in threads:
            torch.set_num_threads(th)
            r = ct.solve(a_t, b, ct.SolverConfig(**kw), device="cpu")
            out["port", name, th] = (r.status.name, r.iters)
    return out


def renumbered_counts(system, size, seeds, formats=None):
    """``{(package, solve, seed): (status, iterations)}`` of the JAX
    package's CPU solves (and the port's, one thread) of ``system``
    ("random": the unpreconditioned f32 solve in each of ``formats``;
    "shuffled": Jacobi in f64) renumbered by each seed's permutation."""
    if system == "random":
        a_j, _ = jprob.random_diag_nonzero_system(size, 0.99, seed=0)
        solves = {fmt: (dict(RANDOM_CFG), fmt)
                  for fmt in formats or ("csr", "ell", "bell", "dense")}
    else:
        a_j, _ = shuffled(size)
        solves = {"jacobi": (SHUFFLED["jacobi"], None)}
    b = np.ones(a_j.n)
    torch.set_num_threads(1)
    out = {}
    for seed in seeds:
        ap = jreorder.permute_csr(a_j, np.random.default_rng(seed)
                                  .permutation(a_j.n).astype(np.int64))
        ap_t = ct.CSRMatrix(ap.n, ap.m, ap.data, ap.indices, ap.indptr)
        for name, (kw, fmt) in solves.items():
            r = cm.solve(ap, b, cm.SolverConfig(**kw), format=fmt)
            out["jax", name, seed] = (r.status.name, r.iters)
            r = ct.solve(ap_t, b, ct.SolverConfig(**kw), format=fmt,
                         device="cpu")
            out["port", name, seed] = (r.status.name, r.iters)
    return out


def test_renumbered_random_system_breaks_down_on_both_packages():
    counts = renumbered_counts("random", 300, (1, 2), ("csr", "ell"))
    assert len(counts) == 8
    assert {s for s, _ in counts.values()} == {"BREAKDOWN"}


def test_random_system_breaks_down_at_every_sum_order():
    counts = random_counts(500, threads=(1, 2))
    torch.set_num_threads(1)
    assert {s for s, _ in counts.values()} == {"BREAKDOWN"}


def test_shuffled_grid_counts_agree_with_jax():
    """Side 30 (900 rows): both solves converge on both packages, within
    ±2 iterations of each other in f64."""
    counts = shuffled_counts(30, threads=(1, 2))
    torch.set_num_threads(1)
    for name in SHUFFLED:
        s_j, it_j = counts["jax", name, None]
        for th in (1, 2):
            s_t, it_t = counts["port", name, th]
            assert s_t == s_j == "CONVERGED" and abs(it_t - it_j) <= 2


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if sys.argv[1] == "renumbered":
        system, size, k = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        for seed in range(1, k + 1):
            counts = renumbered_counts(system, size, (seed,))
            for (pkg, what, _), (status, it) in counts.items():
                print(f"renumbered {system} {size} seed {seed} {pkg} {what}:"
                      f" {status} {it}", flush=True)
        sys.exit(0)
    mode, sizes = sys.argv[1], [int(a) for a in sys.argv[2:]]
    for size in sizes:
        counts = (random_counts(size, ("csr", "ell", "bell")) if mode ==
                  "random" else shuffled_counts(size))
        for (pkg, what, th), (status, it) in counts.items():
            print(f"{mode} {size} {pkg} {what}"
                  f"{'' if th is None else f' threads {th}'}: {status} {it}",
                  flush=True)
