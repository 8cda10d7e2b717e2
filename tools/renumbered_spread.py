#!/usr/bin/env python3
"""Iteration counts of the solves whose windows ``chip_smoke.py``'s path 5
gates, under symmetric renumberings P·A·Pᵀ of their systems, on one device.

    python3 tools/renumbered_spread.py random 10000 16 [cuda|cpu]
    python3 tools/renumbered_spread.py shuffled 1000 6 [cuda|cpu]

Seed s (1..K) renumbers by ``np.random.default_rng(s).permutation``.  With
b = ones each renumbering is the same system in another sum order, so the
spread of the counts is what rounding alone moves them by: "random" is 5a's
unpreconditioned f32 solve of the CLI's random system in each format,
"shuffled" 5b (i)'s Jacobi solve (f64) of the shuffled grid.  For
"random" each line also gives the first iterate's max|x₁ − x₁,f64| /
max|x₁,f64| against the f64 solve of the same renumbering stopped after one
iteration on the CPU (``chip_smoke.first_iterate_err``).
``tests/test_torch_unpadded_scan.py renumbered`` gives the JAX package's
counts (and the port's on the CPU) on the same renumberings.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import cuda_mat_tpu_torch as ct  # noqa: E402
from cuda_mat_tpu_torch.formats import reorder  # noqa: E402
from cuda_mat_tpu_torch.models import problems  # noqa: E402


def main(system, size, k, device="cuda"):
    if system == "random":
        a, _ = problems.random_diag_nonzero_system(
            size, cs.RANDOM_SYSTEM[1], seed=0)
        cfg = ct.SolverConfig(maxit=2000, tol=1e-4, dtype="float32")
        formats = cs.UNPADDED[:-1]
    else:
        a = cs.shuffled_laplacian(size)
        cfg = ct.SolverConfig(maxit=5000, tol=1e-6, precond="jacobi")
        formats = (None,)
    b = np.ones(a.n)
    for seed in range(1, k + 1):
        ap = reorder.permute_csr(a, np.random.default_rng(seed)
                                 .permutation(a.n).astype(np.int64))
        ref = cs.first_iterate_ref(ap, b, cfg) if system == "random" \
            else None
        for fmt in formats:
            r = ct.solve(ap, b, cfg, format=fmt, device=device)
            first = "" if ref is None else (
                f", first iterate"
                f" {cs.first_iterate_err(ap, b, cfg, fmt, device, ref)!r}")
            print(f"renumbered {system} {size} seed {seed} {device}"
                  f" {fmt or 'auto'}: {r.status.name} {r.iters}{first}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
