"""The port's distributed solver across two processes on the CPU (gloo),
in the spirit of tests/test_multihost.py: 2 ranks × 2 row shards.

The module spawns the two ranks of ``tests/torch_parallel_runner.py`` once
(about 4 s) and its tests read their JSON lines:

- ``dist_spmv`` within rtol 1e-12 of the host product on each rank;
- the overlapped matvec (halo strips in flight while the interior rows are
  multiplied) bitwise equal to the unsplit one across processes;
- Jacobi and ilu0_neumann (tol 1e-8) converge to a true relative residual
  below 1e-6, both ranks report the same status and iterations and the
  same x, and the count lies within ±2 of the same solve on one process
  with 4 shards (the processes sum the dot partials in another order);
  each rank records each solve with the single-device solve's spans, its
  ``dt_alg`` the record's ``solve.loop``;
- the "stencil" engine on ``grid_laplacian(64, 126)``: its matvec and
  fused msolve in the split form (across the ranks) bitwise equal to the
  scatter form, and its const-factor Neumann solve, plain and with
  fuse_blas1, as the solves above: the same on both ranks, within ±2
  iterations of one process with 4 shards.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_parallel_runner.py")
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, RUNNER, str(r), str(WORLD), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        cwd=REPO) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        got.append(json.loads(out.strip().splitlines()[-1]))
    return got


@pytest.fixture(scope="module")
def one_process():
    """The same solves on one process holding all 4 shards."""
    import torch

    from cuda_mat_tpu_torch.config import SolverConfig
    from cuda_mat_tpu_torch.models.problems import banded_laplacian
    from cuda_mat_tpu_torch.parallel import dist_bicgstab, make_mesh

    torch.set_num_threads(1)
    a = banded_laplacian(20)
    rng = np.random.default_rng(7)
    rng.standard_normal(a.n)
    b = rng.uniform(1.0, 5.0, a.n)
    mesh = make_mesh(2 * WORLD, device="cpu")
    got = {p: dist_bicgstab(a, b, mesh, SolverConfig(maxit=2000, tol=1e-8,
                                                     precond=p))
           for p in ("jacobi", "ilu0_neumann")}
    # the runner's stencil cases (its STENCIL_CFG): its rng after the
    # first b
    from cuda_mat_tpu_torch.models.problems import grid_laplacian

    g = grid_laplacian(64, 126)
    rng.standard_normal(g.n)
    bg = rng.uniform(1.0, 5.0, g.n)
    for tag, extra in (("stencil", {}), ("stencil_fma", {"fuse_blas1": True})):
        got[tag] = dist_bicgstab(g, bg, mesh, SolverConfig(
            maxit=2000, tol=1e-8, precond="ilu0_neumann", neumann_terms=3,
            **extra), local_engine="stencil")
    return got


def test_each_rank_holds_two_shards_and_multiplies(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r in ranks:
        assert r["shards"] == 2
        assert r["spmv_err"] <= 1e-12


def test_overlapped_matvec_is_bitwise_across_processes(ranks):
    assert all(r["overlap_bitwise"] for r in ranks)


@pytest.mark.parametrize("precond", ["jacobi", "ilu0_neumann"])
def test_each_rank_records_its_solves(ranks, precond):
    spans = sorted(["solve", "solve.prep", "solve.prep.b", "solve.prep.x0",
                    "solve.prep.sync", "solve.loop", "loop.step",
                    "loop.poll", "solve.finish"])
    for r in ranks:
        g = r[precond]
        assert g["record"] == ["solve", g["iters"], True, spans]


@pytest.mark.parametrize("what", ["matvec", "msolve"])
def test_stencil_split_form_is_bitwise_across_processes(ranks, what):
    assert all(r[f"stencil_{what}_bitwise"] for r in ranks)


@pytest.mark.parametrize("precond", ["jacobi", "ilu0_neumann", "stencil",
                                     "stencil_fma"])
def test_ranks_converge_together(ranks, one_process, precond):
    got = [r[precond] for r in ranks]
    for g in got:
        assert g["status"] == "CONVERGED" and g["rel"] < 1e-6
    assert got[0]["iters"] == got[1]["iters"]
    assert got[0]["x_head"] == got[1]["x_head"]
    ref = one_process[precond]
    assert ref.converged
    assert abs(got[0]["iters"] - ref.iters) <= 2
