"""The unpadded operators, BiCG and an unpadded solve on each device.

This file imports only the port, so it also runs on a machine without JAX
(``python -m pytest --noconftest -m gpu tests/test_torch_unpadded_card.py``
on a card).  Each operator's matvec, called twice on the same input, gives
the same bits, and lies within 1e-12 (f64) / 1e-5 (f32) of max|y| of the
host f64 product; on the card, BiCG and the unpadded solves land within
±6 (h-form, BiCG) or ±2 iterations of the CPU's, x within 1e-8 (1e-6 for
BiCG), and two solves on the card are bitwise equal.  The ``cuda`` cases
skip without a card.
"""

import os

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import operators as tops

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ("csr", "ell", "dia", "bell", "dense")
ON_CARD = pytest.param("cuda", marks=[
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA card")])


@pytest.mark.parametrize("device", ["cpu", ON_CARD])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_matvec_twice_bitwise_and_against_host(fmt, dtype, tol, device):
    a = tprob.random_diag_nonzero_system(300, 0.97, seed=5)[0]
    x = np.random.default_rng(6).standard_normal(a.n)
    op = tops.make_operator(a, dtype=dtype, format=fmt, device=device)
    xd = op.pad_vec(x)
    y1, y2 = op.matvec(xd), op.matvec(xd)
    assert y1.device.type == device and y1.dtype == dtype
    assert torch.equal(y1, y2)
    y_h = a.matvec(x)
    assert np.abs(y1.double().cpu().numpy() - y_h).max() <= \
        tol * np.abs(y_h).max()


def _system():
    a0, b = tprob.random_diag_nonzero_system(128, 0.95, seed=21)
    return ct.CSRMatrix.from_dense(a0.to_dense() + 100.0 * np.eye(128)), b


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
@pytest.mark.parametrize("precond", ["none", "jacobi", "ilu0",
                                     "ilu0_neumann"])
def test_unpadded_solve_on_card_matches_cpu(precond):
    a, b = _system()
    cfg = ct.SolverConfig(maxit=2000, tol=1e-8, precond=precond,
                          trisolve_block=32)
    rc = ct.solve(a, b, cfg, device="cpu")
    ps = ct.make_solver(a, cfg, device="cuda")
    assert not ps.op.padded and ps.device.type == "cuda"
    rg1, rg2 = ps.solve(b), ps.solve(b)
    assert rg1.status == rc.status == ct.SolverStatus.CONVERGED
    assert rg1.iters == rg2.iters and np.array_equal(rg1.x, rg2.x)
    assert abs(rg1.iters - rc.iters) <= (6 if precond == "none" else 2)
    assert np.linalg.norm(rg1.x - rc.x) / np.linalg.norm(rc.x) <= 1e-8


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_bicg_on_card_matches_cpu():
    a = ct.load_mm_sparse_matrix(os.path.join(ROOT, "data", "mat10000.mtx"))
    cfg = ct.SolverConfig(maxit=2000, tol=1e-6)
    rc = ct.bicg(a, np.ones(a.n), cfg, device="cpu")
    rg = ct.bicg(a, np.ones(a.n), cfg, device="cuda")
    assert rg.converged and abs(rg.iters - rc.iters) <= 6
    assert np.linalg.norm(rg.x - rc.x) / np.linalg.norm(rc.x) <= 1e-6
