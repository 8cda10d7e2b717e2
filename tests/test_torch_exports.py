"""The JAX package's import paths and keywords in the port (ROADMAP A14).

Every name a JAX subpackage re-exports (its ``__all__``) imports from the
port's subpackage of the same name, and the two ``__all__`` lists agree;
``make_operator`` takes the JAX thresholds as keywords and picks the same
format with them; ``ConstStencilOperator.nnz`` counts what the JAX
operator's does.  The JAX package re-exports ``solvers.bicgstab`` and
``solvers.bicg`` as functions, shadowing their modules, and so does the
port (import the modules by their full name).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu.ops.operators as jops
import cuda_mat_tpu.ops.pallas_stencil as jst
from cuda_mat_tpu.formats.csr import CSRMatrix as JCSR
from cuda_mat_tpu.models import problems as jprob

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.ops.operators as tops
import cuda_mat_tpu_torch.ops.stencil as tst

SUBPACKAGES = ("formats", "io", "models", "ops", "precond", "reference",
               "solvers", "parallel", "utils")


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_imports_from_the_port(sub):
    jmod = importlib.import_module(f"cuda_mat_tpu.{sub}")
    tmod = importlib.import_module(f"cuda_mat_tpu_torch.{sub}")
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in jmod.__all__:
        got = getattr(tmod, name)
        want = getattr(jmod, name)
        assert type(got).__name__ == type(want).__name__, name
        if hasattr(want, "__name__"):
            assert got.__name__.split(".")[-1] == \
                want.__name__.split(".")[-1], name


def _rand(n, p0, seed, shift):
    return JCSR.from_dense(jprob.gen_rand_csr_matrix(
        n, n, p0, 0.5, 2.0, seed=seed).to_dense() + shift * np.eye(n))


# (matrix, keywords): each keyword moves the choice across its threshold
KEYWORD_CASES = [
    ("band, default", lambda: jprob.banded_laplacian(13), {}),
    ("band, max_diags 4", lambda: jprob.banded_laplacian(13),
     {"max_diags": 4}),
    ("band, density 0.99", lambda: jprob.banded_laplacian(13),
     {"min_dia_density": 0.99}),
    ("band, density 0.99, ell 1.0", lambda: jprob.banded_laplacian(13),
     {"min_dia_density": 0.99, "max_ell_expand": 1.0}),
    ("random, default", lambda: _rand(60, 0.9, 3, 20.0), {}),
    ("random, ell 1.0", lambda: _rand(60, 0.9, 3, 20.0),
     {"max_ell_expand": 1.0}),
    ("random, max_diags 200", lambda: _rand(20, 0.7, 4, 20.0),
     {"max_diags": 200, "min_dia_density": 0.0}),
    # JAX reads dense_budget_bytes in its TPU branch only and drops it
    # here; the port, which has no such branch, refuses any other value
    ("random, dense budget", lambda: _rand(60, 0.9, 3, 20.0),
     {"dense_budget_bytes": 1}),
]


@pytest.mark.parametrize("case", KEYWORD_CASES,
                         ids=[c[0] for c in KEYWORD_CASES])
def test_make_operator_keywords_match_jax(case):
    _, make, kw = case
    a = make()
    op_j = jops.make_operator(a, jnp.float64, **kw)
    if "dense_budget_bytes" in kw:
        with pytest.raises(ValueError, match="TPU branch"):
            tops.make_operator(_port(a), torch.float64, **kw, device="cpu")
        kw = {k: v for k, v in kw.items() if k != "dense_budget_bytes"}
        assert type(op_j) is type(jops.make_operator(a, jnp.float64, **kw))
    op_t = tops.make_operator(_port(a), torch.float64, **kw, device="cpu")
    assert type(op_t).__name__ == type(op_j).__name__
    x = np.random.default_rng(0).standard_normal(a.n)
    np.testing.assert_allclose(
        op_t.matvec(torch.from_numpy(x)).numpy(),
        np.asarray(op_j.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12)


def test_make_operator_signature_is_jax():
    import inspect

    pj = inspect.signature(jops.make_operator).parameters
    pt = inspect.signature(tops.make_operator).parameters
    names = [k for k in pj if k not in ("csr", "dtype")]
    assert [k for k in pt if k in names] == names
    for k in names:
        assert pt[k].default == pj[k].default, k


@pytest.mark.parametrize("make", [
    lambda: jprob.grid_laplacian(64, 126),
    lambda: jprob.laplacian_2d(10),
    lambda: jprob.grid_laplacian(9, 12),
], ids=["grid 64x126", "laplacian_2d(10)", "grid 9x12"])
def test_const_stencil_nnz_matches_jax(make):
    a = make()
    op_j = jst.ConstStencilOperator.from_dia(a.to_dia(max_diags=16),
                                             jnp.float64, interpret=True)
    op_t = tst.ConstStencilOperator.from_dia(_port(a).to_dia(max_diags=16),
                                             torch.float64, device="cpu")
    assert op_t.nnz == op_j.nnz == a.nnz
