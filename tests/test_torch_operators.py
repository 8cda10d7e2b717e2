"""The unpadded operators and ``make_operator`` of the port against the JAX
package's, and the forked host formats and random generators.

Inputs are made from a seed with numpy and go through both packages; f64.
Tolerances: each matvec within 1e-13 of max|y| of the JAX operator's (the
two sum each row in other orders); the host formats, the transpose, the
format choice and the generators exactly.  The card's checks are in
``tests/test_torch_unpadded_card.py``.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_mat_tpu.formats.reorder as jreorder
import cuda_mat_tpu.models.problems as jprob
import cuda_mat_tpu.ops.operators as jops
from cuda_mat_tpu.formats.csr import CSRMatrix as JCSRMatrix
from cuda_mat_tpu.io.mmio import load_mm_sparse_matrix as jload

import cuda_mat_tpu_torch as ct
import cuda_mat_tpu_torch.models.problems as tprob
import cuda_mat_tpu_torch.ops.operators as tops

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
FORMATS = ("csr", "ell", "dia", "bell", "dense")


def _jax_matvec(op, x):
    """The JAX operator's matvec, jitted (eager DIA dispatches one slice at
    a time)."""
    return np.asarray(jax.jit(lambda o, v: o.matvec(v))(op, jnp.asarray(x)))


def _as_port(a):
    """The same host CSR as a port matrix."""
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


def _blocky(n=300, bs=32, seed=3):
    """Dense 32×32 blocks on a block tridiagonal, n not a multiple of 32."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n))
    for i in range(0, n, bs):
        for j in range(max(0, i - bs), min(n, i + 2 * bs), bs):
            d[i:i + bs, j:j + bs] = rng.uniform(-1, 1, d[i:i + bs,
                                                         j:j + bs].shape)
    return JCSRMatrix.from_dense(d + 40 * np.eye(n))


def _shuffled_laplacian(side, seed=0):
    a = jprob.banded_laplacian(side)
    perm = np.random.default_rng(seed).permutation(a.n).astype(np.int64)
    return jreorder.permute_csr(a, perm)


MATRICES = {
    "rand60": lambda: jprob.gen_rand_csr_matrix(60, 60, 0.85, -3.0, 3.0,
                                                seed=11),
    "nonsquare50x70": lambda: jprob.gen_rand_csr_matrix(50, 70, 0.8, -1.0,
                                                        1.0, seed=4),
    "mat900": lambda: jload(os.path.join(DATA, "mat900.mtx")),
    "mat10000": lambda: jload(os.path.join(DATA, "mat10000.mtx")),
}
CASES = [(m, f) for m in MATRICES for f in FORMATS
         if (m, f) != ("mat10000", "dense")]


@pytest.mark.parametrize("name,fmt", CASES)
def test_matvec_matches_jax(name, fmt):
    a = MATRICES[name]()
    x = np.random.default_rng(1).standard_normal(a.m)
    oj = jops.make_operator(a, dtype=jnp.float64, format=fmt)
    ot = tops.make_operator(_as_port(a), dtype=torch.float64, format=fmt,
                            device="cpu")
    assert type(ot).__name__ == type(oj).__name__
    assert (ot.n, ot.m) == (oj.n, oj.m) == (a.n, a.m)
    yj = _jax_matvec(oj, x)
    yt = ot.matvec(ot.pad_vec(x))
    assert yt.dtype == torch.float64 and yt.shape == (a.n,)
    assert np.abs(yt.numpy() - yj).max() <= 1e-13 * np.abs(yj).max()


CHOICES = {
    "random system": lambda: jprob.random_diag_nonzero_system(128, 0.95,
                                                              seed=21)[0],
    "mat10000": MATRICES["mat10000"],
    "shuffled laplacian": lambda: _shuffled_laplacian(20),
    "blocky": _blocky,
    "rand60": MATRICES["rand60"],
}


@pytest.mark.parametrize("name", sorted(CHOICES))
def test_make_operator_choice_is_the_jax_off_tpu_choice(name):
    a = CHOICES[name]()
    oj = jops.make_operator(a)
    ot = tops.make_operator(_as_port(a), device="cpu")
    assert type(ot).__name__ == type(oj).__name__
    assert ot.vec_dtype == torch.float64 and ot.device == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(CHOICES))
def test_is_banded_is_the_jax_dia_choice(name):
    a = CHOICES[name]()
    banded = type(jops.make_operator(a)).__name__ == "DIAOperator"
    assert tops.is_banded(_as_port(a)) == banded


def test_rule_constants_are_the_jax_defaults():
    p = inspect.signature(jops.make_operator).parameters
    assert (tops.DIA_MAX_DIAGS, tops.DIA_MIN_DENSITY, tops.ELL_MAX_EXPAND) \
        == tuple(p[k].default for k in ("max_diags", "min_dia_density",
                                        "max_ell_expand"))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_bell_against_csr(dtype, tol):
    """BELL at bs = 32 on a matrix of dense blocks whose order is not a
    multiple of bs, and at the default bs = 128 on a random one, against
    the CSR operator and the host product."""
    for a, bs in ((_as_port(_blocky()), 32),
                  (_as_port(MATRICES["rand60"]()), 128)):
        x = np.random.default_rng(2).standard_normal(a.m)
        bell = tops.BELLOperator.from_csr(a, bs=bs, dtype=dtype, device="cpu")
        csr = tops.make_operator(a, dtype=dtype, format="csr", device="cpu")
        y_b = bell.matvec(bell.pad_vec(x)).double().numpy()
        y_c = csr.matvec(csr.pad_vec(x)).double().numpy()
        y_h = a.matvec(x)
        scale = np.abs(y_h).max()
        assert np.abs(y_b - y_h).max() <= tol * scale
        assert np.abs(y_b - y_c).max() <= tol * scale


def test_split_operator_over_an_unpadded_a0():
    a = _as_port(CHOICES["random system"]())
    a0, d = tprob.split_form(a)
    x = np.random.default_rng(3).standard_normal(a.n)
    for fmt in FORMATS:
        base = tops.make_operator(a0, format=fmt, device="cpu")
        op = tops.SplitOperator(base, base.pad_vec(d))
        y = op.matvec(base.pad_vec(x)).numpy()
        jbase = jops.make_operator(jprob.split_form(JCSRMatrix(
            a.n, a.m, a.data, a.indices, a.indptr))[0], format=fmt)
        yj = _jax_matvec(jops.SplitOperator(jbase, jnp.asarray(d)), x)
        assert np.abs(y - yj).max() <= 1e-13 * np.abs(yj).max()
        assert np.abs(y - a.matvec(x)).max() <= 1e-13 * np.abs(yj).max()


def test_vector_adapters_are_the_identity():
    op = tops.make_operator(_as_port(MATRICES["rand60"]()),
                            dtype=torch.float32, format="ell", device="cpu")
    assert not tops.is_padded(op)
    v = np.arange(60, dtype=np.float64)
    t = op.pad_vec(v)
    assert t.dtype == torch.float32 and t.shape == (60,)
    v[0] = 7.0                     # a host array is copied
    assert float(t[0]) == 0.0
    assert op.unpad_vec(t) is t


def test_unknown_format_raises_the_jax_error():
    a = MATRICES["rand60"]()
    with pytest.raises(ValueError) as e_j:
        jops.make_operator(a, format="coo")
    with pytest.raises(ValueError) as e_t:
        tops.make_operator(_as_port(a), format="coo", device="cpu")
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("gen,args", [
    ("gen_rand_csr_matrix", (70, 50, 0.7, -2.0, 2.0, 0.5, 8)),
    ("gen_rand_vector", (500, 0.3, -1.0, 4.0, 6)),
    ("random_diag_nonzero_system", (300, 0.97, 12)),
])
def test_random_generators_equal_jax_bit_for_bit(gen, args):
    out_j = getattr(jprob, gen)(*args)
    out_t = getattr(tprob, gen)(*args)
    if gen == "random_diag_nonzero_system":
        (out_j, b_j), (out_t, b_t) = out_j, out_t
        np.testing.assert_array_equal(b_t, b_j)
    if gen == "gen_rand_vector":
        np.testing.assert_array_equal(out_t, out_j)
        return
    assert (out_t.n, out_t.m) == (out_j.n, out_j.m)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(out_t, f), getattr(out_j, f))


def test_host_formats_equal_jax():
    """CSR ↔ dense, COO, ELL, BSR and the transpose: the same arrays."""
    a_j = _blocky(100, 16)
    a_t = _as_port(a_j)
    np.testing.assert_array_equal(a_t.to_dense(), a_j.to_dense())
    back = ct.CSRMatrix.from_dense(a_t.to_dense())
    np.testing.assert_array_equal(back.indptr, a_j.indptr)
    for f in ("rows", "cols", "data"):
        np.testing.assert_array_equal(getattr(a_t.to_coo(), f),
                                      getattr(a_j.to_coo(), f))
    e_j, e_t = a_j.to_ell(), a_t.to_ell()
    assert isinstance(e_t, ct.ELLMatrix) and e_t.k == e_j.k
    np.testing.assert_array_equal(e_t.values, e_j.values)
    np.testing.assert_array_equal(e_t.cols, e_j.cols)
    np.testing.assert_array_equal(e_t.to_dense(), a_j.to_dense())
    b_j, b_t = a_j.to_bsr(16), a_t.to_bsr(16)
    assert isinstance(b_t, ct.BSRMatrix) and b_t.nbrows == b_j.nbrows
    for f in ("blocks", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(b_t, f), getattr(b_j, f))
    np.testing.assert_array_equal(b_t.to_dense(), a_j.to_dense())
    x = np.random.default_rng(4).standard_normal(100)
    np.testing.assert_allclose(b_t.matvec(x), a_j.matvec(x), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(e_t.matvec(x), a_j.matvec(x), rtol=1e-13,
                               atol=1e-13)
    r_j = MATRICES["nonsquare50x70"]()
    t_j, t_t = r_j.transpose(), _as_port(r_j).transpose()
    assert (t_t.n, t_t.m) == (70, 50)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(t_t, f), getattr(t_j, f))
