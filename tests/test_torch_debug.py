"""``debug=True`` in the port's loops against the JAX package's
``jax.debug.print`` lines, on the CPU in f64.

For ``hform_core`` (precond none), ``precond_core`` (exact ILU(0), with and
without ``check_halves``) and BiCG, on mat3 (with vec3) and mat900 (b =
ones), both packages' lines are read as a mapping from (prefix, index) to
value: ``jax.debug.print`` fixes no order between two prints of one
iteration. The keys must be equal. The values must agree to 1e-10 of the
larger of the value and the run's largest residual: the two packages sum
their dots and matvecs in other orders, and a residual recursion's rounding
is relative to the residuals it came from (the h-form's last residuals on
mat900 part by ~1e-7 of themselves but 3e-13 of the first). With and
without ``debug`` the port's x, iterations and status are equal, bit for
bit, and each line equals the port's own residual history.
"""

import contextlib
import io
import os
import re

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.solvers.bicgstab import debug_nans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's block inverses in the ILU(0) setups:
    under the test run's parallel workers, OpenBLAS's spinning threads
    stall them."""
    with threadpool_limits(1):
        yield
# (id, kwargs of SolverConfig, entry point)
LOOPS = [
    ("hform", dict(precond="none"), "solve"),
    ("precond", dict(precond="ilu0"), "solve"),
    ("precond no halves", dict(precond="ilu0", check_halves=False), "solve"),
    ("bicg", dict(), "bicg"),
]


def _system(pkg, name):
    a = pkg.load_mm_sparse_matrix(os.path.join(ROOT, "data", f"{name}.mtx"))
    if name == "mat3":
        _, coo = pkg.read_mm(os.path.join(ROOT, "data", "vec3.mtx"))
        return a, pkg.to_dense_vector(pkg.CSRMatrix.from_coo(coo))
    return a, np.ones(a.n)


def _lines(text):
    """{(prefix, index): value} of the debug lines in ``text``."""
    out = {}
    for line in text.splitlines():
        head, value = line.rsplit(" ", 1)
        idx = re.search(r"= (\d+),", head)
        key = (re.sub(r"\d+,", "#,", head), int(idx[1]) if idx else None)
        assert key not in out, line
        out[key] = float(value)
    return out


def _run(pkg, name, kw, entry, **extra):
    a, b = _system(pkg, name)
    cfg = pkg.SolverConfig(dtype="float64", tol=1e-10, **kw, **extra)
    f = io.StringIO()
    with contextlib.redirect_stdout(f):
        if pkg is cm:
            r = getattr(cm, entry)(a, b, cfg)
            jax.effects_barrier()
        else:
            r = getattr(ct, entry)(a, b, cfg, device="cpu")
    return r, f.getvalue()


@pytest.mark.parametrize("name", ["mat3", "mat900"])
@pytest.mark.parametrize("loop", LOOPS, ids=[c[0] for c in LOOPS])
def test_debug_lines_match_jax(loop, name):
    tag, kw, entry = loop
    if name == "mat3" and kw.get("precond") == "ilu0":
        # mat3's structural zero pivot: ILU(0) raises in both (ROADMAP C5)
        with pytest.raises(ValueError):
            _run(ct, name, kw, entry, debug=True)
        return
    r_j, out_j = _run(cm, name, kw, entry, debug=True)
    r_t, out_t = _run(ct, name, kw, entry, debug=True)
    l_j, l_t = _lines(out_j), _lines(out_t)
    assert set(l_t) == set(l_j)
    top = max(abs(v) for v in l_j.values())
    for k, v in l_j.items():
        assert abs(l_t[k] - v) <= 1e-10 * max(abs(v), top), (k, l_t[k], v)
    assert r_t.iters == r_j.iters and r_t.status == r_j.status


@pytest.mark.parametrize("name", ["mat3", "mat900"])
@pytest.mark.parametrize("loop", LOOPS, ids=[c[0] for c in LOOPS])
def test_debug_changes_nothing_and_prints_the_history(loop, name):
    tag, kw, entry = loop
    if name == "mat3" and kw.get("precond") == "ilu0":
        return
    plain, quiet = _run(ct, name, kw, entry)
    r, out = _run(ct, name, kw, entry, debug=True)
    assert quiet == ""
    assert r.iters == plain.iters and r.status == plain.status
    assert np.array_equal(r.x, plain.x)
    lines = _lines(out)
    hist = plain.residual_history
    for (head, i), v in lines.items():
        if i is None:
            assert v == plain.residual0
        elif "(before precond)" in head:
            assert v == hist[2 * i]
        elif entry == "bicg" or tag == "hform":
            assert v == hist[i]
        else:
            assert v == hist[2 * i + 1] or (hist[2 * i + 1] == -1
                                            and v == hist[2 * i])
    # one residual line a step: the loop counter before the step, in order
    steps = [i for (head, i) in lines if i is not None
             and "(before precond)" not in head]
    assert steps == list(range(len(steps)))


def test_debug_nans_raises_where_the_loop_reports_breakdown():
    """A = [[0, 1], [1, 0]], b = (1, 2), x0 = ones: <r0, A r0> = 0, so the
    first h-form residual is NaN; the solve reports BREAKDOWN, and inside
    ``debug_nans()`` raises FloatingPointError naming iteration 0; the
    block's end restores the default."""
    a = ct.CSRMatrix.from_dense(np.array([[0.0, 1.0], [1.0, 0.0]]))
    b = np.array([1.0, 2.0])
    r = ct.solve(a, b, ct.SolverConfig(), device="cpu")
    assert r.status == ct.SolverStatus.BREAKDOWN and r.iters == 1
    with pytest.raises(FloatingPointError, match="at iteration 0"):
        with debug_nans():
            ct.solve(a, b, ct.SolverConfig(), device="cpu")
    with debug_nans():
        with debug_nans(False):
            r2 = ct.solve(a, b, ct.SolverConfig(), device="cpu")
    assert r2.status == ct.SolverStatus.BREAKDOWN
    assert ct.solve(a, b, ct.SolverConfig(), device="cpu").iters == 1


def test_config_fields_are_the_jax_packages():
    """A config means the same to both packages: the same fields and
    defaults (the port's global switches are not fields)."""
    assert vars(ct.SolverConfig()) == vars(cm.SolverConfig())


def test_loop_watch_reads_once_per_iteration(monkeypatch):
    """``debug`` adds no device read a step: the loop's one ``tolist`` a
    step carries the residuals (the solve's other reads are the same)."""
    a, b = _system(ct, "mat900")
    reads = []
    real = torch.Tensor.tolist

    def counted(t):
        reads.append(t.shape)
        return real(t)

    counts = {}
    for debug in (False, True):
        reads.clear()
        monkeypatch.setattr(torch.Tensor, "tolist", counted)
        with contextlib.redirect_stdout(io.StringIO()):
            r = ct.solve(a, b, ct.SolverConfig(precond="ilu0", debug=debug),
                         device="cpu")
        monkeypatch.setattr(torch.Tensor, "tolist", real)
        counts[debug] = len(reads)
    assert counts[False] == counts[True] >= r.iters
