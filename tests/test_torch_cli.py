"""The port's command line against the JAX package's, on the CPU.

Each case runs both CLIs in-process on the same arguments (both with
``--platform cpu`` and an explicit ``--dtype``: this process has JAX's x64
on) and compares the exit code, ``success`` or the ``method failed:
<STATUS>`` line, the iterations within the ROADMAP's slack (exact ILU(0)
±2, h-form and BiCG ±6, f32 ILU(0) ±15), the relative residual against the
tolerance, ``-P``'s printed x to 1e-6, and the error messages, which must
be identical.  Cases with ``--format`` hold the port's CLI against the JAX
library's ``solve(a, b, cfg, format=...)``, because the JAX CLI drops the
flag (ROADMAP C8, recorded by ``test_jax_cli_drops_format_the_port_honours
_it``).  ``--devices`` runs the distributed solver in both CLIs, held
against each other with the distributed solves' slack (±5); the port's own
rejections (``--format``/``--reorder`` with ``--devices``, ROADMAP C11; no
card) and flags with no JAX counterpart here (``--profile``,
``--debug-nans``) have tests of their own below.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import cuda_mat_tpu as cm
from cuda_mat_tpu.cli import main as jax_main
from cuda_mat_tpu.io import omp_format as j_omp
from cuda_mat_tpu.models.problems import (banded_laplacian, gen_rand_vector,
                                          random_diag_nonzero_system)

import cuda_mat_tpu_torch.ops.operators as tops
from cuda_mat_tpu_torch.cli import main as port_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAT3, VEC3, MAT900, MAT10K = (os.path.join(REPO, "data", f"{n}.mtx") for n
                              in ("mat3", "vec3", "mat900", "mat10000"))
ILU, HFORM, BICG, ILU32 = 2, 6, 6, 15      # iteration slack (ROADMAP)
# the random system's Jacobi solve has no ROADMAP slack: its f64 trajectory
# parts from the last bit (the JAX package's own count moves 78 → 88 when
# one entry of b moves by one ulp), so the port's count must lie in the JAX
# package's range over every one-ulp change of b
ULP_SPREAD = None
F64 = ["--dtype", "float64"]

# (id, arguments, iteration slack); "{tmp}" is the test's tmp_path
CLI_CASES = [
    ("mat900 default", ["-M", MAT900] + F64, ILU),
    ("mat3 vec3 -P", ["-M", MAT3, "-V", VEC3, "--precond", "none", "-P"]
     + F64, HFORM),
    ("random jacobi", ["-N", "64", "-R", "0.97", "--precond", "jacobi",
                       "--maxit", "500"] + F64, ULP_SPREAD),
    ("debug", ["-M", MAT3, "-V", VEC3, "--precond", "none", "-D"] + F64,
     HFORM),
    ("bicg", ["-M", MAT3, "-V", VEC3, "--solver", "bicg", "--precond",
              "none"] + F64, BICG),
    ("reorder rcm", ["-M", MAT900, "--reorder", "rcm"] + F64, ILU),
    ("omp format", ["-M", "{tmp}/mat.txt", "-V", "{tmp}/vec.txt",
                    "--omp-format", "--solver", "bicg", "--precond", "none"]
     + F64, BICG),
    ("nonsquare", ["-M", VEC3] + F64, 0),
    ("bad vector dim", ["-M", MAT900, "-V", VEC3] + F64, 0),
    ("bicg refine", ["-M", MAT900, "--solver", "bicg", "--refine"] + F64, 0),
    ("refine", ["-M", MAT900, "--refine"] + F64, ILU32),
    ("f32 mat10000", ["-M", MAT10K, "--dtype", "float32"], ILU32),
    ("devices ilu0", ["-M", MAT900, "--devices", "4"] + F64, 0),
]

# (id, arguments): the JAX side is cm.solve(a, b, cfg, format=...)
FORMAT_CASES = [
    ("neumann exact factors", ["-M", MAT900, "--precond", "ilu0_neumann",
                               "--format", "stencil",
                               "--neumann-exact-factors"]),
    ("fuse blas1", ["-M", MAT900, "--precond", "ilu0_neumann", "--format",
                    "stencil", "--fuse-blas1"]),
    ("format bell", ["-M", MAT900, "--format", "bell", "--precond", "none"]),
    ("format pallas_dia", ["-M", MAT900, "--format", "pallas_dia"]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """mat10000's ILU(0) setup inverts its blocks with numpy: under the
    test run's parallel workers, OpenBLAS threads stall it."""
    with threadpool_limits(1):
        yield


def _run(main, argv, capsys):
    rc = main(argv)
    jax.effects_barrier()
    out, err = capsys.readouterr()
    return rc, out, err


def _summary(out):
    """The lines of a run that both packages print alike."""
    s = {"lines": []}
    for line in out.splitlines():
        m = re.match(r"iterations = (\d+), relative residual = (\S+)", line)
        if m:
            s["iters"], s["rel"] = int(m[1]), float(m[2])
        elif line.startswith("true relative residual = "):
            s["rel_true"] = float(line.split("= ")[1])
        elif line.startswith("("):
            s["x"] = [float(t) for t in line.strip("()").split()]
        elif not re.match(r"(algorithm|setup|total) .*time|initial norm|"
                          r"k = |i = |iter = |gpu, init", line):
            s["lines"].append(line)
    return s


def _failure(err):
    m = re.match(r"method failed: (\w+) after (\d+) iterations", err)
    return (m[1], int(m[2])) if m else None


def _ulp_range(args):
    """min and max iterations of the JAX package's solves of the CLI's
    random system with each entry of b moved one ulp up and down."""
    n, p = int(args[args.index("-N") + 1]), float(args[args.index("-R") + 1])
    a, _ = random_diag_nonzero_system(n, p, seed=0)
    b = gen_rand_vector(n, 0.2, 1.0, 5.0, seed=1)
    ps = cm.make_solver(a, cm.SolverConfig(
        maxit=int(args[args.index("--maxit") + 1]), dtype="float64",
        precond=args[args.index("--precond") + 1]))
    its = []
    for k in range(n):
        for to in (np.inf, -np.inf):
            bk = b.copy()
            bk[k] = np.nextafter(bk[k], to)
            its.append(ps.solve(bk).iters)
    return min(its), max(its)


def _write_omp(tmp_path):
    a = banded_laplacian(8)
    b = np.random.default_rng(42).uniform(1.0, 5.0, 64)
    j_omp.write_matrix(str(tmp_path / "mat.txt"), a)
    j_omp.write_vector(str(tmp_path / "vec.txt"), b)


@pytest.mark.parametrize("case", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_cli_matches_jax(case, tmp_path, capsys):
    name, args, slack = case
    _write_omp(tmp_path)
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    rc_j, out_j, err_j = _run(jax_main, args + ["--platform", "cpu"], capsys)
    rc_t, out_t, err_t = _run(port_main, args + ["--platform", "cpu"],
                              capsys)
    assert rc_t == rc_j, (out_t, err_t)
    s_j, s_t = _summary(out_j), _summary(out_t)
    assert s_t["lines"] == s_j["lines"]
    if rc_j == 0:
        if slack is ULP_SPREAD:
            lo, hi = _ulp_range(args)
            assert lo <= s_t["iters"] <= hi
        else:
            assert abs(s_t["iters"] - s_j["iters"]) <= slack
        tol = float(args[args.index("--tol") + 1]) if "--tol" in args \
            else 1e-6
        if "--refine" not in args:
            assert s_t["rel"] < tol and s_j["rel"] < tol
        if "x" in s_j:
            np.testing.assert_allclose(s_t["x"], s_j["x"], atol=1e-6)
    elif rc_j == 2:
        (st_j, it_j), (st_t, it_t) = _failure(err_j), _failure(err_t)
        assert st_t == st_j and abs(it_t - it_j) <= slack
    else:
        assert err_t == err_j
    if name == "debug":
        assert "initial norm = " in out_t and "k = 0, norm = " in out_t


@pytest.mark.parametrize("case", FORMAT_CASES,
                         ids=[c[0] for c in FORMAT_CASES])
def test_cli_format_matches_jax_library(case, capsys):
    """The port's CLI with ``--format`` against the JAX library's solve in
    that format, on the right-hand side both CLIs make (seed 1)."""
    name, args = case
    rc, out, err = _run(port_main, args + F64 + ["--platform", "cpu"],
                        capsys)
    assert rc == 0, err
    s = _summary(out)
    a = cm.load_mm_sparse_matrix(MAT900)
    b = gen_rand_vector(a.n, 0.2, 1.0, 5.0, seed=1)
    precond = args[args.index("--precond") + 1] if "--precond" in args \
        else "ilu0"
    cfg = cm.SolverConfig(dtype="float64", precond=precond, tol=1e-6,
                          neumann_const_factors="--neumann-exact-factors"
                          not in args,
                          fuse_blas1="--fuse-blas1" in args)
    r = cm.solve(a, b, cfg, format=args[args.index("--format") + 1])
    assert r.converged and s["rel"] < 1e-6
    slack = HFORM if precond == "none" else ILU
    assert abs(s["iters"] - r.iters) <= slack


def test_jax_cli_drops_format_the_port_honours_it(capsys, monkeypatch):
    """ROADMAP C8: the JAX CLI parses ``--format`` and never passes it on,
    so ``--format bell`` prints what the default operator prints; the
    port's CLI solves on the BELL operator."""
    base = ["-M", MAT900, "--precond", "none", "--platform", "cpu"] + F64
    _, plain, _ = _run(jax_main, base, capsys)
    _, bell, _ = _run(jax_main, base + ["--format", "bell"], capsys)
    assert _summary(bell) == _summary(plain)
    calls = []
    matvec = tops.BELLOperator.matvec

    def counted(self, x):
        calls.append(1)
        return matvec(self, x)

    monkeypatch.setattr(tops.BELLOperator, "matvec", counted)
    rc, out, _ = _run(port_main, base, capsys)
    assert rc == 0 and not calls
    rc, out, _ = _run(port_main, base + ["--format", "bell"], capsys)
    assert rc == 0 and len(calls) >= 2 * _summary(out)["iters"]


def test_checkpoint_and_resume_match_jax(tmp_path, capsys):
    """The checkpoint/resume pair of the JAX tests, each package resuming
    from its own checkpoint."""
    got = {}
    for tag, main in (("jax", jax_main), ("port", port_main)):
        ck = str(tmp_path / f"{tag}.npz")
        base = ["-M", MAT900, "--precond", "none", "--platform", "cpu"] + F64
        rc1, _, err1 = _run(main, base + ["--maxit", "10", "--tol", "1e-14",
                                          "--checkpoint", ck], capsys)
        rc2, out2, _ = _run(main, base + ["--resume", ck], capsys)
        got[tag] = (rc1, _failure(err1), rc2, _summary(out2))
    (rc1_j, f_j, rc2_j, s_j), (rc1_t, f_t, rc2_t, s_t) = got["jax"], \
        got["port"]
    assert (rc1_t, rc2_t) == (rc1_j, rc2_j) == (2, 0)
    assert f_t == f_j == ("MAXIT", 10)
    resumed = [[re.sub(r"resuming from \S+", "resuming from", ln)
                for ln in s["lines"]] for s in (s_t, s_j)]
    assert resumed[0] == resumed[1]
    assert any(ln.startswith("resuming from (iters=10") for ln in resumed[0])
    assert abs(s_t["iters"] - s_j["iters"]) <= HFORM


DIST = 5        # iteration slack of the distributed solves (test_parallel)


@pytest.mark.parametrize("precond", ["none", "jacobi", "bjacobi_ilu0"])
def test_devices_rejected_until_the_distributed_solver(precond, capsys):
    """``--devices 4`` ran nothing until the distributed solver was
    ported; now it runs it, as the JAX CLI does: the same exit code and
    printed lines, iterations within ±5 (the distributed solves' slack,
    tests/test_parallel.py), both under the tolerance."""
    args = ["-M", MAT900, "--devices", "4", "--precond", precond,
            "--platform", "cpu"] + F64
    rc_j, out_j, err_j = _run(jax_main, args, capsys)
    rc_t, out_t, err_t = _run(port_main, args, capsys)
    assert rc_t == rc_j == 0, (err_j, err_t)
    s_j, s_t = _summary(out_j), _summary(out_t)
    assert s_t["lines"] == s_j["lines"]
    assert "success" in s_t["lines"]
    assert abs(s_t["iters"] - s_j["iters"]) <= DIST
    assert s_t["rel"] < 1e-6 and s_j["rel"] < 1e-6


@pytest.mark.parametrize("flag", [["--format", "csr"],
                                  ["--reorder", "rcm"]])
def test_jax_cli_drops_format_and_reorder_with_devices(flag, capsys,
                                                       monkeypatch):
    """ROADMAP C11: with ``--devices`` the JAX CLI parses ``--format`` and
    ``--reorder`` and passes neither on (its distributed solve prints what
    it prints without them); the port's CLI exits 1 and says so."""
    base = ["-M", MAT900, "--devices", "4", "--precond", "jacobi",
            "--platform", "cpu"] + F64
    rc_p, plain, _ = _run(jax_main, base, capsys)
    rc_f, flagged, _ = _run(jax_main, base + flag, capsys)
    assert rc_p == rc_f == 0
    assert _summary(flagged) == _summary(plain)
    rc, out, err = _run(port_main, base + flag, capsys)
    assert rc == 1 and "success" not in out
    assert "--format/--reorder do not reach the distributed solver" in err


def test_bjacobi_ilu0_without_devices_raises_as_jax(capsys):
    args = ["-M", MAT900, "--precond", "bjacobi_ilu0", "--platform",
            "cpu"] + F64
    with pytest.raises(ValueError) as e_j:
        jax_main(args)
    with pytest.raises(ValueError) as e_t:
        port_main(args)
    assert str(e_t.value) == str(e_j.value) == \
        "unknown preconditioner 'bjacobi_ilu0'"


def test_refine_hint_follows_the_ports_own_residual(capsys):
    """f32 exact ILU(0) on mat10000: the hint to rerun with --refine is
    printed exactly when the port's true residual misses 10·tol."""
    rc, out, _ = _run(port_main, ["-M", MAT10K, "--dtype", "float32",
                                  "--platform", "cpu"], capsys)
    s = _summary(out)
    assert rc == 0
    hint = any("rerun with --refine" in ln for ln in s["lines"])
    assert hint == (s["rel_true"] > 10 * 1e-6)


def test_default_dtype_follows_x64(capsys):
    for extra, dt in (([], "float32"), (["--x64"], "float64")):
        rc, out, _ = _run(port_main, ["-M", MAT3, "-V", VEC3, "--precond",
                                      "none", "--platform", "cpu"] + extra,
                          capsys)
        assert rc == 0 and f"dtype={dt}, backend=cpu" in out


def test_no_card_exits_1_without_platform_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(port_main, ["-M", MAT3, "-V", VEC3], capsys)
    assert rc == 1 and "success" not in out and "--platform cpu" in err


def test_profile_writes_a_trace_on_the_cpu(tmp_path, capsys):
    d = tmp_path / "prof" / "run"
    rc, _, _ = _run(port_main, ["-M", MAT900, "--platform", "cpu",
                                "--profile", str(d)] + F64, capsys)
    assert rc == 0
    (trace,) = os.listdir(d)
    assert trace.endswith(".json") and (d / trace).stat().st_size > 0


def test_debug_nans_raises_at_the_first_nonfinite_residual(tmp_path, capsys):
    """A = [[0, 1], [1, 0]], b = (1, 2), x0 = ones: the h-form loop's first
    alpha divides by <r0, A r0> = 0, so its first residual is NaN."""
    m = tmp_path / "swap.mtx"
    m.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 2 2\n1 2 1.0\n2 1 1.0\n")
    v = tmp_path / "b.mtx"
    v.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "2 1 2\n1 1 1.0\n2 1 2.0\n")
    args = ["-M", str(m), "-V", str(v), "--precond", "none", "--platform",
            "cpu"] + F64
    rc, _, err = _run(port_main, args, capsys)
    assert rc == 2 and _failure(err) == ("BREAKDOWN", 1)
    with pytest.raises(FloatingPointError, match="at iteration 0"):
        port_main(args + ["--debug-nans"])
