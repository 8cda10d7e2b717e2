"""The port's recorder (``cuda_mat_tpu_torch.utils.timing``) on the CPU.

- every entry point leaves one ``make_solver`` record of the phases it
  builds and one ``solve`` record of the same spans: ``make_solver`` then
  ``solve`` on the padded stencil layout and on true-n CSR vectors,
  ``solve``, ``bicgstab``, ``bicgstab_split``, ``bicgstab_lu_precond``,
  ``bicg`` and the distributed solver (a mesh of 2 row shards on the CPU;
  across two gloo processes in tests/test_torch_parallel_gloo.py);
  ``dt_setup`` and ``dt_alg`` are those records' ``make_solver`` and
  ``solve.loop`` spans, and the solve counts the steps its loop executed;
- ``loop.step`` and ``loop.poll`` are summed over exactly those steps (a
  clock that advances one nanosecond a reading);
- under ``torch.profiler`` every span is a ``user_annotation`` of the
  Chrome trace, ``solve.loop`` inside ``solve``, one ``loop.step`` and one
  ``loop.poll`` a step; the CLI's ``--refine --profile`` trace holds its
  phase, each restart's host residual and its inner solve;
- without a profiler no ``record_function`` is made;
- the ring keeps the newest :data:`~cuda_mat_tpu_torch.utils.timing.
  CAPACITY` records.
"""

import json
import os

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch as ct
from cuda_mat_tpu_torch.cli import main as cli_main
from cuda_mat_tpu_torch.models.problems import grid_laplacian
from cuda_mat_tpu_torch.parallel import make_dist_bicgstab, make_mesh
from cuda_mat_tpu_torch.solvers.refine import solve_refined
from cuda_mat_tpu_torch.utils import timing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAT900 = os.path.join(REPO, "data", "mat900.mtx")

# (config, format): the flagship's MILU Neumann series and exact ILU(0) on
# the padded stencil layout, exact ILU(0) on true-n CSR vectors
CASES = {
    "stencil-neumann": (ct.SolverConfig(
        precond="ilu0_neumann", milu_omega=0.96, neumann_terms=4, tol=1e-4,
        dtype="float32", true_residual=False), None),
    "stencil-ilu0": (ct.SolverConfig(precond="ilu0", dtype="float64",
                                     tol=1e-6, trisolve_block=32), None),
    "csr-ilu0": (ct.SolverConfig(precond="ilu0", dtype="float64", tol=1e-6,
                                 trisolve_block=32), "csr"),
}
MAKE_SOLVER_SPANS = ("make_solver", "make_solver.operator",
                     "make_solver.precond", "precond.factor")
SOLVE_SPANS = ("solve", "solve.prep", "solve.prep.b", "solve.prep.x0",
               "solve.prep.sync", "solve.loop", "loop.step", "loop.poll",
               "solve.finish")
H64 = ct.SolverConfig(dtype="float64", tol=1e-6)
ILU64 = CASES["csr-ilu0"][0]


def _system():
    a = grid_laplacian(24, 16)
    return a, np.random.default_rng(3).uniform(-1.0, 1.0, a.n)


def _steps(res, pairs: bool = True) -> int:
    """Loop steps of a solve: the written history pairs of a preconditioned
    loop, the written entries of the h-form and BiCG loops."""
    hist = res.residual_history[0::2] if pairs else res.residual_history
    return int(np.count_nonzero(hist >= 0))


def _new_records(fn):
    """``fn()`` and the records it closed (found after the newest record
    before it: the ring may be full)."""
    old = timing.records()
    mark = old[-1] if old else None
    out = fn()
    recs = timing.records()
    k = next((i for i in range(len(recs) - 1, -1, -1) if recs[i] is mark),
             -1)
    return out, recs[k + 1:]


def _solve(case):
    a, b = _system()
    cfg, fmt = CASES[case]
    ps = ct.make_solver(a, cfg, format=fmt, device="cpu")
    return ps, ps.solve(b)


def _prepared(case):
    cfg, fmt = CASES[case]
    return (lambda a, b: ct.make_solver(a, cfg, format=fmt,
                                        device="cpu").solve(b),
            MAKE_SOLVER_SPANS, True)


# name: (one call on (a, b), its make_solver record's spans, whether its
# loop writes a history pair a step)
ENTRY_POINTS = {
    **{case: _prepared(case) for case in CASES},
    "solve": (lambda a, b: ct.solve(a, b, ILU64, device="cpu"),
              MAKE_SOLVER_SPANS, True),
    "bicgstab": (lambda a, b: ct.bicgstab(a, b, H64, device="cpu"),
                 ("make_solver", "make_solver.operator",
                  "make_solver.precond"), False),
    "bicgstab_split": (lambda a, b: ct.bicgstab_split(
        a, np.full(a.n, 0.5), np.zeros(a.n), b, H64, device="cpu"),
        ("make_solver", "make_solver.operator"), False),
    "bicgstab_lu_precond": (lambda a, b: ct.bicgstab_lu_precond(
        a, b, ILU64, device="cpu"), MAKE_SOLVER_SPANS, True),
    "bicg": (lambda a, b: ct.bicg(a, b, H64, device="cpu"),
             ("make_solver", "make_solver.operator"), False),
    "distributed": (lambda a, b: make_dist_bicgstab(
        a, make_mesh(2, device="cpu"),
        ct.SolverConfig(precond="jacobi", dtype="float64", tol=1e-8)
    ).solve(b), ("make_solver",), True),
}


@pytest.mark.parametrize("case", sorted(ENTRY_POINTS))
def test_make_solver_and_solve_leave_one_record_each(case):
    call, setup_spans, pairs = ENTRY_POINTS[case]
    res, recs = _new_records(lambda: call(*_system()))
    assert [r.kind for r in recs] == ["make_solver", "solve"]
    setup, solve = recs
    assert set(setup.spans) == set(setup_spans)
    assert res.dt_setup == setup.seconds("make_solver")
    s = setup.spans
    assert s.get("make_solver.operator", 0.0) \
        + s.get("make_solver.precond", 0.0) <= res.dt_setup
    assert s.get("precond.factor", 0.0) <= s.get("make_solver.precond", 0.0)

    assert set(solve.spans) == set(SOLVE_SPANS)
    assert res.converged and solve.iters == res.iters
    assert solve.steps == _steps(res, pairs) > 0
    assert res.dt_alg == solve.seconds("solve.loop")
    s = solve.spans
    assert s["solve.prep.b"] + s["solve.prep.x0"] + s["solve.prep.sync"] \
        <= s["solve.prep"]
    assert s["loop.step"] + s["loop.poll"] <= s["solve.loop"]
    assert s["solve.prep"] + s["solve.loop"] + s["solve.finish"] \
        <= s["solve"]


@pytest.mark.parametrize("case", ["stencil-neumann", "csr-ilu0", "hform"])
def test_loop_sums_each_executed_step_once(case, monkeypatch):
    """With a clock that advances 1 ns a reading, a step reads it at its
    start, at its poll's call and at its poll's return: each of the two
    sums gains exactly 1 ns a step."""
    ticks = iter(range(10 ** 12))
    monkeypatch.setattr(timing, "perf_counter_ns", lambda: next(ticks))
    if case == "hform":
        a, b = _system()
        res = ct.bicgstab(a, b, ct.SolverConfig(dtype="float64", tol=1e-6),
                          device="cpu")
        steps = _steps(res, pairs=False)
    else:
        _, res = _solve(case)
        steps = _steps(res)
    rec = timing.records()[-1]
    assert rec.kind == "solve" and rec.steps == steps > 0
    assert rec.ns[timing.SPANS.index("loop.step")] == steps
    assert rec.spans["loop.step"] == rec.spans["loop.poll"] == steps / 1e9


def _trace_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") == "user_annotation" and "dur" in e]


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_are_user_annotations_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.PhaseTimer().phase("solve"):
            ps, res = _solve("stencil-neumann")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = _trace_events(path)
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    for name in MAKE_SOLVER_SPANS + SOLVE_SPANS:
        assert name in by, name
    steps = _steps(res)
    assert len(by["loop.step"]) == len(by["loop.poll"]) == steps
    (solve,), (loop,), (phase,) = by["solve"], by["solve.loop"], \
        by["phase.solve"]
    assert _inside(loop, solve) and _inside(solve, phase)
    assert all(_inside(e, loop) for e in by["loop.step"] + by["loop.poll"])
    (setup,) = by["make_solver"]
    assert _inside(by["precond.factor"][0], by["make_solver.precond"][0])
    assert _inside(by["make_solver.operator"][0], setup)
    assert timing.records()[-1].steps == steps


class _Counting:
    """Stands in for ``torch.profiler.record_function`` and counts the
    annotations made."""

    made = 0

    def __init__(self, name):
        type(self).made += 1
        self._rf = _REAL_RF(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)


_REAL_RF = torch.profiler.record_function


def test_no_record_function_without_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.made = 0
    _solve("stencil-ilu0")
    with timing.PhaseTimer().phase("load"):
        pass
    assert _Counting.made == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _, res = _solve("stencil-ilu0")
    # make_solver's 4, the solve's 7 and two a step
    assert _Counting.made == 4 + 7 + 2 * _steps(res)


def test_the_ring_keeps_the_newest_records():
    for k in range(timing.CAPACITY + 3):
        with timing.record("solve") as rec:
            rec.iters = k
    recs = timing.records()
    assert len(recs) == timing.CAPACITY
    assert [r.iters for r in recs[-3:]] == [timing.CAPACITY + k
                                            for k in range(3)]
    assert recs[0].iters == 3


def test_a_failed_call_closes_no_record():
    before = timing.records()[-1:] if timing.records() else []
    with pytest.raises(ValueError):
        with timing.record("solve"):
            raise ValueError("the call failed")
    assert (timing.records()[-1:] if timing.records() else []) == before
    assert timing.current() is None


def test_phase_timer_keeps_its_report():
    t = timing.PhaseTimer()
    with t.phase("load"):
        pass
    with pytest.raises(KeyError):
        with t.phase("load"):
            raise KeyError("inside the phase")
    assert set(t.times) == {"load"} and t.times["load"] > 0
    assert t.report() == f"load: {t.times['load']:.6f} s"


def test_refine_records_each_restart():
    a, b = _system()
    cfg = ct.SolverConfig(precond="ilu0", dtype="float64", tol=1e-10,
                          trisolve_block=32)
    res, recs = _new_records(lambda: solve_refined(a, b, cfg, device="cpu"))
    kinds = [r.kind for r in recs]
    assert kinds[0] == "make_solver" and kinds[-1] == "refine"
    inner = kinds.count("solve")
    assert res.converged and inner == len(res.residual_history) - 1 > 0
    ref = recs[-1]
    assert set(ref.spans) == {"refine", "refine.residual", "refine.inner"}
    assert ref.seconds("refine.inner") >= sum(
        r.seconds("solve") for r in recs if r.kind == "solve")
    assert res.dt_alg == pytest.approx(sum(
        r.seconds("solve.loop") for r in recs if r.kind == "solve"))


def test_refine_cli_profile_shows_residuals_against_inner_solves(tmp_path,
                                                                 capsys):
    d = tmp_path / "prof"
    rc = cli_main(["-M", MAT900, "--platform", "cpu", "--refine",
                   "--profile", str(d)])
    assert rc == 0 and "success" in capsys.readouterr().out
    (name,) = os.listdir(d)
    by = {}
    for e in _trace_events(str(d / name)):
        by.setdefault(e["name"], []).append(e)
    (phase,) = by["phase.solve"]
    (refine,) = by["refine"]
    assert _inside(refine, phase)
    assert len(by["refine.residual"]) == len(by["refine.inner"]) + 1
    assert len(by["solve.loop"]) == len(by["refine.inner"]) > 0
    for res_e, inner_e in zip(by["refine.residual"], by["refine.inner"]):
        assert res_e["ts"] + res_e["dur"] <= inner_e["ts"]
    assert all(_inside(e, refine) for e in by["refine.residual"])
