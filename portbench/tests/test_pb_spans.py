"""The program's records matched to the harness's solves
(``program_spans.py``) and the metrics that read them: the window's
records are returned only where they are exactly the warm-up, the window
and the traced solves after the last ``make_solver``; a count or an
``iters`` that disagrees, or a program without a recorder, gives None.
A tiny traced run of each cell reads every new metric."""

from types import SimpleNamespace

import pytest

import pb_helpers
from portbench import program_spans, spec
from cuda_mat_tpu_torch.utils import timing

NEW = ("solve_prep_ms", "solve_finish_ms", "loop_enqueue_ms_per_iter",
       "loop_poll_ms_per_iter", "make_solver_operator_s",
       "make_solver_factor_s", "make_solver_precond_s")


def _record(kind, iters=0, **seconds):
    ns = [None] * len(timing.SPANS)
    for name, s in seconds.items():
        ns[timing.SPANS.index(name.replace("__", "."))] = int(s * 1e9)
    return timing.Record(kind, tuple(ns), iters, iters + 1)


def _run(iters=(5, 6, 7), traced=(8,)):
    row = lambda k: SimpleNamespace(iters=k)  # noqa: E731
    return SimpleNamespace(solves=[row(k) for k in iters],
                           traced=[row(k) for k in traced])


def _records(iters=(5, 6, 7), traced=(8,), warm=9):
    setup = _record("make_solver", make_solver=3.0, make_solver__operator=1.0,
                    make_solver__precond=1.5, precond__factor=0.5)
    solves = [_record("solve", k, solve__prep=0.001 * k, solve__finish=0.002,
                      loop__step=0.0001 * k, loop__poll=0.0003 * k)
              for k in (warm,) + tuple(iters) + tuple(traced)]
    # an older run's records come first
    return [_record("make_solver"), _record("solve", 1), setup] + solves


def test_window_is_the_records_of_the_window():
    recs = _records()
    kept = program_spans.window(_run(), recs)
    assert kept == recs[4:7]
    assert [r.iters for r in kept] == [5, 6, 7]
    rec = _run()
    assert program_spans.mean_ms(rec, "solve.prep", recs) \
        == pytest.approx(6.0)
    assert program_spans.ms_per_iter(rec, "loop.poll", recs) \
        == pytest.approx(0.3)


@pytest.mark.parametrize("recs", [
    _records()[:-1],                            # a traced solve missing
    _records() + [_record("solve", 8)],         # one solve too many
    _records(iters=(5, 6, 4)),                  # an iters disagrees
    _records()[3:],                             # no make_solver record
    [],
])
def test_window_is_none_where_the_records_disagree(recs):
    assert program_spans.window(_run(), recs) is None
    assert program_spans.mean_ms(_run(), "solve.prep", recs) is None
    assert program_spans.ms_per_iter(_run(), "loop.step", recs) is None


def test_make_solver_phases_read_the_last_setup(monkeypatch):
    recs = _records()
    monkeypatch.setattr(timing, "records", lambda: recs)
    read = {m: spec.metric_reader(m).read(_run()) for m in NEW}
    assert read["make_solver_operator_s"] == pytest.approx(1.0)
    assert read["make_solver_factor_s"] == pytest.approx(0.5)
    assert read["make_solver_precond_s"] == pytest.approx(1.0)
    assert read["solve_prep_ms"] == pytest.approx(6.0)
    assert read["solve_finish_ms"] == pytest.approx(2.0)
    assert read["loop_enqueue_ms_per_iter"] == pytest.approx(0.1)
    assert read["loop_poll_ms_per_iter"] == pytest.approx(0.3)


def test_a_program_without_a_recorder_gives_no_number(monkeypatch):
    monkeypatch.delattr(timing, "records")
    assert program_spans.program_records() is None
    for m in NEW:
        assert spec.metric_reader(m).read(_run()) is None


@pytest.mark.parametrize("cell", pb_helpers.CELLS)
def test_a_traced_run_reads_every_new_metric(tmp_path, cell):
    root = pb_helpers.tiny_root(str(tmp_path))
    rc, res, err = pb_helpers.run_cell(root, cell, seed=2 ** 31 + 77,
                                       seconds=0.5, trace=True)
    assert rc == 0, err[-3000:]
    part = cell.split(".")[0].split("_")[0][len("poisson"):]
    got = res["metrics"]
    for m in NEW[:4]:
        assert got[f"{m}.{part}"]["value"] > 0
    for m in NEW[4:]:
        assert got[m]["value"] > 0
    parts = sum(got[m]["value"] for m in NEW[4:])
    assert parts <= got["make_solver_s"]["value"]
    assert got[f"solve_prep_ms.{part}"]["value"] \
        + got[f"solve_finish_ms.{part}"]["value"] \
        < got[f"host_io_ms.{part}"]["value"]
    assert got[f"loop_enqueue_ms_per_iter.{part}"]["value"] \
        + got[f"loop_poll_ms_per_iter.{part}"]["value"] \
        < got[f"ms_per_iter.{part}"]["value"]
