"""The reader of ``h2d_mb_per_solve``: the mean of the window's
``h2d_bytes`` in 10^6 bytes, and None for a program whose records keep no
such count (a parent without the counter); a tiny traced run of each cell
reads one b a solve."""

from types import SimpleNamespace

import pytest

import pb_helpers
from portbench import spec
from cuda_mat_tpu_torch.utils import timing


def _run(iters=(5, 6), traced=(7,)):
    row = lambda k: SimpleNamespace(iters=k)  # noqa: E731
    return SimpleNamespace(solves=[row(k) for k in iters],
                           traced=[row(k) for k in traced])


def _records(with_count):
    ns = (None,) * len(timing.SPANS)
    recs = [timing.Record("make_solver", ns, 0, 0)]
    for k, iters in enumerate((9, 5, 6, 7)):        # warm-up, window, traced
        if with_count:
            recs.append(timing.Record("solve", ns, iters, iters, 0,
                                      4_000_000 * (k + 1), 8_000_000))
        else:      # a record as a program without the counter leaves it
            recs.append(SimpleNamespace(kind="solve", ns=ns, iters=iters,
                                        steps=iters, levels=0))
    return recs


@pytest.mark.parametrize("with_count,want", [(True, 10.0), (False, None)])
def test_reader(monkeypatch, with_count, want):
    monkeypatch.setattr(timing, "records", lambda: _records(with_count))
    got = spec.metric_reader("h2d_mb_per_solve.10m").read(_run())
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("cell", pb_helpers.CELLS)
def test_a_traced_run_reads_one_b_a_solve(tmp_path, cell):
    root = pb_helpers.tiny_root(str(tmp_path))
    rc, res, err = pb_helpers.run_cell(root, cell, seed=2 ** 31 + 91,
                                       seconds=0.3, trace=True)
    assert rc == 0, err[-3000:]
    part = cell.split(".")[0].split("_")[0][len("poisson"):]
    n = pb_helpers.GRID["rows"] * pb_helpers.GRID["cols"]
    item = 4 if part == "10m" else 8
    assert res["metrics"][f"h2d_mb_per_solve.{part}"]["value"] \
        == pytest.approx(n * item / 1e6)
