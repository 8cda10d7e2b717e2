"""The reader of ``trisolve_chunks``: the chunks of the last
``make_solver`` record, 0 on the grid-barrier route, and None for a
program whose records keep no such count (a parent without the counter)
or that made no solver; a traced run of the HPCG cell on the CPU at a
12^3 grid reads the chunks of both sweeps."""

from types import SimpleNamespace

import pytest

import pb_helpers
from portbench import spec
from cuda_mat_tpu_torch.utils import timing
from test_pb_hpcg import CELL, SIDE, hpcg_root


def _records(chunks):
    ns = (None,) * len(timing.SPANS)
    first = timing.Record("make_solver", ns, 0, 0, 1444, chunks=3)
    if chunks is None:     # a record as a program without the counter
        last = SimpleNamespace(kind="make_solver", ns=ns, iters=0, steps=0,
                               levels=1444)
    else:
        last = timing.Record("make_solver", ns, 0, 0, 1444, chunks=chunks)
    return [first, last, timing.Record("solve", ns, 5, 5)]


@pytest.mark.parametrize("chunks,want", [(208, 208), (0, 0), (None, None)])
def test_reader(monkeypatch, chunks, want):
    monkeypatch.setattr(timing, "records", lambda: _records(chunks))
    assert spec.metric_reader("trisolve_chunks").read(None) == want


def test_reader_without_a_solver(monkeypatch):
    monkeypatch.setattr(timing, "records", lambda: [])
    assert spec.metric_reader("trisolve_chunks").read(None) is None


def test_the_hpcg_cell_reads_both_sweeps_chunks(tmp_path):
    root = hpcg_root(str(tmp_path))
    rc, res, err = pb_helpers.run_cell(root, CELL, seed=2 ** 31 + 17,
                                       seconds=0.3, trace=True)
    assert rc == 0, err[-3000:]
    # each sweep's chunks are a bandwidth (SIDE² + SIDE + 1) wide
    width = SIDE * SIDE + SIDE + 1
    assert res["metrics"]["trisolve_chunks"]["value"] \
        == 2 * -(-SIDE ** 3 // width)
