"""A configuration, a traffic mix, a metric and a cell added as new files
and entries only are found by their names and run, with no file of the
benchmark edited; a metric split by cells (``solve_ms.tiny``) is read by
the reader of the name before its dot."""

import filecmp
import json
import os

import pb_helpers

CELL = "tiny_jacobi_f64.stream4"


def add_files(root: str) -> None:
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "configs",
                           "poisson1m_ilu0_f64.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_jacobi_f64", matrix={
        "generator": "grid_laplacian", "rows": 30, "cols": 10})
    cfg["solver"].update(precond="jacobi", tol=1e-8)
    files = {
        "configs/tiny_jacobi_f64.json": json.dumps(cfg),
        "traffic/stream4.json": json.dumps({
            "name": "stream4", "loop": "closed", "callers": 1,
            "rhs_count": 4, "rhs": {"distribution": "uniform", "low": 0.0,
                                    "high": 2.0},
            "x0": "ones", "order": "cycle", "check_sample": 3,
            "trace_solves": 2}),
        f"limits/{CELL}.json": json.dumps({"cell": CELL, "limits": {
            "unconverged": 0, "res_true": 1e-7, "res_gap": 1e-12}}),
        "metrics/traced_solves.py": (
            '"""Solves the traced run profiled."""\n\n\n'
            "def read(rec):\n    return len(rec.traced)\n"),
    }
    for name, text in files.items():
        path = os.path.join(bench_dir, name)
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "tiny_jacobi_f64", "source": "a test",
        "file": "portbench/configs/tiny_jacobi_f64.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_jacobi_f64",
                               "traffic": "stream4", "chips": 1,
                               "why": "a test"})
    # a metric split by cells: read by metrics/solve_ms.py
    bench["end_to_end"].append({
        "name": "solve_ms.tiny", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock", "workloads": [CELL]})
    bench["per_layer"].append({
        "name": "traced_solves", "unit": "solves", "better": "higher",
        "source": "program_counter", "layer": "the loop", "moves":
        "solve_ms", "workloads": [CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_new_files_are_found(tmp_path):
    root = pb_helpers.tiny_root(str(tmp_path))
    add_files(root)
    rc, res, err = pb_helpers.run_cell(root, CELL, seed=4, seconds=0.3)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert set(res["metrics"]) == {"solve_ms.tiny", "setup_s"}
    rc, res, err = pb_helpers.run_cell(root, CELL, seed=5, seconds=0.3,
                                       trace=True)
    assert rc == 0, err[-3000:]
    # the per-layer metrics that list other cells stay out
    assert res["metrics"] == {"traced_solves": {"value": 2,
                                                "unit": "solves"}}
    # the harness's own files are the repository's, unedited
    here = os.path.join(pb_helpers.REPO, "portbench")
    for dirpath, _, files in os.walk(here):
        if "tests" in dirpath or "__pycache__" in dirpath or \
                dirpath.endswith("configs"):
            continue
        for f in files:
            mine = os.path.join(dirpath, f)
            theirs = os.path.join(root, "portbench",
                                  os.path.relpath(mine, here))
            assert filecmp.cmp(mine, theirs, shallow=False), mine
