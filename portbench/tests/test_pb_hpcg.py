"""The frozen HPCG generator against the port's, and the HPCG cell on the
CPU at a 12^3 grid: the reference judges its answers, and a traced run
reports the level route's span and count, the set-up's phases, the
solve's vector boundary and the loop's metrics by the cell's own names (no
device trace on the CPU, so no roofline, torch ops' time or idle share)."""

import json
import os

import numpy as np
import pytest

import pb_helpers
from portbench import matrices

CELL = "hpcg104_ilu0_f64.stream64"
SIDE = 12


@pytest.mark.parametrize("nx,ny,nz", [(4, 3, 5), (6, 6, 6), (1, 2, 3)])
def test_hpcg27_equals_the_ports(nx, ny, nz):
    from cuda_mat_tpu_torch.models.problems import hpcg27

    ours = matrices.make({"generator": "hpcg27", "nx": nx, "ny": ny,
                          "nz": nz})
    port = hpcg27(nx, ny, nz)
    np.testing.assert_array_equal(ours.indptr, port.indptr)
    np.testing.assert_array_equal(ours.indices, port.indices)
    np.testing.assert_array_equal(ours.data, port.data)


def hpcg_root(tmp: str) -> str:
    root = pb_helpers.tiny_root(tmp)
    path = os.path.join(root, "portbench", "configs", "hpcg104_ilu0_f64.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["matrix"] = {"generator": "hpcg27", "nx": SIDE, "ny": SIDE,
                     "nz": SIDE}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def test_hpcg_cell_runs_and_reports_its_levels(tmp_path):
    root = hpcg_root(str(tmp_path))
    rc, res, err = pb_helpers.run_cell(root, CELL, seed=2 ** 31 + 5,
                                       seconds=0.5)
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["failed"] == 0, res
    assert set(res["metrics"]) == {"solve_ms.10m", "setup_s"}
    rc, res, err = pb_helpers.run_cell(root, CELL, seed=7, seconds=0.3,
                                       trace=True)
    assert rc == 0, err[-3000:]
    m = res["metrics"]
    assert m["trisolve_levels"]["value"] == 2 * (7 * SIDE - 6)
    assert 0 < m["make_solver_levels_s"]["value"]
    assert {"ms_per_iter.hpcg104", "iters_per_solve.hpcg104",
            "loop_enqueue_ms_per_iter.hpcg104",
            "loop_poll_ms_per_iter.hpcg104", "host_io_ms.hpcg104",
            "solve_prep_ms.hpcg104", "solve_finish_ms.hpcg104",
            "make_solver_s", "make_solver_operator_s",
            "make_solver_factor_s", "make_solver_precond_s"} <= set(m)
    assert not {"b8_roofline", "device_idle_pct.hpcg104",
                "torch_ops_ms_per_iter.hpcg104"} & set(m)
