"""A small copy of the benchmark for the CPU tests: this directory's
harness, ``BENCHMARK.json`` and configurations with the grids cut to a size
a test holds, run on the CPU (the port's plain twins) in a subprocess that
finds the copy's ``portbench`` first."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("poisson10m_milu_f32.stream64", "poisson1m_ilu0_f64.stream64")
GRID = {"rows": 60, "cols": 20}


def tiny_root(tmp: str, grid: dict = GRID) -> str:
    """A checkout-like directory under ``tmp``: a copy of ``portbench``
    (tests left out) and of ``BENCHMARK.json``, each configuration's grid
    cut to ``grid``."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        path = os.path.join(root, entry["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["matrix"].update(grid)
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root


def run_cell(root: str, workload: str, seed: int = 1, seconds: float = 0.5,
             trace: bool = False, prelude: str = "", timeout: float = 600):
    """Drive ``harness.run`` on the CPU from ``root``.  ``prelude``: code
    run first (a fault planted in the program).  Returns ``(returncode,
    result or None, stderr)``."""
    code = "\n".join([
        "import json, sys, time",
        f"sys.path[:0] = [{root!r}, {REPO!r}]",
        "t = time.perf_counter()",
        "import torch",
        "torch.set_num_threads(1)",
        prelude,
        "from portbench import harness",
        f"res, info, checks = harness.run({workload!r}, {seed}, {seconds},"
        f" {bool(trace)}, 'cpu', t, root={root!r})",
        "print('\\n'.join(checks), file=sys.stderr)",
        "print(json.dumps(res))"])
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, cwd=root, env=env)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, result, p.stderr


if REPO not in sys.path:
    sys.path.insert(0, REPO)
