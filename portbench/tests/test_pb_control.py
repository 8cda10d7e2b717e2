"""The check against its control and against planted faults, at a size a
test holds, with each cell's own limits: the program comes out correct;
the control (the cell's limits file names it) and every fault a solve can
have come out not correct.  The faults are planted in the program under a
whole run that skips the look for a card: a loop step that leaves the
state unchanged but its counter; half of the rows left out of every matvec
(a solve's batch is its rows); one entry of an answer altered by 5% of
the answer's largest where it is produced.  (A cell on one card has no
exchange between cards to leave out.)"""

import subprocess
import sys

import pytest

import pb_helpers

FAULTS = {
    "state_unchanged": (
        "import importlib\n"
        "bs = importlib.import_module('cuda_mat_tpu_torch.solvers.bicgstab')\n"
        "def stuck(matvec, msolve, dot, st, *a, **k):\n"
        "    return st._replace(i=st.i + 1)\n"
        "bs.precond_step = stuck\n"),
    "half_the_rows": (
        "import importlib, torch\n"
        "bs = importlib.import_module('cuda_mat_tpu_torch.solvers.bicgstab')\n"
        "core = bs.precond_core\n"
        "def half(matvec):\n"
        "    def mv(x):\n"
        "        y = matvec(x).clone()\n"
        "        y[y.numel() // 2:] = 0\n"
        "        return y\n"
        "    return mv\n"
        "bs.precond_core = lambda mv, *a, **k: core(half(mv), *a, **k)\n"),
    "answer_altered": (
        "import importlib\n"
        "bs = importlib.import_module('cuda_mat_tpu_torch.solvers.bicgstab')\n"
        "finish = bs._finish\n"
        "def altered(*a, **k):\n"
        "    r = finish(*a, **k)\n"
        "    r.x = r.x.copy()\n"
        "    r.x[r.x.size // 2] += 0.05 * abs(r.x).max()\n"
        "    return r\n"
        "bs._finish = altered\n"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_helpers.tiny_root(str(tmp_path_factory.mktemp("control")))


@pytest.mark.parametrize("cell", pb_helpers.CELLS)
def test_program_is_correct(root, cell):
    rc, res, err = pb_helpers.run_cell(root, cell, seed=2 ** 31 + 17)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", pb_helpers.CELLS)
def test_control_is_not_correct(root, cell):
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{root!r}, {pb_helpers.REPO!r}]",
        "import torch",
        "torch.set_num_threads(1)",
        "from portbench import calibrate, spec",
        "from portbench.reference.check import judge",
        f"cell = spec.load_cell({cell!r}, {root!r})",
        "for r in calibrate.control_readings(cell, [21, 22, 23], 'cpu'):",
        "    print('correct', judge(r, cell.limits['limits'])[0])"])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    verdicts = [ln for ln in p.stdout.splitlines()
                if ln.startswith("correct")]
    assert verdicts == ["correct False"] * 3, p.stdout[-3000:]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", pb_helpers.CELLS)
def test_fault_is_not_correct(root, cell, fault):
    rc, res, err = pb_helpers.run_cell(root, cell, seed=31,
                                       prelude=FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert not res["correct"], res["checks"]
