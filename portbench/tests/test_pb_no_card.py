"""Without a card the command exits non-zero and prints no result; with a
card but without the program beside it, too."""

import json
import os
import shutil
import subprocess
import sys

import pb_helpers


def no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_exits_non_zero_without_a_card():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         pb_helpers.CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=pb_helpers.REPO,
        timeout=300)
    assert p.returncode == 2, p.stderr[-2000:]
    assert no_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_exits_non_zero_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: the card is
    faked present, and the run fails to find the program."""
    root = tmp_path / "bare"
    shutil.copytree(os.path.join(pb_helpers.REPO, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(pb_helpers.REPO, "BENCHMARK.json"), root)
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            f"sys.argv = ['portbench/run.py', '--workload',"
            f" {pb_helpers.CELLS[1]!r}, '--seed', '3', '--seconds', '1',"
            " '--trace', '0']\n"
            "runpy.run_path('portbench/run.py', run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=300)
    assert p.returncode != 0
    assert "cuda_mat_tpu_torch" in p.stderr
    assert no_result(p.stdout)
