"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names (``cuda_mat_tpu_torch`` is not
``cuda_mat_tpu``), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

import pb_helpers
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_mat_tpu"}
BENCH = os.path.join(pb_helpers.REPO, "portbench")


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{pb_helpers.REPO!r})\n{code}\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, check=True, cwd=pb_helpers.REPO)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_names():
    assert harness.forbidden_modules(["cuda_mat_tpu_torch.ops", "numpy"]) \
        == []
    assert harness.forbidden_modules(["cuda_mat_tpu.solvers"]) == \
        ["cuda_mat_tpu"]
    assert harness.forbidden_modules(["jax._src.core", "jaxlib"]) == \
        ["jax", "jaxlib"]


def test_harness_loads_no_jax():
    names = loaded_after(
        "import runpy, glob\n"
        "from portbench import harness, calibrate, spec, peaks\n"
        "from portbench.reference import bicgstab, check, operator\n"
        "import cuda_mat_tpu_torch\n"
        "from cuda_mat_tpu_torch.native import loader\n"
        "from cuda_mat_tpu_torch.ops import _kernels\n"
        f"for p in sorted(glob.glob({BENCH!r} + '/*/*.py')):\n"
        "    if '/tests/' not in p:\n"
        "        spec.load_module(p.split('/')[-2], p.split('/')[-1][:-3])\n"
        f"runpy.run_path({BENCH!r} + '/run.py', run_name='not_main')")
    assert "cuda_mat_tpu_torch" in names and "portbench" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("from portbench.reference import bicgstab, check,"
                         " operator")
    assert not names & (FORBIDDEN | {"cuda_mat_tpu_torch"})


def test_no_source_imports_jax():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    tops = {node.module.split(".")[0]}
                else:
                    continue
                assert not tops & FORBIDDEN, (f, tops)
