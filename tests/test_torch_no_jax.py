"""The port imports torch and never JAX, the JAX package or triton, and
reads no file of the JAX package."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import cuda_mat_tpu_torch
for m in pkgutil.walk_packages(cuda_mat_tpu_torch.__path__,
                               "cuda_mat_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "cuda_mat_tpu", "triton"))
print(bad)
"""


def test_import_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# a path into the JAX package's directory: "cuda_mat_tpu/..." or a path
# joined from a "cuda_mat_tpu" component.  A citation of a source line
# ("cuda_mat_tpu/ops/pallas_trisolve.py:46", as the smoke's "replaces"
# field and the kernel notes give) names no file the port opens.
_PATH = re.compile(r"""cuda_mat_tpu(?:/(?![\w/]+\.py:\d)|["'],)""")


def test_port_names_no_path_into_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "cuda_mat_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cpp", ".cuh", ".h"))]
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if _PATH.search(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}:"
                               f" {line.strip()}")
    assert not bad, "\n".join(bad)
