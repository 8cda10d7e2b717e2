"""Build a shared library from a source file in the repository, once.

The library lands in ``cuda_mat_tpu_torch/build/`` under a name keyed by a
hash of the source and the command, so an edited source rebuilds and an
unchanged one is reused.  Each build compiles to a private temporary name and
is moved into place with ``os.replace``: several processes (test workers)
may build at once, and none of them ever loads a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from typing import List, Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")


def build_library(argv: List[str], source: str, stem: str,
                  headers: Sequence[str] = ()) -> Tuple[str, float]:
    """Compile ``source`` with ``argv + ["-o", out, source]`` unless a build
    of the same source, ``headers`` (the files it includes) and command
    exists.  Returns ``(path, seconds)``; ``seconds`` is 0.0 when the
    library was already built.  Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    with open(source, "rb") as f:
        data = f.read()
    for name in headers:
        with open(name, "rb") as f:
            data += b"\0" + f.read()
    key = hashlib.sha256(data + "\0".join(argv).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"{stem}-{key[:16]}.so")
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(argv + ["-o", tmp, source], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {os.path.basename(source)} failed "
                           f"(rc {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0
