"""The benchmark's matrices, made on the host from a configuration's
``matrix`` entry, ``{"generator": <name>, ...its sizes}``: the function
``make`` of ``generators/<name>.py`` called with the sizes.  The CSR arrays
are the benchmark's own; the program and the reference are both given
them."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CSR(NamedTuple):
    n: int
    indptr: np.ndarray   # int32[n + 1]
    indices: np.ndarray  # int32[nnz], increasing within each row
    data: np.ndarray     # float64[nnz]


def make(spec: dict) -> CSR:
    from portbench import spec as specs

    sizes = {k: v for k, v in spec.items() if k != "generator"}
    return specs.load_module("generators", spec["generator"]).make(**sizes)
