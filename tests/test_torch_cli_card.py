"""The reference's default solve through the port's CLI, ``-M
data/mat10000.mtx -V ones.mtx --x64`` (exact ILU(0) BiCGSTAB in f64, b =
ones written by the port's ``write_mm_dense_vector``), on the card and on
the CPU.

This file imports only the port, so it also runs on a machine without JAX
(``python -m pytest --noconftest -m gpu tests/test_torch_cli_card.py`` on a
card).  Both devices: exit code 0, ``success``, the golden's 45 iterations
± 2 (tests/goldens/mat10000_ilu.npz, whose b is ones; the CLI's own random
b has no golden).  On the card the launch counters show that kernels B1
(the stencil SpMV) and B4a (the banded triangular solves) carried every
matvec and msolve; on the CPU no kernel is launched (the plain twins run).
The card case skips without a card.
"""

import os
import re

import numpy as np
import pytest
import torch

from cuda_mat_tpu_torch.cli import main
from cuda_mat_tpu_torch.io.mmio import write_mm_dense_vector
from cuda_mat_tpu_torch.ops import banded_trisolve as bt
from cuda_mat_tpu_torch.ops import stencil as st

MAT10K = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "mat10000.mtx")
GOLDEN, SLACK = 45, 2


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The ILU(0) setup inverts its blocks with numpy: under parallel test
    workers, OpenBLAS threads stall it."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
def test_cli_default_solve(device, capsys, tmp_path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ones = str(tmp_path / "ones.mtx")
    write_mm_dense_vector(ones, np.ones(10000))
    st.reset_launch_counts()
    bt.reset_launch_counts()
    argv = ["-M", MAT10K, "-V", ones, "--x64"] + (
        ["--platform", "cpu"] if device == "cpu" else [])
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0 and "\nsuccess\n" in out
    assert f"dtype=float64, backend={device}" in out
    iters = int(re.search(r"iterations = (\d+)", out)[1])
    assert abs(iters - GOLDEN) <= SLACK
    b1 = st.const_stencil_spmv_padded.launches
    b4a = bt.fused_msolve_padded.launches
    if device == "cpu":
        assert b1 == b4a == 0
    else:
        assert b1 >= 2 * iters + 1 and b4a >= 2 * iters
