"""The port's generator (``python -m cuda_mat_tpu_torch.generator``): the
JAX package's generator tests run against it, and for the same seed and
config its output is byte for byte the JAX generator's."""

import io
import sys

import pytest

from cuda_mat_tpu.generator import main as jax_main

from cuda_mat_tpu_torch import CSRMatrix
from cuda_mat_tpu_torch.generator import main
from cuda_mat_tpu_torch.io import omp_format
from cuda_mat_tpu_torch.io.mmio import load_mm_sparse_matrix, read_mm
from cuda_mat_tpu_torch.io.vectors import to_dense_vector


def test_stdin_config_vector(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("0 30 -10 10 0.5"))
    assert main([]) == 0
    tok = capsys.readouterr().out.split()
    assert int(tok[0]) == 30 and len(tok) == 31


def test_matrix_omp_format_roundtrip(tmp_path):
    p = str(tmp_path / "m.txt")
    assert main(["--kind", "matrix", "--dim", "25", "--zero-prob", "0.8",
                 "-o", p]) == 0
    m = omp_format.read_matrix(p)
    assert m.n == 25


def test_laplacian_mm(tmp_path):
    p = str(tmp_path / "lap.mtx")
    assert main(["--kind", "laplacian", "--side", "10", "--mm", "-o", p]) == 0
    a = load_mm_sparse_matrix(p)
    assert a.n == 100
    d = a.to_dia()
    assert set(int(o) for o in d.offsets) == {-10, -1, 0, 1, 10}


def test_vector_mm(tmp_path):
    p = str(tmp_path / "v.mtx")
    assert main(["--kind", "vector", "--dim", "12", "--zero-prob", "0.0",
                 "--mm", "-o", p]) == 0
    _, coo = read_mm(p)
    assert to_dense_vector(CSRMatrix.from_coo(coo)).shape == (12,)


def test_bad_stdin(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("1 2"))
    assert main([]) == 1
    assert capsys.readouterr().err == \
        "stdin config: <mat_vec> <dim> <min> <max> <p_zero>\n"


ARGS = [
    ["--kind", "laplacian", "--side", "10", "--mm"],
    ["--kind", "laplacian", "--side", "7"],
    ["--kind", "matrix", "--dim", "40", "--zero-prob", "0.8", "--seed", "3"],
    ["--kind", "matrix", "--dim", "40", "--zero-prob", "0.8", "--min", "1",
     "--max", "10", "--mm"],
    ["--kind", "vector", "--dim", "30", "--zero-prob", "0.3"],
    ["--kind", "vector", "--dim", "30", "--mm", "--seed", "5"],
    "1 50 -10 10 0.9",
    "0 100 -10 10 0.999",
]


@pytest.mark.parametrize("args", ARGS, ids=[str(a) for a in ARGS])
@pytest.mark.parametrize("to_file", [False, True])
def test_output_bytes_equal_jax(args, to_file, tmp_path, monkeypatch, capsys):
    """Each config, to stdout and to a file (``-o``), from both
    generators: the same bytes."""
    got = {}
    for tag, run in (("jax", jax_main), ("port", main)):
        argv = [] if isinstance(args, str) else list(args)
        if isinstance(args, str):
            monkeypatch.setattr(sys, "stdin", io.StringIO(args))
        path = tmp_path / f"{tag}.out"
        if to_file:
            argv += ["-o", str(path)]
        assert run(argv) == 0
        out = capsys.readouterr().out
        got[tag] = path.read_bytes() if to_file else out.encode()
    assert got["port"] == got["jax"] and len(got["port"]) > 0
