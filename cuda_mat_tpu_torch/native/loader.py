"""ctypes bindings to the port's native Matrix Market parser and ILU(0) /
MILU(0) factorizer.

The source is ``cuda_mat_tpu_torch/csrc/native.cpp`` (``cmt_mm_*``,
``cmt_ilu0`` / ``cmt_milu0``), the port's copy of the JAX package's native
source.  The library is built with g++ at first use into
``cuda_mat_tpu_torch/build/`` (see :mod:`~cuda_mat_tpu_torch.utils.build`);
without a compiler, :func:`available` is False and callers fall back to the
numpy paths: the pure-Python Matrix Market reader, and the numpy
factorization, which is a Python loop over rows and only fit for small
matrices.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Optional

import numpy as np

from cuda_mat_tpu_torch.utils.build import build_library

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "native.cpp")
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
build_seconds = 0.0   # time the last build in this process took (0 = reused)


def library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises RuntimeError
    when no C++ compiler is found or the build fails."""
    global _lib, build_seconds
    if _lib is None:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler found to build the native"
                               " factorizer")
        path, build_seconds = build_library([cxx] + FLAGS, SOURCE,
                                            "libcmt_native")
        lib = ctypes.CDLL(path)
        ll, p = ctypes.c_longlong, ctypes.c_void_p
        lib.cmt_mm_open.restype = ctypes.c_int
        lib.cmt_mm_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(p), ctypes.POINTER(ll),
                                    ctypes.POINTER(ll), ctypes.POINTER(ll)]
        lib.cmt_mm_fill_csr.restype = None
        lib.cmt_mm_fill_csr.argtypes = [p, p, p, p]
        lib.cmt_mm_close.restype = None
        lib.cmt_mm_close.argtypes = [p]
        lib.cmt_ilu0.restype = ll
        lib.cmt_ilu0.argtypes = [ll, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
        lib.cmt_milu0.restype = ll
        lib.cmt_milu0.argtypes = [ll, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_double]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def load_mm_sparse_matrix(path: str, symmetrize: bool = True):
    """Native ``.mtx`` → verified base-0 CSR (the same two-phase protocol as
    the JAX package's binding: query the sizes, then fill numpy buffers the
    caller owns)."""
    from cuda_mat_tpu_torch.formats.csr import CSRMatrix

    lib = library()
    handle = ctypes.c_void_p()
    n, m, nnz = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    rc = lib.cmt_mm_open(str(path).encode(), 1 if symmetrize else 0,
                         ctypes.byref(handle), ctypes.byref(n),
                         ctypes.byref(m), ctypes.byref(nnz))
    if rc != 0:
        raise ValueError(
            f"native MM parse failed for {str(path)!r} (code {rc})")
    data = np.empty(nnz.value, dtype=np.float64)
    indices = np.empty(nnz.value, dtype=np.int32)
    indptr = np.empty(n.value + 1, dtype=np.int32)
    lib.cmt_mm_fill_csr(handle, data.ctypes.data, indices.ctypes.data,
                        indptr.ctypes.data)
    lib.cmt_mm_close(handle)
    out = CSRMatrix(int(n.value), int(m.value), data, indices, indptr)
    out.verify()
    return out


def _pattern_ptrs(csr):
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    return indptr, indices


def ilu0_factorize(csr) -> np.ndarray:
    """Native ILU(0) (same semantics as
    :func:`cuda_mat_tpu_torch.reference.cpu_solvers.ilu0_factorize`)."""
    indptr, indices = _pattern_ptrs(csr)
    m = csr.data.astype(np.float64).copy()
    rc = library().cmt_ilu0(csr.n, indptr.ctypes.data, indices.ctypes.data,
                            m.ctypes.data)
    if rc != 0:
        raise ValueError(f"native ILU(0) failed (zero/missing diagonal at row {rc - 1})")
    return m


def milu0_factorize(csr, omega: float) -> np.ndarray:
    """Native relaxed modified-ILU(0): ``omega`` times each row's dropped
    fill is subtracted from its diagonal."""
    indptr, indices = _pattern_ptrs(csr)
    m = csr.data.astype(np.float64).copy()
    rc = library().cmt_milu0(csr.n, indptr.ctypes.data, indices.ctypes.data,
                             m.ctypes.data, float(omega))
    if rc != 0:
        raise ValueError(
            f"native MILU(0) failed (zero/missing diagonal at row {rc - 1})")
    return m
