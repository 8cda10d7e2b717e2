"""Build, load and launch the hand-written Hopper kernels
(``cuda_mat_tpu_torch/csrc/*.cu``).

Each source is compiled with nvcc for ``sm_90a`` into a shared library with
a plain C interface at first use (into ``cuda_mat_tpu_torch/build/``, see
:mod:`~cuda_mat_tpu_torch.utils.build`) and bound through ctypes.  Nothing is
built or imported from CUDA when this module is imported, so CPU-only
installs import it freely.  Callers go through the front ends in
:mod:`cuda_mat_tpu_torch.ops.stencil`,
:mod:`cuda_mat_tpu_torch.ops.dia_spmv` and
:mod:`cuda_mat_tpu_torch.ops.banded_trisolve`, which send CPU tensors to the
plain PyTorch twins and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Tuple

import numpy as np
import torch

from cuda_mat_tpu_torch.utils.build import build_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

MAX_TERMS = 64                # kMaxTerms of the kernels' by-value term struct
MAX_DIAGS = 128               # kMaxDiags of kernel B3's by-value offsets
SMEM_LIMIT = 232448           # dynamic shared memory one block may use on H100
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # source -> seconds its build took
                                       # in this process (0 = reused)


def _load(source: str, stem: str, signatures) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, and declare its
    launchers' ``signatures`` (name -> argtypes; all return an int error
    code).  Raises RuntimeError when nvcc is missing or the build fails —
    there is no fallback."""
    if source not in _libs:
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
        if nvcc is None or not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be"
                               " built (set CUDA_HOME)")
        path, build_seconds[source] = build_library(
            [nvcc] + NVCC_FLAGS, os.path.join(CSRC, source), stem)
        lib = ctypes.CDLL(path)
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.cmt_cuda_error_string.restype = ctypes.c_char_p
        lib.cmt_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[source] = lib
    return _libs[source]


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def library() -> ctypes.CDLL:
    """The stencil kernels B1/B2 (``csrc/const_stencil.cu``)."""
    return _load("const_stencil.cu", "libcmt_kernels", {
        "cmt_const_stencil_spmv": [_I, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL,
                                   _LL, _P],
        "cmt_const_series_msolve": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                    _I, _LL, _LL, _LL, _LL, _I, _I, _I, _P]})


def trisolve_library() -> ctypes.CDLL:
    """The banded triangular sweep B4b, which B4a runs twice
    (``csrc/banded_trisolve.cu``)."""
    return _load("banded_trisolve.cu", "libcmt_trisolve", {
        "cmt_banded_sweep": [_I, _P, _P, _P, _P, _LL, _I, _I, _P]})


def dia_library() -> ctypes.CDLL:
    """The banded DIA SpMV B3 (``csrc/dia_spmv.cu``)."""
    return _load("dia_spmv.cu", "libcmt_dia", {
        "cmt_dia_spmv": [_I, _P, _P, _P, _P, _I, _LL, _LL, _P]})


@functools.lru_cache(maxsize=64)
def _term_arrays(terms) -> Tuple[np.ndarray, np.ndarray]:
    return (np.asarray([t[0] for t in terms], np.int64),
            np.asarray([t[1] for t in terms], np.float64))


@functools.lru_cache(maxsize=64)
def _offset_array(offsets) -> np.ndarray:
    return np.asarray(offsets, np.int32)


def msolve_tile(block: int) -> int:
    """Output rows per thread block of the fused msolve kernel: a divisor of
    ``block`` (a multiple of 1024 in every planned layout), so a tile never
    straddles a pad boundary."""
    return 2048 if block % 2048 == 0 else 1024


def msolve_fits(block: int, terms_l, terms_u, itemsize: int) -> bool:
    """The fused msolve kernel takes this layout: both polynomials fit the
    term struct, P_l's reads over the u region stay inside the pad block,
    and the u tile (tile + 2·halo rows) fits shared memory."""
    h_l = max(abs(t[0]) for t in terms_l)
    h_u = max(abs(t[0]) for t in terms_u)
    return (len(terms_l) <= MAX_TERMS and len(terms_u) <= MAX_TERMS
            and h_l + h_u <= block and block % 1024 == 0
            and (msolve_tile(block) + 2 * h_u) * itemsize <= SMEM_LIMIT)


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device,"
                             f" got {[str(u.device) for u in ts]}")
        if t.dtype != ts[0].dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"kernel operands must all be float32 or all"
                             f" float64, got {[u.dtype for u in ts]}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _raise_on(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.cmt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (code {rc})")


def const_stencil_spmv(x_pad: torch.Tensor, gapmask: torch.Tensor, terms,
                       np_true: int, block: int, base: int) -> torch.Tensor:
    """Launch kernel B1 on ``x_pad``'s device and current stream."""
    lib = library()
    _check_cuda(x_pad, gapmask)
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} stencil terms > {MAX_TERMS}")
    y = torch.empty_like(x_pad)
    off, c = _term_arrays(tuple(terms))
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_const_stencil_spmv(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(), gapmask.data_ptr(),
            y.data_ptr(), off.ctypes.data, c.ctypes.data, len(terms),
            x_pad.shape[0] - 2 * block, block, np_true, base,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "const_stencil_spmv")
    return y


def const_series_msolve(x_pad: torch.Tensor, inv_d_pad: torch.Tensor,
                        gapmask_ext: torch.Tensor, terms_l, terms_u,
                        np_true: int, block: int, base: int) -> torch.Tensor:
    """Launch kernel B2 on ``x_pad``'s device and current stream."""
    lib = library()
    _check_cuda(x_pad, inv_d_pad, gapmask_ext)
    if not msolve_fits(block, terms_l, terms_u, x_pad.element_size()):
        raise ValueError("the fused msolve kernel does not take this layout"
                         " (terms, halo or shared memory)")
    y = torch.empty_like(x_pad)
    off_l, c_l = _term_arrays(tuple(terms_l))
    off_u, c_u = _term_arrays(tuple(terms_u))
    halo = max(abs(t[0]) for t in terms_u)
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_const_series_msolve(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(), inv_d_pad.data_ptr(),
            gapmask_ext.data_ptr(), y.data_ptr(), off_l.ctypes.data,
            c_l.ctypes.data, len(terms_l), off_u.ctypes.data, c_u.ctypes.data,
            len(terms_u), x_pad.shape[0] - 2 * block, block, np_true, base,
            (gapmask_ext.shape[0] - block) // 2, halo, msolve_tile(block),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "const_series_msolve")
    return y


def banded_sweep(f: torch.Tensor, wt: torch.Tensor, wct: torch.Tensor,
                 forward: bool) -> torch.Tensor:
    """Launch kernel B4b on ``f``'s device and current stream."""
    lib = trisolve_library()
    _check_cuda(f, wt, wct)
    y = torch.empty_like(f)
    with torch.cuda.device(f.device):
        rc = lib.cmt_banded_sweep(
            _DTYPE_CODE[f.dtype], f.data_ptr(), wt.data_ptr(), wct.data_ptr(),
            y.data_ptr(), wt.shape[0], wt.shape[1], int(forward),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "banded_sweep")
    return y


def dia_spmv(data: torch.Tensor, x_pad: torch.Tensor, offsets,
             block: int) -> torch.Tensor:
    """Launch kernel B3 on ``x_pad``'s device and current stream."""
    lib = dia_library()
    _check_cuda(data, x_pad)
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{len(offsets)} diagonals > {MAX_DIAGS}")
    if x_pad.shape[0] >= 2 ** 31:
        raise ValueError(f"padded length {x_pad.shape[0]} needs 64-bit"
                         " indices; kernel B3 takes 32-bit ones")
    y = torch.empty_like(x_pad)
    off = _offset_array(tuple(offsets))
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_dia_spmv(
            _DTYPE_CODE[x_pad.dtype], data.data_ptr(), x_pad.data_ptr(),
            y.data_ptr(), off.ctypes.data, len(offsets), data.shape[1], block,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "dia_spmv")
    return y
