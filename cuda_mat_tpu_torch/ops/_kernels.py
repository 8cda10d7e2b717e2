"""Build, load and launch the hand-written Hopper kernels
(``cuda_mat_tpu_torch/csrc/*.cu``).

Each source is compiled with nvcc for ``sm_90a`` into a shared library with
a plain C interface at first use (into ``cuda_mat_tpu_torch/build/``, see
:mod:`~cuda_mat_tpu_torch.utils.build`) and bound through ctypes.  Nothing is
built or imported from CUDA when this module is imported, so CPU-only
installs import it freely.  Callers go through the front ends in
:mod:`cuda_mat_tpu_torch.ops.stencil`,
:mod:`cuda_mat_tpu_torch.ops.stencil2d`,
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
DOTS_BLOCK = 256              # kThreads: the rows each B6 partial sums
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
    """The gap-strided stencil kernels B1, B2, B5 and B6
    (``csrc/const_stencil.cu``)."""
    return _load("const_stencil.cu", "libcmt_kernels", {
        "cmt_const_stencil_spmv": [_I, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL,
                                   _LL, _P],
        "cmt_const_series_msolve": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                    _I, _LL, _LL, _LL, _LL, _I, _I, _I, _P],
        "cmt_const_stencil_spmv_dots": [_I, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _LL, _LL, _LL, _LL, _I, _P],
        "cmt_const_series_msolve_fma": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _I, _P, _P, _I, _LL, _LL,
                                        _LL, _LL, _I, _I, _I, _I, _P]})


def stencil2d_library() -> ctypes.CDLL:
    """The 2-D tile-ring stencil B7 (``csrc/stencil2d.cu``)."""
    return _load("stencil2d.cu", "libcmt_stencil2d", {
        "cmt_stencil2d_spmv": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _P]})


def trisolve_library() -> ctypes.CDLL:
    """The banded triangular sweep B4b, which B4a runs twice
    (``csrc/banded_trisolve.cu``)."""
    return _load("banded_trisolve.cu", "libcmt_trisolve", {
        "cmt_banded_sweep": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                             _I, _I, _I, _I, _P]})


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


def msolve_fma_fits(block: int, terms_l, terms_u, itemsize: int) -> bool:
    """Kernel B5 takes this layout: B2's term and halo limits, and shared
    memory for the combined vector over P_l's window (tile + 2·(h_u + h_l)
    rows) plus the u tile (tile + 2·h_u rows).  Both forms (two and three
    input streams) hold the same shared memory."""
    h_l = max(abs(t[0]) for t in terms_l)
    h_u = max(abs(t[0]) for t in terms_u)
    tile = msolve_tile(block)
    return (msolve_fits(block, terms_l, terms_u, itemsize)
            and (2 * tile + 4 * h_u + 2 * h_l) * itemsize <= SMEM_LIMIT)


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


def const_stencil_spmv_dots(x_pad: torch.Tensor, gapmask: torch.Tensor, ws,
                            terms, np_true: int, block: int, base: int,
                            with_self: bool):
    """Launch kernel B6 on ``x_pad``'s device and current stream.  Returns
    ``(y, partials)``, partials of shape (len(x_pad) / DOTS_BLOCK, n_dots):
    one row per thread block, columns ``<w, y>`` for the one weight in
    ``ws`` (if any), then ``<y, y>`` with ``with_self``."""
    lib = library()
    _check_cuda(x_pad, gapmask, *ws)
    n_dots = len(ws) + int(with_self)
    if len(terms) > MAX_TERMS or len(ws) > 1 or n_dots < 1:
        raise ValueError(f"kernel B6 takes up to {MAX_TERMS} terms, one"
                         " weight vector and at least one dot")
    if x_pad.shape[0] % DOTS_BLOCK:
        raise ValueError(f"padded length {x_pad.shape[0]} is not a multiple"
                         f" of {DOTS_BLOCK}")
    y = torch.empty_like(x_pad)
    partials = torch.empty((x_pad.shape[0] // DOTS_BLOCK, n_dots),
                           dtype=x_pad.dtype, device=x_pad.device)
    off, c = _term_arrays(tuple(terms))
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_const_stencil_spmv_dots(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(), gapmask.data_ptr(),
            ws[0].data_ptr() if ws else None, y.data_ptr(),
            partials.data_ptr(), off.ctypes.data, c.ctypes.data, len(terms),
            x_pad.shape[0] - 2 * block, block, np_true, base, int(with_self),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "const_stencil_spmv_dots")
    return y, partials


def const_series_msolve_fma(a_pad: torch.Tensor, c1: torch.Tensor,
                            b_pad: torch.Tensor, c2, c_pad,
                            inv_d_pad: torch.Tensor,
                            gapmask_ext: torch.Tensor, terms_l, terms_u,
                            np_true: int, block: int, base: int):
    """Launch kernel B5 on ``a_pad``'s device and current stream; ``c1`` and
    ``c2`` are one-element tensors on that device, read there by the kernel
    (``c2``/``c_pad`` None: the two-stream form).  Returns ``(p, y)``."""
    lib = library()
    streams = [a_pad, b_pad] + ([] if c_pad is None else [c_pad])
    scalars = [c1] + ([] if c_pad is None else [c2])
    _check_cuda(*streams, inv_d_pad, gapmask_ext, *scalars)
    if any(s.numel() != 1 for s in scalars):
        raise ValueError("c1 and c2 must be one-element tensors")
    if not msolve_fma_fits(block, terms_l, terms_u, a_pad.element_size()):
        raise ValueError("kernel B5 does not take this layout (terms, halo"
                         " or shared memory)")
    p = torch.empty_like(a_pad)
    y = torch.empty_like(a_pad)
    off_l, c_l = _term_arrays(tuple(terms_l))
    off_u, c_u = _term_arrays(tuple(terms_u))
    ptr = [v.data_ptr() for v in (c_pad, c2)] if c_pad is not None \
        else [None, None]
    with torch.cuda.device(a_pad.device):
        rc = lib.cmt_const_series_msolve_fma(
            _DTYPE_CODE[a_pad.dtype], a_pad.data_ptr(), b_pad.data_ptr(),
            ptr[0], c1.data_ptr(), ptr[1], inv_d_pad.data_ptr(),
            gapmask_ext.data_ptr(), p.data_ptr(), y.data_ptr(),
            off_l.ctypes.data, c_l.ctypes.data, len(terms_l),
            off_u.ctypes.data, c_u.ctypes.data, len(terms_u),
            a_pad.shape[0] - 2 * block, block, np_true, base,
            (gapmask_ext.shape[0] - block) // 2,
            max(abs(t[0]) for t in terms_l), max(abs(t[0]) for t in terms_u),
            msolve_tile(block), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "const_series_msolve_fma")
    return p, y


@functools.lru_cache(maxsize=64)
def _offsets2d_arrays(offsets):
    """B7's term arrays: dr, dc, the coefficient grid of each variable term
    (-1 for a scalar one) and the scalars."""
    var = np.cumsum([o[2] is None for o in offsets]) - 1
    return (np.asarray([o[0] for o in offsets], np.int32),
            np.asarray([o[1] for o in offsets], np.int32),
            np.asarray([v if o[2] is None else -1
                        for v, o in zip(var, offsets)], np.int32),
            np.asarray([0.0 if o[2] is None else o[2] for o in offsets],
                       np.float64))


def stencil2d_spmv(coeffs: torch.Tensor, x_pad: torch.Tensor, offsets,
                   tr: int, tc: int, rp: int, cp: int, r: int, c: int,
                   mask: bool) -> torch.Tensor:
    """Launch kernel B7 on ``x_pad``'s device and current stream;
    ``coeffs``: the stacked (n_var, rp, cp) variable-coefficient grids."""
    lib = stencil2d_library()
    n_var = coeffs.shape[0]
    _check_cuda(x_pad, *([coeffs] if n_var else []))
    if len(offsets) > MAX_TERMS:
        raise ValueError(f"{len(offsets)} stencil terms > {MAX_TERMS}")
    if (rp + 2 * tr) >= 2 ** 31 or (cp + 2 * tc) >= 2 ** 31:
        raise ValueError("padded grid sides must fit 32-bit indices")
    dr, dc, var, cs = _offsets2d_arrays(tuple(offsets))
    y = torch.empty_like(x_pad)
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_stencil2d_spmv(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(),
            coeffs.data_ptr() if n_var else None, y.data_ptr(),
            dr.ctypes.data, dc.ctypes.data, var.ctypes.data, cs.ctypes.data,
            len(offsets), tr, tc, rp, cp, r, c, int(mask),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "stencil2d_spmv")
    return y


def banded_sweep(f: torch.Tensor, wt: torch.Tensor, wct: torch.Tensor, plan,
                 forward: bool) -> torch.Tensor:
    """Launch kernel B4b on ``f``'s device and current stream: the chunked
    sweep of ``plan`` (a ``banded_trisolve.SweepPlan``) in up to three
    launches, over scratch for g and the chunks' exit and entry tails."""
    lib = trisolve_library()
    _check_cuda(f, wt, wct, plan.t)
    y, g = torch.empty_like(f), torch.empty_like(f)
    shat, s = torch.empty(2, plan.chunks * plan.bw, dtype=f.dtype,
                          device=f.device)
    with torch.cuda.device(f.device):
        rc = lib.cmt_banded_sweep(
            _DTYPE_CODE[f.dtype], f.data_ptr(), wt.data_ptr(), wct.data_ptr(),
            plan.t.data_ptr(), y.data_ptr(), g.data_ptr(), shat.data_ptr(),
            s.data_ptr(), wt.shape[0], wt.shape[1], plan.bw, plan.m,
            plan.chunks, int(forward), plan.tri,
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
