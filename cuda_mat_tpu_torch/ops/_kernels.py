"""Build, load and launch the hand-written Hopper kernels
(``cuda_mat_tpu_torch/csrc/*.cu``).

Each source is compiled with nvcc for ``sm_90a`` into a shared library with
a plain C interface at first use (into ``cuda_mat_tpu_torch/build/``, see
:mod:`~cuda_mat_tpu_torch.utils.build`) and bound through ctypes.  Nothing is
built or imported from CUDA when this module is imported, so CPU-only
installs import it freely.  Callers go through the front ends in
:mod:`cuda_mat_tpu_torch.ops.stencil`,
:mod:`cuda_mat_tpu_torch.ops.stencil2d`,
:mod:`cuda_mat_tpu_torch.ops.dia_spmv`,
:mod:`cuda_mat_tpu_torch.ops.banded_trisolve` and
:mod:`cuda_mat_tpu_torch.ops.level_trisolve`, which send CPU tensors to the
plain PyTorch twins and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
SMEM_PER_SM = 233472          # shared memory of one SM (228 KB) ...
SMEM_RESERVED = 1024          # ... less 1 KB for each resident block
STATIC_SMEM = 2048            # B1's, B2's, B5's, B6's and B7's static
                              # shared memory (terms)
DOTS_BLOCK = 256              # kDotRows: the rows each B6 partial sums
STREAM_THREADS = 256          # threads of a B1 or B7 block
STREAM_BLOCKS_PER_SM = 4      # their __launch_bounds__ minimum
STAGE_BYTES = 8192            # one B1 ring stage: a tile of x
ROW_BYTES = 4096              # one B7 strip row of x
IN_FLIGHT_BYTES = 49152       # copies the rings of one SM keep in flight
MSOLVE_TILES = (2048, 1024, 512, 256)   # B2/B5 tiles: 256 threads x P rows
MSOLVE_BLOCKS_PER_SM = {8: 2, 4: 4, 2: 4, 1: 4}   # their __launch_bounds__
                                                  # minimum, by P
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # source -> seconds its build took
                                       # in this process (0 = reused)


def _load(source: str, stem: str, signatures,
          headers: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, and declare its
    launchers' ``signatures`` (name -> argtypes; all return an int error
    code).  ``headers``: the ``csrc/`` headers the source includes, part of
    the build's key.  Raises RuntimeError when nvcc is missing or the build
    fails — there is no fallback."""
    if source not in _libs:
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
        if nvcc is None or not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be"
                               " built (set CUDA_HOME)")
        path, build_seconds[source] = build_library(
            [nvcc] + NVCC_FLAGS, os.path.join(CSRC, source), stem,
            [os.path.join(CSRC, h) for h in headers])
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
        "cmt_const_stencil_spmv": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _LL,
                                   _I, _I, _I, _I, _I, _P],
        "cmt_const_series_msolve": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P, _P],
        "cmt_const_stencil_spmv_dots": [_I] + [_P] * 7 + [_I, _P, _P]
                                       + [_I] * 8 + [_P],
        "cmt_const_series_msolve_fma": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _P, _P]},
        headers=("tma_ring.cuh",))


def stencil2d_library() -> ctypes.CDLL:
    """The 2-D tile-ring stencil B7 (``csrc/stencil2d.cu``)."""
    return _load("stencil2d.cu", "libcmt_stencil2d", {
        "cmt_stencil2d_spmv": [_I] + [_P] * 7 + [_I] * 18 + [_P]},
        headers=("tma_ring.cuh",))


def trisolve_library() -> ctypes.CDLL:
    """The banded triangular sweep B4b, which B4a runs twice, on both
    routes: the dense block inverses and the factor's own diagonals
    (``csrc/banded_trisolve.cu``)."""
    return _load("banded_trisolve.cu", "libcmt_trisolve", {
        "cmt_banded_sweep": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                             _I, _I, _I, _I, _P],
        "cmt_diag_sweep": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P,
                           _I, _I, _I, _I, _P],
        "cmt_diag_transfer": [_I, _P, _P, _P, _LL, _I, _P, _I, _I, _I, _I,
                              _P]}, headers=("tma_ring.cuh",))


def level_library() -> ctypes.CDLL:
    """The level-scheduled triangular sweep B8 (``csrc/level_trisolve.cu``)."""
    return _load("level_trisolve.cu", "libcmt_levels", {
        "cmt_level_sweep": [_I] + [_P] * 8 + [_I, _I, _P],
        "cmt_level_chunk_sweep": [_I] + [_P] * 10 + [_I] * 7 + [_P]},
        headers=("tma_ring.cuh",))


def dia_library() -> ctypes.CDLL:
    """The banded DIA SpMV B3 (``csrc/dia_spmv.cu``)."""
    return _load("dia_spmv.cu", "libcmt_dia", {
        "cmt_dia_spmv": [_I, _P, _P, _P, _P, _I, _LL, _LL, _I, _P]})


@functools.lru_cache(maxsize=64)
def _offset_array(offsets) -> np.ndarray:
    return np.asarray(offsets, np.int32)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _blocks_per_sm(smem: int, cap: int = STREAM_BLOCKS_PER_SM) -> int:
    """Blocks of ``smem`` dynamic shared memory (beside the static terms)
    that one SM holds at once, at most ``cap``."""
    return max(1, min(cap, SMEM_PER_SM // (smem + STATIC_SMEM
                                           + SMEM_RESERVED)))


def _ahead(stage_bytes: int) -> int:
    """Stages a ring loads ahead of use: enough for IN_FLIGHT_BYTES from
    STREAM_BLOCKS_PER_SM blocks of an SM, 2 to 16."""
    return min(16, max(2, _ceil(IN_FLIGHT_BYTES,
                                STREAM_BLOCKS_PER_SM * stage_bytes)))


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """Launch geometry of kernels B1 and B6 (``csrc/const_stencil.cu``)."""

    tile: int      # elements of a ring stage: a power of two dividing
                   # block, 4 to 8 KB of x
    halo: int      # tiles the ring keeps on each side of the computed one
    stages: int    # ring stages: 2·halo + 1 and those loading ahead
    ctas: int      # persistent blocks, each with one run of tiles
    smem: int      # dynamic shared memory of a block, in bytes
    vec: int       # elements of one 16-byte load or store


@functools.lru_cache(maxsize=64)
def spmv_plan(npad: int, block: int, reach: int, itemsize: int,
              sms: int) -> SpmvPlan:
    """B1's and B6's geometry for a layout of ``npad`` strided rows in
    blocks of ``block``, terms reaching ``reach`` = max|off'| elements.  A
    tile is STAGE_BYTES of x (halved until it divides ``block``); the ring
    holds the tiles within ``reach`` of the computed one and _ahead more.
    Where that ring would not fit shared memory, its halo shrinks and the
    farther terms read device memory.  As many blocks as fit run on each SM,
    up to STREAM_BLOCKS_PER_SM.  B6's epilogue adds no shared memory: its
    partial trees run in registers and warp shuffles (one warp a
    DOTS_BLOCK-row chunk of the staged y tile, at most 8 chunks a tile), and
    its last block sums the partials through the ring's first
    2·DOTS_BLOCK elements, after every load of the ring has landed."""
    least = 16 * STREAM_THREADS // itemsize   # a 16-byte word per thread
    if block % least or npad % block or npad <= 0:
        raise ValueError(f"kernels B1 and B6 take blocks that are multiples of"
                         f" {least} (block {block}, npad {npad})")
    tile = STAGE_BYTES // itemsize
    while block % tile:
        tile //= 2
    ahead = _ahead(tile * itemsize)
    halo = _ceil(reach, tile)

    def smem_of(h):
        stages = 2 * h + 1 + ahead
        return stages, (stages + 2) * tile * itemsize + 8 * stages

    stages, smem = smem_of(halo)
    while smem > SMEM_LIMIT - STATIC_SMEM and halo > 0:
        halo -= 1
        stages, smem = smem_of(halo)
    ctas = min(npad // tile, sms * _blocks_per_sm(smem))
    return SpmvPlan(tile, halo, stages, ctas, smem, 16 // itemsize)


def _reach(terms) -> Tuple[int, int]:
    """Rows a term set reaches behind and ahead: (max -off, max off), >= 0."""
    return (max(0, -min(t[0] for t in terms)),
            max(0, max(t[0] for t in terms)))


@dataclasses.dataclass(frozen=True)
class MsolvePlan:
    """Launch geometry of kernels B2 and B5 (``csrc/const_stencil.cu``,
    ``const_series_msolve_kernel``): rings of ``tile``-row tiles in shared
    memory, persistent blocks each with one run of tiles."""

    tile: int      # rows of a tile: a power of two dividing block, 256 to
                   # 8 KB of one stream (STREAM_THREADS threads x P rows)
    nin: int       # input streams: 1 (B2's x), 2 or 3 (B5's a, b[, c])
    stages: int    # input ring stages, each the nin streams' tiles and one
                   # of inv_d; 0: lean mode (inputs from device memory)
    xlo: int       # tiles the p ring keeps behind the u tile ...
    xhi: int       # ... and ahead of it
    gp_lo: int     # rows of P_l's reach read from the p ring (a term past
    gp_hi: int     # them reads device memory), copied around the ring
    ulo: int       # tiles of P_u's reach behind a y tile ...
    uhi: int       # ... and ahead: the u ring holds all of it
    ru: int        # rows of the u ring
    gu_lo: int     # rows copied before and after the u ring (0 with wrap)
    gu_hi: int
    wrap: bool     # the u ring wraps each read (its copies do not fit)
    smem: int      # dynamic shared memory of a block, in bytes
    blocks: int    # blocks one SM holds
    ctas: int = 0  # persistent blocks, each with one run of tiles
    run: int = 0   # tiles of the longest run

    @property
    def geo(self) -> Tuple[int, ...]:
        """The kernel's geometry argument (``enum Geo`` of the source)."""
        return (self.tile, self.stages, self.xlo, self.xhi, self.gp_lo,
                self.gp_hi, self.ulo, self.uhi, self.ru, self.gu_lo,
                self.gu_hi, int(self.wrap), self.ctas)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


def _msolve_smem(tile, nin, stages, xlo, xhi, gp, ru, gu, itemsize) -> int:
    """Bytes of shared memory the kernel lays out (as its launcher counts
    them): the input ring, the p ring with its copies, the u ring with its
    copies, the staging tile, the barriers; lean mode only the u ring."""
    rows = gu[0] + ru + gu[1]
    if stages:
        rows += (stages * (nin + 1) * tile + gp[0] + (xlo + xhi + 2) * tile
                 + gp[1] + tile)
    return rows * itemsize + 8 * stages


def msolve_candidates(block: int, reach_l: Tuple[int, int],
                      reach_u: Tuple[int, int], itemsize: int, nin: int):
    """Every ring geometry of B2 (``nin`` 1) or B5 that fits shared memory,
    for terms reaching ``reach_l`` / ``reach_u`` rows (behind, ahead), as
    (key, plan) without the grid: each tile of MSOLVE_TILES that divides
    ``block``; the u ring with its copies, or wrapping; the p ring holding
    all of P_l's reach, or less (farther terms read device memory); 1 to
    16 input stages, or none (lean mode, key None).  The larger key is
    preferred: P_l's whole reach in the ring, no wrap, two blocks an SM
    rather than one, larger tiles, more blocks, two stages rather than one,
    fewer stages.  The kernel's steps are bound by their own work, not by
    the loads' latency: on an H100 one or two stages time alike and larger
    tiles are faster (``tools/msolve_sweep.py``)."""
    vec = 16 // itemsize
    for tile in MSOLVE_TILES:
        if tile * itemsize > STAGE_BYTES or block % tile:
            continue
        cap = MSOLVE_BLOCKS_PER_SM[tile // STREAM_THREADS]
        ulo, uhi = _ceil(reach_u[0], tile), _ceil(reach_u[1], tile)
        rings = [(False, (ulo + uhi + 1) * tile,
                  (_round_up(reach_u[0], vec), _round_up(reach_u[1], vec))),
                 (True, _round_up(max((uhi + 1) * tile + reach_u[0],
                                      (ulo + 1) * tile + reach_u[1]), vec),
                  (0, 0))]
        full = (_ceil(reach_l[0], tile), _ceil(reach_l[1], tile))
        for wrap, ru, gu in rings:
            smem = _msolve_smem(tile, nin, 0, 0, 0, (0, 0), ru, gu, itemsize)
            if smem <= SMEM_LIMIT - STATIC_SMEM:
                yield None, MsolvePlan(tile, nin, 0, 0, 0, 0, 0, ulo, uhi,
                                       ru, gu[0], gu[1], wrap, smem,
                                       _blocks_per_sm(smem, cap))
            for h in range(max(full), -1, -1):
                xlo, xhi = min(full[0], h), min(full[1], h)
                gp = (min(_round_up(reach_l[0], vec), xlo * tile),
                      min(_round_up(reach_l[1], vec), xhi * tile))
                for stages in range(1, 17):
                    smem = _msolve_smem(tile, nin, stages, xlo, xhi, gp, ru,
                                        gu, itemsize)
                    if smem > SMEM_LIMIT - STATIC_SMEM:
                        break
                    blocks = _blocks_per_sm(smem, cap)
                    yield ((xlo, xhi) == full, not wrap, min(blocks, 2),
                           tile, blocks, min(stages, 2), -stages), MsolvePlan(
                               tile, nin, stages, xlo, xhi, gp[0], gp[1],
                               ulo, uhi, ru, gu[0], gu[1], wrap, smem,
                               blocks)


@functools.lru_cache(maxsize=256)
def _msolve_geometry(block: int, reach_l: Tuple[int, int],
                     reach_u: Tuple[int, int], itemsize: int, nin: int):
    """The preferred of :func:`msolve_candidates`; lean mode (the u ring
    alone, without wrap and in the largest tile if it can) only where no
    other fits; None where not even that fits."""
    best, lean = None, None
    for key, plan in msolve_candidates(block, reach_l, reach_u, itemsize,
                                       nin):
        if key is not None:
            if best is None or key > best[0]:
                best = key, plan
        elif lean is None or (not plan.wrap, plan.tile) > lean[0]:
            lean = (not plan.wrap, plan.tile), plan
    return (best or lean or (None, None))[1]


def _msolve_layout_ok(block: int, terms_l, terms_u) -> bool:
    h_l = max(abs(t[0]) for t in terms_l)
    h_u = max(abs(t[0]) for t in terms_u)
    return (0 < len(terms_l) <= MAX_TERMS and 0 < len(terms_u) <= MAX_TERMS
            and h_l + h_u <= block and block % 1024 == 0)


@functools.lru_cache(maxsize=64)
def msolve_plan(npad: int, block: int, terms_l, terms_u, itemsize: int,
                nin: int, sms: int) -> MsolvePlan:
    """B2's (``nin`` 1) or B5's (2 or 3 input streams) launch geometry for
    ``npad`` strided rows in blocks of ``block``, on ``sms`` SMs: the rings
    of :func:`_msolve_geometry`, and as many persistent blocks as the SMs
    hold, at most one per tile.  Raises ValueError on a layout the kernel
    does not take."""
    if not _msolve_layout_ok(block, terms_l, terms_u) or npad <= 0 \
            or npad % block:
        raise ValueError(f"kernels B2/B5 take 1-{MAX_TERMS} terms a"
                         " polynomial, max|off_l| + max|off_u| <= block and"
                         f" blocks that are multiples of 1024 (block {block},"
                         f" npad {npad})")
    geo = _msolve_geometry(block, _reach(terms_l), _reach(terms_u),
                           itemsize, nin)
    if geo is None:
        raise ValueError("kernels B2/B5: P_u's reach does not fit shared"
                         " memory")
    ntiles = npad // geo.tile
    ctas = min(ntiles, sms * geo.blocks)
    return dataclasses.replace(geo, ctas=ctas, run=_ceil(ntiles, ctas))


def msolve_fits(block: int, terms_l, terms_u, itemsize: int) -> bool:
    """Kernel B2 takes this layout: both polynomials fit the term struct,
    P_l's and P_u's reaches together stay inside the pad block, and a plan
    exists (at least P_u's reach in a u ring in shared memory)."""
    return _msolve_layout_ok(block, terms_l, terms_u) and _msolve_geometry(
        block, _reach(terms_l), _reach(terms_u), itemsize, 1) is not None


def msolve_fma_fits(block: int, terms_l, terms_u, itemsize: int) -> bool:
    """Kernel B5 takes this layout, in both forms: B2's conditions with
    three input streams (two need less)."""
    return msolve_fits(block, terms_l, terms_u, itemsize) and \
        _msolve_geometry(block, _reach(terms_l), _reach(terms_u), itemsize,
                         3) is not None


@dataclasses.dataclass(frozen=True)
class Stencil2DPlan:
    """Launch geometry of kernel B7 (``csrc/stencil2d.cu``).  Each block
    takes a strip of ``width`` columns and marches down ``rows`` rows of the
    computed region [0, r_eff) x [0, cw) of the (rp, cp) grid, the rest of
    the padded grid being written as zeros."""

    vec: int       # elements of one copy or store: 16 bytes, or 1 where the
                   # rows are not 16-byte aligned
    r_eff: int     # rows computed (r with the mask, else rp)
    c_eff: int     # columns computed (c with the mask, else cp) ...
    cw: int        # ... rounded up to vec: cells in [c_eff, cw) are 0
    width: int     # columns of a strip (a multiple of vec)
    strips: int
    rows: int      # rows of one block's march
    step_rows: int  # rows a step computes: 8 / P (P = the columns each
                    # thread computes), or 1 where that ring is too large
    hr: int        # rows the ring keeps above and below the computed one
    hc: int        # ring columns on each side of a strip (a multiple of vec)
    stages: int    # x's ring stages, at least 2·hr + 2·step_rows; the
                   # coefficients' ring has stages - 2·hr
    slot: int      # elements of x's stage: a row over the strip and its
                   # column halo (a coefficient stage: a row of each grid)
    ctas: int
    smem: int


@functools.lru_cache(maxsize=64)
def stencil2d_plan(rp: int, cp: int, tr: int, tc: int, r: int, c: int,
                   mask: bool, offsets, itemsize: int, sms: int,
                   aligned: bool = True) -> Stencil2DPlan:
    """B7's geometry for ``offsets`` ((dr, dc, scal or None)) on the
    tile-ring layout.  ``aligned``: the operands' addresses are 16-byte
    aligned; with whole 16-byte rows and tile columns too, the ring's rows
    come by TMA bulk copies and y goes out in 16-byte words.  A strip row
    is ROW_BYTES of x; a step computes 8 / P rows (P = the columns each of
    STREAM_THREADS threads computes), one with variable coefficients; x's
    ring holds a step's rows, hr on
    each side and at least a step's rows ahead, more where that keeps
    IN_FLIGHT_BYTES in flight; the coefficient rows, read by one step
    each, have a ring of their own without the 2·hr halo rows.  Where
    that does not fit shared memory
    the ring keeps fewer rows (then fewer columns, then narrower strips),
    and a term past it reads device memory."""
    v16 = 16 // itemsize
    vec = v16 if aligned and tc % v16 == 0 and cp % v16 == 0 else 1
    r_eff, c_eff = (r, c) if mask else (rp, cp)
    cw = _ceil(c_eff, vec) * vec
    n_var = sum(o[2] is None for o in offsets)
    hr = max(abs(o[0]) for o in offsets)
    hc = _ceil(max(abs(o[1]) for o in offsets), vec) * vec
    width = min(cw, max(vec, min(ROW_BYTES // itemsize, 4 * STREAM_THREADS)
                            // vec * vec))

    def fit(hr, hc, width, multi):
        strips = _ceil(cw, width)
        width = _ceil(_ceil(cw, strips), vec) * vec
        slot = width + 2 * hc
        load = slot + n_var * width   # elements of one load
        per = _ceil(width, STREAM_THREADS)   # columns a thread computes
        per = 4 if per > 2 else per
        step = 8 // per if multi else 1

        def option(ahead):   # (bytes in flight on an SM, blocks), stages
            stages = 2 * hr + step + ahead
            smem = ((stages * slot + (step + ahead) * n_var * width
                     + 2 * step * width + per * STREAM_THREADS)
                    * itemsize + 8 * stages)
            blocks = _blocks_per_sm(smem)
            fits = smem <= SMEM_LIMIT - STATIC_SMEM
            return (fits, min(blocks * ahead * load * itemsize,
                              IN_FLIGHT_BYTES), blocks), stages, smem

        # at least a step's rows ahead: a stage that threads copy themselves
        # (vec 1) is then filled a step before its first reader
        (fits, _, blocks), stages, smem = max(option(a) for a in range(
            step, max(step, _ahead(load * itemsize)) + 1))
        return fits, blocks, (strips, width, step, slot, stages, smem)

    # several rows a step where the coefficients are constant and the ring
    # for them keeps two blocks on an SM.  With variable coefficients one row
    # a step is faster even at equal blocks (an H100 at 3163² in f32, two
    # blocks an SM: 0.136 ms one row a step, 0.162 two rows)
    fits, blocks, geo = fit(hr, hc, width, n_var == 0)
    if not fits or blocks < 2:
        fits, _, geo = fit(hr, hc, width, False)
    while not fits:
        if hr > 0:
            hr -= 1
        elif hc > 0:
            hc = 0
        elif width > vec:
            width = max(vec, width // 2 // vec * vec)
        else:
            raise ValueError("kernel B7 cannot fit one ring row in shared"
                             " memory")
        fits, _, geo = fit(hr, hc, width, False)
    strips, width, step, slot, stages, smem = geo
    ranges = max(1, round(sms * _blocks_per_sm(smem) / strips))
    rows = _ceil(r_eff, ranges)
    ctas = strips * _ceil(r_eff, rows)
    return Stencil2DPlan(vec, r_eff, c_eff, cw, width, strips, rows, step,
                         hr, hc, stages, slot, ctas, smem)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _shards(v: torch.Tensor) -> int:
    """S of a batch of S padded vectors ``(S, L)``; 1 for one vector."""
    return v.shape[0] if v.dim() == 2 else 1


def _per_shard(ctas: int, nshards: int) -> int:
    """A plan's persistent blocks shared out over ``nshards`` shards, one
    grid row each: about as many blocks in all as one vector takes."""
    return max(1, _ceil(ctas, nshards))


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


@functools.lru_cache(maxsize=64)
def _typed_terms(terms, dtype: torch.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """B1's term arrays: 32-bit offsets, and the coefficients rounded to the
    vectors' dtype on the host (as the twin rounds them)."""
    return (np.asarray([t[0] for t in terms], np.int32),
            np.asarray([t[1] for t in terms],
                       np.float32 if dtype == torch.float32 else np.float64))


def _spmv_launch_args(name: str, x_pad: torch.Tensor, gapmask: torch.Tensor,
                      ws, terms, block: int):
    """The checks and geometry B1 and B6 share (the weights ``ws`` are
    B6's): the library, npad, :func:`spmv_plan` and the term arrays."""
    if x_pad.shape[-1] >= 2 ** 31:
        raise ValueError(f"padded length {x_pad.shape[-1]} needs 64-bit"
                         f" indices; kernel {name} takes 32-bit ones")
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} stencil terms > {MAX_TERMS}")
    lib = library()
    _check_cuda(x_pad, gapmask, *ws)
    if any(t.data_ptr() % 16 for t in (x_pad, *ws)):
        raise ValueError(f"kernel {name} streams its vectors by 16-byte"
                         " copies and loads: each must be 16-byte aligned")
    npad = x_pad.shape[-1] - 2 * block
    plan = spmv_plan(npad, block, max(abs(t[0]) for t in terms),
                     x_pad.element_size(), _sm_count(x_pad.device))
    return lib, npad, plan, _typed_terms(tuple(terms), x_pad.dtype)


def const_stencil_spmv(x_pad: torch.Tensor, gapmask: torch.Tensor, terms,
                       np_true: int, block: int, base: int) -> torch.Tensor:
    """Launch kernel B1 on ``x_pad``'s device and current stream: one
    launch for one padded vector or a batch ``(S, L)`` of S shards, shard
    i's base ``base + i·npad``."""
    lib, npad, plan, (off, c) = _spmv_launch_args("B1", x_pad, gapmask, (),
                                                  terms, block)
    y = torch.empty_like(x_pad)
    nshards = _shards(x_pad)
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_const_stencil_spmv(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(), gapmask.data_ptr(),
            y.data_ptr(), off.ctypes.data, c.ctypes.data, len(terms), npad,
            block, np_true - base, nshards, plan.tile.bit_length() - 1,
            plan.halo, plan.stages, _per_shard(plan.ctas, nshards),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "const_stencil_spmv")
    return y


def _msolve_launch(name: str, lib, streams, outs, inv_d_pad, gapmask_ext,
                   terms_l, terms_u, np_true: int, block: int, base: int,
                   nin: int, *extra):
    """Check B2's or B5's operands, plan the launch and call the C entry
    ``name`` with ``extra`` (the operand pointers) first.  One padded
    vector or a batch ``(S, L)`` of S shards, shard i's base ``base +
    i·npad``."""
    x = streams[0]
    if x.shape[-1] >= 2 ** 31:
        raise ValueError(f"padded length {x.shape[-1]} needs 64-bit indices;"
                         " kernels B2/B5 take 32-bit ones")
    if any(t.data_ptr() % 16 for t in (*streams, *outs, inv_d_pad)):
        raise ValueError("kernels B2/B5 stream their vectors by 16-byte"
                         " copies: each must be 16-byte aligned")
    npad = x.shape[-1] - 2 * block
    plan = msolve_plan(npad, block, tuple(terms_l), tuple(terms_u),
                       x.element_size(), nin, _sm_count(x.device))
    nshards = _shards(x)
    off_l, c_l = _typed_terms(tuple(terms_l), x.dtype)
    off_u, c_u = _typed_terms(tuple(terms_u), x.dtype)
    hpad = (gapmask_ext.shape[0] - block) // 2
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(
            _DTYPE_CODE[x.dtype], *extra, off_l.ctypes.data, c_l.ctypes.data,
            len(terms_l), off_u.ctypes.data, c_u.ctypes.data, len(terms_u),
            npad, block, base, np_true, nshards,
            _geo_array(plan, nshards).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, name[4:])


@functools.lru_cache(maxsize=64)
def _geo_array(plan: MsolvePlan, nshards: int = 1) -> np.ndarray:
    """The kernel's geometry argument, its blocks shared out over
    ``nshards`` shards."""
    return np.asarray(plan.geo[:-1] + (_per_shard(plan.ctas, nshards),),
                      np.int32)


def const_series_msolve(x_pad: torch.Tensor, inv_d_pad: torch.Tensor,
                        gapmask_ext: torch.Tensor, terms_l, terms_u,
                        np_true: int, block: int, base: int) -> torch.Tensor:
    """Launch kernel B2 on ``x_pad``'s device and current stream, with the
    layout's cached :func:`msolve_plan` (ValueError where it has none)."""
    lib = library()
    _check_cuda(x_pad, inv_d_pad, gapmask_ext)
    y = torch.empty_like(x_pad)
    gap = gapmask_ext[(gapmask_ext.shape[0] - block) // 2:]
    _msolve_launch("cmt_const_series_msolve", lib, (x_pad,), (y,), inv_d_pad,
                   gapmask_ext, terms_l, terms_u, np_true, block, base, 1,
                   x_pad.data_ptr(), inv_d_pad.data_ptr(), gap.data_ptr(),
                   y.data_ptr())
    return y


# B6's tickets, one per device and stream: an int32 counter (read as a
# uint32 by the kernel; 0 between launches, as the kernel's last block
# resets it)
_dots_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _dots_ticket(device: torch.device, stream: int) -> torch.Tensor:
    """B6's ticket for launches on ``stream`` (a CUDA stream handle) of
    ``device``: zeroed at the first launch there, which must not be inside
    a CUDA-graph capture (the capture's memory would not outlive its
    graph).  Launches on one stream run one after another, so they share
    it; a captured graph keeps its capture stream's ticket, so it is not
    replayed while B6 runs on that stream or in another replay of it."""
    ticket = _dots_tickets.get((device, stream))
    if ticket is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kernel B6's ticket must be made before a"
                               " CUDA graph captures the kernel: launch it"
                               " once on the capturing stream first")
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
        _dots_tickets[device, stream] = ticket
    return ticket


def const_stencil_spmv_dots(x_pad: torch.Tensor, gapmask: torch.Tensor, ws,
                            terms, np_true: int, block: int, base: int,
                            with_self: bool):
    """Launch kernel B6 on ``x_pad``'s device and current stream: one
    launch, the dots' cross-block sum included.  Returns ``(y, dots)``,
    dots ``<w, y>`` for the one weight in ``ws`` (if any), then ``<y, y>``
    with ``with_self``.  The partials (n_dots a DOTS_BLOCK rows) and the
    dots are one allocation of the stream, made per call."""
    n_dots = len(ws) + int(with_self)
    if len(ws) > 1 or n_dots < 1:
        raise ValueError("kernel B6 takes one weight vector at most and at"
                         " least one dot")
    lib, npad, plan, (off, c) = _spmv_launch_args("B6", x_pad, gapmask, ws,
                                                  terms, block)
    stream = torch.cuda.current_stream(x_pad.device).cuda_stream
    ticket = _dots_ticket(x_pad.device, stream)
    y = torch.empty_like(x_pad)
    n_parts = x_pad.shape[0] // DOTS_BLOCK * n_dots
    parts = torch.empty(n_parts + n_dots, dtype=x_pad.dtype,
                        device=x_pad.device)
    dots = parts[n_parts:]
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_const_stencil_spmv_dots(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(), gapmask.data_ptr(),
            ws[0].data_ptr() if ws else None, y.data_ptr(), parts.data_ptr(),
            dots.data_ptr(), ticket.data_ptr(), int(with_self),
            off.ctypes.data, c.ctypes.data, len(terms), npad, block,
            min(max(np_true - base, 0), npad), plan.tile.bit_length() - 1,
            plan.halo, plan.stages, plan.ctas, stream)
    _raise_on(lib, rc, "const_stencil_spmv_dots")
    return y, dots


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
    p = torch.empty_like(a_pad)
    y = torch.empty_like(a_pad)
    gap = gapmask_ext[(gapmask_ext.shape[0] - block) // 2:]
    ptr = [v.data_ptr() for v in (c_pad, c2)] if c_pad is not None \
        else [None, None]
    _msolve_launch("cmt_const_series_msolve_fma", lib, streams, (p, y),
                   inv_d_pad, gapmask_ext, terms_l, terms_u, np_true, block,
                   base, len(streams), a_pad.data_ptr(), b_pad.data_ptr(),
                   ptr[0], c1.data_ptr(), ptr[1], inv_d_pad.data_ptr(),
                   gap.data_ptr(), p.data_ptr(), y.data_ptr())
    return p, y


@functools.lru_cache(maxsize=64)
def _offsets2d_arrays(offsets, dtype: torch.dtype):
    """B7's term arrays: dr, dc, the coefficient grid of each variable term
    (-1 for a scalar one) and the scalars rounded to ``dtype``."""
    var = np.cumsum([o[2] is None for o in offsets]) - 1
    return (np.asarray([o[0] for o in offsets], np.int32),
            np.asarray([o[1] for o in offsets], np.int32),
            np.asarray([v if o[2] is None else -1
                        for v, o in zip(var, offsets)], np.int32),
            np.asarray([0.0 if o[2] is None else o[2] for o in offsets],
                       np.float32 if dtype == torch.float32 else np.float64))


def stencil2d_spmv(coeffs: torch.Tensor, x_pad: torch.Tensor, offsets,
                   tr: int, tc: int, rp: int, cp: int, r: int, c: int,
                   mask: bool) -> torch.Tensor:
    """Launch kernel B7 on ``x_pad``'s device and current stream;
    ``coeffs``: the stacked (n_var, rp, cp) variable-coefficient grids."""
    if x_pad.shape[0] >= 2 ** 31 or coeffs.numel() >= 2 ** 31:
        raise ValueError("the padded grid and the coefficient grids must fit"
                         " 32-bit indices")
    lib = stencil2d_library()
    n_var = coeffs.shape[0]
    _check_cuda(x_pad, *([coeffs] if n_var else []))
    if len(offsets) > MAX_TERMS:
        raise ValueError(f"{len(offsets)} stencil terms > {MAX_TERMS}")
    y = torch.empty_like(x_pad)
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x_pad, y) + ((coeffs,) if n_var else ()))
    g = stencil2d_plan(rp, cp, tr, tc, r, c, mask, tuple(offsets),
                       x_pad.element_size(), _sm_count(x_pad.device),
                       aligned)
    dr, dc, var, cs = _offsets2d_arrays(tuple(offsets), x_pad.dtype)
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_stencil2d_spmv(
            _DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(),
            coeffs.data_ptr() if n_var else None, y.data_ptr(),
            dr.ctypes.data, dc.ctypes.data, var.ctypes.data, cs.ctypes.data,
            len(offsets), tr, tc, rp, cp, g.r_eff, g.c_eff, g.cw, g.vec,
            g.width, g.strips, g.rows, g.step_rows, g.hr, g.hc, g.stages,
            g.slot, g.ctas,
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


def diag_sweep(f: torch.Tensor, vals: torch.Tensor, offsets, diag, plan,
               forward: bool) -> torch.Tensor:
    """Launch kernel B4b of the diagonal-form route on ``f``'s device and
    current stream: the chunked sweep of ``plan`` (a
    ``banded_trisolve.DiagPlan``) over the factor's values ``vals`` (one row
    per offset of ``offsets``) and, backward, U's diagonal ``diag``; up to
    three launches, over scratch for the chunks' exit and entry tails and
    the plan's hand-over slots."""
    lib = trisolve_library()
    _check_cuda(f, vals, plan.t, plan.hand,
                *(() if diag is None else (diag,)))
    y = torch.empty_like(f)
    shat, s = torch.empty(2, max(plan.chunks * plan.tb, 1), dtype=f.dtype,
                          device=f.device)
    off = _offset_array(tuple(offsets))
    with torch.cuda.device(f.device):
        rc = lib.cmt_diag_sweep(
            _DTYPE_CODE[f.dtype], f.data_ptr(), vals.data_ptr(),
            None if diag is None else diag.data_ptr(), plan.t.data_ptr(),
            y.data_ptr(), shat.data_ptr(), s.data_ptr(), plan.hand.data_ptr(),
            f.shape[0], len(offsets), off.ctypes.data, plan.tb, plan.rows,
            plan.chunks,
            int(forward), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "diag_sweep")
    return y


def diag_transfer(vals: torch.Tensor, offsets, diag, n: int, tb: int,
                  rows: int, chunks: int, forward: bool) -> torch.Tensor:
    """The transfer matrices ``(chunks - 1, tb, tb)`` of one sweep of the
    diagonal-form route, made on ``vals``' device by kernel B4b's walk from
    each unit tail, in ``vals``' dtype."""
    lib = trisolve_library()
    _check_cuda(vals, *(() if diag is None else (diag,)))
    t = torch.empty(chunks - 1, tb, tb, dtype=vals.dtype, device=vals.device)
    off = _offset_array(tuple(offsets))
    with torch.cuda.device(vals.device):
        rc = lib.cmt_diag_transfer(
            _DTYPE_CODE[vals.dtype], vals.data_ptr(),
            None if diag is None else diag.data_ptr(), t.data_ptr(), n,
            len(offsets), off.ctypes.data, tb, rows, chunks, int(forward),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "diag_transfer")
    return t


def level_sweep(f: torch.Tensor, plan) -> torch.Tensor:
    """Launch kernel B8 on ``f``'s device and current stream: one sweep of
    ``plan`` (a ``level_trisolve.LevelPlan``) in one cooperative launch of
    ``plan.blocks`` blocks (fewer where the card cannot hold them at
    once), in the plan's layout: a block a chunk, or the grid barrier."""
    lib = level_library()
    ch = plan.chunks
    _check_cuda(f, plan.vals, *(() if plan.diag is None else (plan.diag,)))
    index = (plan.rows, plan.cols) + ((plan.level_ptr, plan.ptr) if ch is None
                                      else (ch.groups, ch.ptr, ch.flags))
    if any(t.device != f.device or t.dtype != torch.int32
           or not t.is_contiguous() for t in index):
        raise ValueError("the plan's index arrays must be contiguous int32"
                         " on f's device")
    y = torch.empty_like(f)
    diag = None if plan.diag is None else plan.diag.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(f.device):
        if ch is None:
            rc = lib.cmt_level_sweep(
                _DTYPE_CODE[f.dtype], f.data_ptr(), y.data_ptr(),
                plan.level_ptr.data_ptr(), plan.rows.data_ptr(),
                plan.ptr.data_ptr(), plan.cols.data_ptr(),
                plan.vals.data_ptr(), diag, plan.levels, plan.blocks, stream)
        else:
            rc = lib.cmt_level_chunk_sweep(
                _DTYPE_CODE[f.dtype], f.data_ptr(), y.data_ptr(),
                ch.groups.data_ptr(), ch.ptr.data_ptr(), plan.rows.data_ptr(),
                plan.cols.data_ptr(), plan.vals.data_ptr(), diag,
                ch.handover.data_ptr(), ch.flags.data_ptr(), plan.n,
                ch.width, ch.count, ch.most, ch.stages, ch.slot, plan.blocks,
                stream)
    _raise_on(lib, rc, "level_sweep")
    return y


def dia_spmv(data: torch.Tensor, x_pad: torch.Tensor, offsets,
             block: int) -> torch.Tensor:
    """Launch kernel B3 on ``x_pad``'s device and current stream: one launch
    for one padded vector, or for a batch ``(S, L)`` of S shards with
    ``data`` ``(ndiag, S, npad)``."""
    lib = dia_library()
    _check_cuda(data, x_pad)
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{len(offsets)} diagonals > {MAX_DIAGS}")
    if x_pad.shape[-1] >= 2 ** 31:
        raise ValueError(f"padded length {x_pad.shape[-1]} needs 64-bit"
                         " indices; kernel B3 takes 32-bit ones")
    y = torch.empty_like(x_pad)
    off = _offset_array(tuple(offsets))
    with torch.cuda.device(x_pad.device):
        rc = lib.cmt_dia_spmv(
            _DTYPE_CODE[x_pad.dtype], data.data_ptr(), x_pad.data_ptr(),
            y.data_ptr(), off.ctypes.data, len(offsets), data.shape[-1],
            block, _shards(x_pad), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, "dia_spmv")
    return y
