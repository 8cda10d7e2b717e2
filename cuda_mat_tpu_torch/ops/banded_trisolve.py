"""Exact banded ILU(0) triangular solves (counterpart of
:mod:`cuda_mat_tpu.ops.pallas_trisolve`), by one of two routes.

**The diagonal-form route** (:class:`DiagTriSolver`), taken where each
triangle of the factor has at most :data:`DIAG_MAX_OFFSETS` distinct
off-diagonal offsets: the factor's values are kept by offset, one array of
n values per offset and U's diagonal, and a sweep evaluates the recurrence
on them directly,

    y_i = f_i − Σ_o l_{i,i−o} y_{i−o}            (forward, unit L)
    x_i = (f_i − Σ_o u_{i,i+o} x_{i+o}) / u_ii   (backward)

**The dense route** (:class:`BandedTriSolver`), for every other factor whose
bandwidth is at most the block size B, and for the arrays carried over from
the JAX package: each sweep is a blocked recurrence with one neighbour,

    y_b = W_b (f_b − C_b y_{b−1})  =  f_b·Wt[b] − y_{b−1}·WCt[b]

``Wt[b]`` is the transposed inverse of the b-th diagonal triangular block and
``WCt[b]`` the transposed product of that inverse with the coupling block;
both are made once on the host (:meth:`BandedTriSolver.from_factor`, the
same numpy code as the JAX package, so both packages hold the same arrays).
The backward (upper) sweep walks the blocks from the last to the first.

Kernel front ends, each beside its plain PyTorch twin (``*_plain``): kernel
B4b (one sweep) is :func:`diag_sweep` / :func:`banded_sweep_padded`, kernel
B4a (both sweeps: B4b forward, then B4b backward) :func:`diag_msolve` /
:func:`fused_msolve_padded`.  A front end sends a CPU tensor to the twin
and a CUDA tensor to the hand-written kernel (:mod:`._kernels`), or raises;
it never falls back.  Each keeps a plain-int ``launches`` count: one per
application (a sweep, or a whole msolve), though the kernels behind it run
as up to three or six CUDA launches.

On the card a sweep of either route is cut into chunks that run at once
(``csrc/banded_trisolve.cu``), the tail entering each chunk carried across
them through transfer matrices: :func:`diag_plan` and :func:`sweep_plan`
derive, once per factor, what that needs, and
:func:`diag_sweep_chunked_plain` and :func:`banded_sweep_chunked_plain` are
the same three-phase algorithms in PyTorch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cuda_mat_tpu_torch.formats.reorder import bandwidth
from cuda_mat_tpu_torch.ops import _kernels

MAX_BLOCK = 1024   # columns of a block: kernels B4a/B4b give each a thread
H100_SMS = 132     # the chunk count's target for arrays off the card
DIAG_MAX_OFFSETS = 8   # off-diagonal offsets a triangle may have on the
                       # diagonal-form route (the kernel's kK)
# The diagonal-form route's chunk count P balances the walks, whose serial
# depth is 2·n/P positions, against the carry, P steps of a tb × tb
# transfer matrix: P = sqrt(2·n·WALK_S / CARRY_S), on a card at most one
# block of the carry per SM.  On the card a position costs its share of a
# walk step (a warp scan over up to 128 positions) and a carry step one
# hand-over between blocks and a sum over T_c held in registers; on the CPU
# (the plain twin) each is one round of torch calls.
CUDA_WALK_S = 6.3e-9          # a position of the card's walk (H100, f64)
CUDA_CARRY_S = 1.1e-6         # a carry step (H100, f64)
# the bits of the NaN that marks an empty hand-over slot (no arithmetic
# makes it: the card's NaNs are canonical)
HAND_SENTINEL = {torch.float64: 0x7FF4DEAD0BADBEEF, torch.float32: 0x7FA0BEEF}
CPU_WALK_S = 1.5e-5
CPU_CARRY_S = 1e-5


# ---------------------------------------------------------------------------
# The chunked sweep's plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How kernel B4b walks one sweep.  Only the ``bw`` carry rows of each
    WCt[b] (the last ones forward, the first backward) can be nonzero, so a
    block passes on only the matching ``bw`` columns of y_b, its tail
    (``bw`` is rounded up to whole 16-byte rows, at most B: the rows it adds
    are zero, and every carry slab comes by one bulk copy); the sweep runs
    as ``chunks`` chunks of ``m`` blocks in sweep order, and
    ``t[c]`` (bw × bw) carries a tail across chunk c: the product over its
    blocks of −WCt[b][carry rows, carry rows].  ``tri``: 1 if each Wt[b] is
    zero below its diagonal (column j sums rows k ≤ j), 2 if above it (k ≥
    j), 0 if neither."""

    bw: int
    tri: int
    m: int
    t: torch.Tensor   # (chunks, bw, bw), the arrays' dtype and device

    @property
    def chunks(self) -> int:
        return self.t.shape[0]


def carry_rows(block: int, bw: int, forward: bool) -> slice:
    """The rows of WCt[b] that can be nonzero, and the columns of y_b that
    the next block reads."""
    return slice(block - bw, block) if forward else slice(0, bw)


def _any_over_blocks(w: torch.Tensor, fn) -> torch.Tensor:
    """OR of ``fn(slab)`` over slabs of ``w``'s blocks (bounded memory)."""
    out = None
    for i in range(0, w.shape[0], 512):
        part = fn(w[i:i + 512])
        out = part if out is None else out | part
    return out


def sweep_plan(wt: torch.Tensor, wct: torch.Tensor, forward: bool,
               m: int = None) -> SweepPlan:
    """The plan of one sweep over (nb, B, B) arrays, read off the arrays on
    their device: the carry bandwidth (rows of WCt that are not all zero,
    rounded up to a multiple of 16 bytes and at most B), Wt's triangle,
    the chunk length ``m`` and the transfer matrices (made in float64,
    stored in the arrays' dtype).  Default m: P₀ = min(nb, SM
    count) chunks (one thread block per SM; 132, an H100's, off the card),
    m = ⌈nb / P₀⌉, P = ⌈nb / m⌉."""
    nb, block = wt.shape[0], wt.shape[1]
    rows = _any_over_blocks(wct, lambda s: (s != 0).any(dim=2).any(dim=0))
    hit = torch.nonzero(rows).flatten().tolist()
    if not hit:
        bw = 0
    else:
        bw = block - hit[0] if forward else hit[-1] + 1
        per16 = 16 // wct.element_size()
        bw = min(block, -(-bw // per16) * per16)
    below = _any_over_blocks(wt, lambda s: torch.tril(s, -1).ne(0).any())
    above = _any_over_blocks(wt, lambda s: torch.triu(s, 1).ne(0).any())
    tri = 1 if forward and not bool(below) else \
        2 if not forward and not bool(above) else 0
    if m is None:
        sms = (torch.cuda.get_device_properties(wt.device)
               .multi_processor_count if wt.device.type == "cuda"
               else H100_SMS)
        m = -(-nb // min(nb, sms))
    m = max(1, min(int(m), nb))
    chunks = -(-nb // m)
    order = torch.arange(nb, device=wt.device)
    if not forward:
        order = order.flip(0)
    rs = carry_rows(block, bw, forward)
    phi = torch.eye(bw, dtype=torch.float64, device=wt.device).repeat(
        chunks, 1, 1)
    for i in range(m if bw else 0):
        live = (nb - i + m - 1) // m   # chunks that have an i-th block
        b = order[torch.arange(live, device=wt.device) * m + i]
        phi[:live] = -torch.matmul(phi[:live],
                                   wct[b, rs, rs].to(torch.float64))
    return SweepPlan(bw, tri, m, phi.to(wct.dtype).contiguous())


# ---------------------------------------------------------------------------
# Kernel front ends and their plain twins
# ---------------------------------------------------------------------------


def _check_operands(f: torch.Tensor, *pairs) -> None:
    """``f``: (nb·B,) vector; ``pairs``: (Wt, WCt) array pairs, each
    (nb, B, B) with B ≤ MAX_BLOCK."""
    shape = tuple(pairs[0][0].shape)
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"block arrays must be (nb, B, B), got {shape}")
    if shape[1] > MAX_BLOCK:
        raise ValueError(f"block size {shape[1]} > {MAX_BLOCK}: the banded"
                         " trisolve kernels take one thread per column")
    for w in (w for pair in pairs for w in pair):
        if tuple(w.shape) != shape:
            raise ValueError(f"block arrays differ in shape: {tuple(w.shape)}"
                             f" vs {shape}")
    if f.dim() != 1 or f.shape[0] != shape[0] * shape[1]:
        raise ValueError(f"vector must have length nb*B ="
                         f" {shape[0] * shape[1]}, got shape"
                         f" {tuple(f.shape)}")


def banded_sweep_padded_plain(f: torch.Tensor, wt: torch.Tensor,
                              wct: torch.Tensor,
                              forward: bool) -> torch.Tensor:
    """Plain PyTorch twin of kernel B4b: the recurrence one block at a time,
    ``y_b = f_b·Wt[b] − y_{b−1}·WCt[b]`` (the JAX kernel's two products and
    subtraction), from the first block forward or from the last backward."""
    nb, block = wt.shape[0], wt.shape[1]
    fb = f.view(nb, block)
    y = torch.empty_like(fb)
    prev = torch.zeros(block, dtype=f.dtype, device=f.device)
    for b in (range(nb) if forward else range(nb - 1, -1, -1)):
        prev = torch.matmul(fb[b], wt[b]) - torch.matmul(prev, wct[b])
        y[b] = prev
    return y.view(-1)


def banded_sweep_chunked_plain(f: torch.Tensor, wt: torch.Tensor,
                               wct: torch.Tensor, plan: SweepPlan,
                               forward: bool) -> torch.Tensor:
    """Kernel B4b's algorithm in plain PyTorch, phase for phase, with
    ``plan``'s chunks, transfer matrices and skipped rows (the main path
    never calls it; tests hold it against :func:`banded_sweep_padded_plain`).
    The chunks' i-th blocks are taken together, as the kernel's thread
    blocks run at once:

    1. every chunk from a zero incoming tail: g_b = f_b·Wt[b],
       y_b = g_b − tail(y_{b−1})·WCt[b][carry rows]; its exit tail ŝ_c;
    2. the true entry tails, s_0 = 0, s_{c+1} = ŝ_c + s_c·T_c;
    3. chunks 1.. again from s_c over the stored g."""
    nb, block = wt.shape[0], wt.shape[1]
    bw, m, chunks = plan.bw, plan.m, plan.chunks
    rs = carry_rows(block, bw, forward)
    order = torch.arange(nb, device=f.device)
    if not forward:
        order = order.flip(0)
    g = torch.matmul(f.view(nb, 1, block), wt).view(nb, block)
    y = torch.empty_like(g)

    def walk(first, tail):
        """Chunks first.. from their entry tails; returns the exit tails."""
        for i in range(m):
            live = (nb - i + m - 1) // m
            if live <= first:
                break
            b = order[torch.arange(first, live, device=f.device) * m + i]
            yb = g[b] - torch.matmul(tail[:live - first].unsqueeze(1),
                                     wct[b, rs, :]).squeeze(1)
            y[b] = yb
            tail = torch.cat([yb[:, rs], tail[live - first:]])
        return tail

    s_hat = walk(0, torch.zeros(chunks, bw, dtype=f.dtype, device=f.device))
    s = [torch.zeros(bw, dtype=f.dtype, device=f.device)]
    for c in range(chunks - 1):
        s.append(s_hat[c] + torch.matmul(s[c], plan.t[c]))
    if chunks > 1 and bw:
        walk(1, torch.stack(s[1:]))
    return y.view(-1)


def banded_sweep_padded(f: torch.Tensor, wt: torch.Tensor, wct: torch.Tensor,
                        forward: bool, plan: SweepPlan = None
                        ) -> torch.Tensor:
    """One triangular sweep ``f [nb·B] → y [nb·B]``, forward (lower factor)
    or backward (upper factor) over the blocks (counterpart of
    ``cuda_mat_tpu.ops.pallas_trisolve._banded_sweep``).  CPU tensors run
    the plain twin, CUDA tensors kernel B4b with ``plan``, which they
    require (:func:`sweep_plan`, made once per factor: a
    :class:`BandedTriSolver`'s ``plan_lo`` / ``plan_up``)."""
    _check_operands(f, (wt, wct))
    if f.device.type == "cpu":
        return banded_sweep_padded_plain(f, wt, wct, forward)
    if plan is None:
        raise ValueError("kernel B4b needs the sweep's plan (sweep_plan, made"
                         " once per factor)")
    y = _kernels.banded_sweep(f, wt, wct, plan, forward)
    banded_sweep_padded.launches += 1
    return y


banded_sweep_padded.launches = 0


def fused_msolve_padded_plain(f: torch.Tensor, wt_lo, wct_lo, wt_up,
                              wct_up) -> torch.Tensor:
    """Plain PyTorch twin of kernel B4a: the forward sweep over the lower
    factor, then the backward sweep over the upper one."""
    y = banded_sweep_padded_plain(f, wt_lo, wct_lo, True)
    return banded_sweep_padded_plain(y, wt_up, wct_up, False)


def fused_msolve_padded(f: torch.Tensor, wt_lo, wct_lo, wt_up, wct_up,
                        plans=(None, None)) -> torch.Tensor:
    """``M⁻¹f = U \\ (L \\ f)`` over ``nb·B`` padded rows (counterpart of
    ``cuda_mat_tpu.ops.pallas_trisolve._fused_msolve``).  CPU tensors run
    the plain twin, CUDA tensors kernel B4a: the forward sweep of B4b, then
    the backward one (its first phase needs all of y), with ``plans``
    (lower, upper; required there), counted once here and once each by
    B4b.  The TPU fused the two into one launch to keep y in VMEM."""
    _check_operands(f, (wt_lo, wct_lo), (wt_up, wct_up))
    if f.device.type == "cpu":
        return fused_msolve_padded_plain(f, wt_lo, wct_lo, wt_up, wct_up)
    y = banded_sweep_padded(f, wt_lo, wct_lo, True, plans[0])
    x = banded_sweep_padded(y, wt_up, wct_up, False, plans[1])
    fused_msolve_padded.launches += 1
    return x


fused_msolve_padded.launches = 0


def reset_launch_counts() -> None:
    """Set both kernels' launch counts, on both routes, to 0."""
    banded_sweep_padded.launches = 0
    fused_msolve_padded.launches = 0
    diag_sweep.launches = 0
    diag_msolve.launches = 0


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedTriSolver:
    """Banded ILU(0) triangular-solve pair over true-n vectors on the
    arrays' device (counterpart of ``cuda_mat_tpu.ops.pallas_trisolve.
    PallasBandedTriSolver``)."""

    wt_lo: torch.Tensor   # [nb, B, B] transposed inverse of unit-lower blocks
    wct_lo: torch.Tensor  # [nb, B, B] transposed W_b C_b, C: coupling to prev
    wt_up: torch.Tensor   # [nb, B, B] transposed inverse of upper blocks
    wct_up: torch.Tensor  # [nb, B, B] transposed W_b C_b, C: coupling to next
    n: int                # true dimension
    block: int
    unroll: int = 1       # the JAX layout's blocks per grid step: nb is a
                          # multiple of it; the kernels ignore it
    plan_lo: SweepPlan = dataclasses.field(init=False)   # kernel B4b's
    plan_up: SweepPlan = dataclasses.field(init=False)   # plans, per factor

    def __post_init__(self):
        """Derive both sweeps' plans from the arrays: every solver, made
        by :meth:`from_factor` or carried from the JAX package, gets them
        here, once."""
        object.__setattr__(self, "plan_lo",
                           sweep_plan(self.wt_lo, self.wct_lo, True))
        object.__setattr__(self, "plan_up",
                           sweep_plan(self.wt_up, self.wct_up, False))

    @property
    def npad(self) -> int:
        return self.wt_lo.shape[0] * self.block

    @classmethod
    def from_factor(cls, csr, mvals: np.ndarray, block: int = 128,
                    dtype=torch.float32, *, device,
                    unroll: int = 4) -> "BandedTriSolver":
        """Build from a CSR combined ILU(0) factor (strict lower = L with
        unit diagonal, diag + upper = U).  Requires bandwidth <= block on
        both sides.  ``nb`` is padded to a multiple of ``unroll`` with
        identity blocks (W=I, WC=0), which keep the padded rows exactly zero
        in both sweep directions.  The host arithmetic is the JAX package's,
        step for step."""
        n = csr.n
        bw = bandwidth(csr)
        if bw > block:
            raise ValueError(f"bandwidth {bw} exceeds block {block}")
        rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
        cols = csr.indices.astype(np.int64)
        offs = cols - rows
        nb = -(-n // block)
        unroll = max(1, min(unroll, nb, 262144 // (block * block) or 1))
        nb = -(-nb // unroll) * unroll

        cdt = np.float64 if dtype == torch.float64 else np.float32
        lo_diag = np.tile(np.eye(block, dtype=cdt), (nb, 1, 1))
        up_diag = np.tile(np.eye(block, dtype=cdt), (nb, 1, 1))
        c_lo = np.zeros((nb, block, block), dtype=cdt)  # coupling to previous
        c_up = np.zeros((nb, block, block), dtype=cdt)  # coupling to next
        b_of = rows // block
        jb = rows % block
        same = (cols // block) == b_of
        lower = offs < 0
        upper = ~lower  # includes the diagonal

        # in-block entries → dense triangular blocks; off-block entries →
        # dense coupling blocks (exactly one neighbour: bandwidth <= block)
        m_ = np.asarray(mvals)
        for dst, sel in ((lo_diag, lower & same), (up_diag, upper & same),
                         (c_lo, lower & ~same), (c_up, upper & ~same)):
            dst[b_of[sel], jb[sel], cols[sel] % block] = m_[sel]

        w_lo = np.linalg.inv(lo_diag)
        w_up = np.linalg.inv(up_diag)
        wct_lo = np.matmul(w_lo, c_lo)
        wct_up = np.matmul(w_up, c_up)

        def tr(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.transpose(a, (0, 2, 1)))).to(dtype=dtype, device=device)

        return cls(tr(w_lo), tr(wct_lo), tr(w_up), tr(wct_up), n, block,
                   unroll)

    def _pad(self, f: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.npad, dtype=self.wt_lo.dtype,
                          device=self.wt_lo.device)
        out[:self.n] = f
        return out

    def solve_lower(self, f: torch.Tensor) -> torch.Tensor:
        return banded_sweep_padded(self._pad(f), self.wt_lo, self.wct_lo,
                                   True, self.plan_lo)[:self.n]

    def solve_upper(self, f: torch.Tensor) -> torch.Tensor:
        return banded_sweep_padded(self._pad(f), self.wt_up, self.wct_up,
                                   False, self.plan_up)[:self.n]

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        """``M⁻¹ f = U \\ (L \\ f)``: one application of kernel B4a.  (The
        JAX package's ``fused=False``, and its fallback when y would not fit
        the TPU's on-chip memory, run the same two sweeps as two calls; on
        Hopper B4a is those two sweeps, so there is nothing to choose.)"""
        return fused_msolve_padded(self._pad(f), self.wt_lo, self.wct_lo,
                                   self.wt_up, self.wct_up,
                                   (self.plan_lo, self.plan_up))[:self.n]


# ---------------------------------------------------------------------------
# The diagonal-form route
# ---------------------------------------------------------------------------


def factor_offsets(csr):
    """The distinct off-diagonal offsets of ``csr`` (and of its ILU(0)
    factor, which has its pattern) as distances, each descending: (L's
    row − col, U's col − row)."""
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    offs = csr.indices.astype(np.int64) - rows
    if offs.size == 0:
        return (), ()
    lo = max(int(-offs.min()), 0)
    hit = np.nonzero(np.bincount(offs + lo))[0] - lo
    return (tuple(int(-o) for o in hit[hit < 0]),
            tuple(int(o) for o in hit[hit > 0][::-1]))


def diag_route_fits(csr, block: int) -> bool:
    """The route rule: the diagonal form where the band fits ``block`` and
    each triangle has at most :data:`DIAG_MAX_OFFSETS` offsets."""
    lo, up = factor_offsets(csr)
    return (max(lo + up, default=0) <= block
            and max(len(lo), len(up)) <= DIAG_MAX_OFFSETS)


@dataclasses.dataclass(frozen=True)
class DiagPlan:
    """How kernel B4b walks one sweep of the diagonal-form route: the sweep
    positions (row p forward, n − 1 − p backward) run as ``chunks`` chunks
    of ``rows`` positions; the ``tb`` positions before a chunk are its
    entering tail (the largest offset rounded up to whole 16-byte rows), and
    ``t[c]`` (tb × tb, row k the exit tail of chunk c from the unit tail
    e_k under f = 0) carries it across chunk c: s_{c+1} = ŝ_c + s_c·T_c."""

    tb: int
    rows: int
    chunks: int
    t: torch.Tensor   # (chunks − 1, tb, tb), made in float64, stored in
                      # the values' dtype, on their device
    hand: torch.Tensor    # (chunks, tb): the carry's hand-over slots,
                          # each HAND_SENTINEL between sweeps


def diag_chunk_shape(n: int, tb: int, device_type: str,
                     sms: int = H100_SMS) -> tuple:
    """(rows, chunks) of a sweep over n positions with a tb-wide tail: P
    from the cost model above (on a card of ``sms`` SMs at most sms + 1),
    each chunk at least tb long."""
    if tb == 0:   # nothing to carry: the chunks are independent
        rows = min(n, 4096) if device_type == "cuda" else n
        return rows, -(-n // rows)
    if device_type == "cuda":
        walk, carry, cap = CUDA_WALK_S, CUDA_CARRY_S, sms + 1
    else:
        walk, carry, cap = CPU_WALK_S, CPU_CARRY_S, n
    p = min(cap, max(1, round(math.sqrt(2 * n * walk / carry))))
    rows = min(n, max(tb, -(-n // p)))
    return rows, -(-n // rows)


def diag_plan(vals: torch.Tensor, offsets, diag, n: int, forward: bool,
              rows: int = None) -> DiagPlan:
    """The plan of one sweep over the factor's values ``vals`` ((K, n), one
    row per offset) and, backward, U's diagonal: the chunking of
    :func:`diag_chunk_shape` (``rows``, positions a chunk, for tests) and
    the transfer matrices, made in float64 on the values' device (by the
    kernel on a card, by the twin on the CPU)."""
    per16 = 16 // vals.element_size()
    tb = -(-max(offsets, default=0) // per16) * per16
    if rows is None:
        sms = (torch.cuda.get_device_properties(vals.device)
               .multi_processor_count if vals.device.type == "cuda"
               else H100_SMS)
        rows, chunks = diag_chunk_shape(n, tb, vals.device.type, sms)
    else:
        rows = max(1, min(int(rows), n))
        chunks = -(-n // rows)
    bits = torch.int64 if vals.dtype == torch.float64 else torch.int32
    hand = torch.full((chunks, tb), HAND_SENTINEL[vals.dtype], dtype=bits,
                      device=vals.device).view(vals.dtype)
    if chunks == 1 or tb == 0:
        t = torch.zeros(0, tb, tb, dtype=vals.dtype, device=vals.device)
        return DiagPlan(tb, rows, chunks, t, hand)
    v64 = vals.to(torch.float64)
    d64 = None if diag is None else diag.to(torch.float64)
    if vals.device.type == "cpu":
        t = diag_transfer_plain(v64, offsets, d64, n, tb, rows, chunks,
                                forward)
    else:
        t = _kernels.diag_transfer(v64, offsets, d64, n, tb, rows, chunks,
                                   forward)
    return DiagPlan(tb, rows, chunks, t.to(vals.dtype).contiguous(), hand)


def _staged(f: torch.Tensor, vals: torch.Tensor, diag, forward: bool):
    """f and the values in sweep order, as the kernel stages them: backward,
    each row scaled by 1 / u_ii, so that both sweeps walk
    y_q = f'_q − Σ_k v'_k[q]·y_{q − o_k}."""
    if not forward:
        r = torch.reciprocal(diag)
        return (f * r).flip(-1), (vals * r).flip(-1)
    return f, vals


def _in_chunks(v: torch.Tensor, chunks: int, rows: int) -> torch.Tensor:
    """(..., n) → (..., chunks, rows), the last chunk padded with zeros."""
    pad = chunks * rows - v.shape[-1]
    return torch.nn.functional.pad(v, (0, pad)).unflatten(-1, (chunks, rows))


def _walk(fc: torch.Tensor, vc: torch.Tensor, offsets, tails: torch.Tensor):
    """Walk C chunks at once: ``fc`` (C, L), ``vc`` (K, C, L), the entering
    ``tails`` (C, tb); the sum in descending offsets.  Returns y (C, L) and
    the exit tails (C, tb), the last tb positions of tail and chunk."""
    tb, rows = tails.shape[1], fc.shape[1]
    if not offsets:
        return fc.clone(), torch.cat([tails, fc], dim=1)[:, rows:]
    ys = list(tails.t().unbind(0))
    fr = fc.t().unbind(0)
    vr = [v.t().unbind(0) for v in vc]
    for i in range(rows):
        acc = fr[i]
        for k, o in enumerate(offsets):
            acc = acc - vr[k][i] * ys[tb + i - o]
        ys.append(acc)
    y = torch.stack(ys, dim=1)
    return y[:, tb:], y[:, rows:]


def diag_transfer_plain(vals: torch.Tensor, offsets, diag, n: int, tb: int,
                        rows: int, chunks: int,
                        forward: bool) -> torch.Tensor:
    """The transfer matrices ``(chunks − 1, tb, tb)`` in PyTorch, as the
    kernel makes them: every chunk but the last walked from each unit tail
    with f = 0 (in slabs of chunks, to bound memory)."""
    _, vs = _staged(torch.zeros(n, dtype=vals.dtype, device=vals.device),
                    vals, diag, forward)
    vc = _in_chunks(vs, chunks, rows)[:, :chunks - 1]
    eye = torch.eye(tb, dtype=vals.dtype, device=vals.device)
    per = max(1, (1 << 22) // max(1, tb * rows * max(1, len(offsets))))
    out = []
    for c0 in range(0, chunks - 1, per):
        part = vc[:, c0:c0 + per].repeat_interleave(tb, dim=1)
        m = part.shape[1]
        _, exits = _walk(torch.zeros(m, rows, dtype=vals.dtype,
                                     device=vals.device),
                         part, offsets, eye.repeat(m // tb, 1))
        out.append(exits.reshape(-1, tb, tb))
    return torch.cat(out)


def diag_sweep_chunked_plain(f: torch.Tensor, vals: torch.Tensor, offsets,
                             diag, plan: DiagPlan,
                             forward: bool) -> torch.Tensor:
    """Kernel B4b's diagonal-form algorithm in plain PyTorch, phase for
    phase (the CPU front end; tests hold it against the dense route's
    sequential twin and a dense triangular solve):

    1. every chunk from a zero entering tail; its exit tail ŝ_c;
    2. the true entering tails, s_0 = 0, s_{c+1} = ŝ_c + s_c·T_c;
    3. chunks 1.. again from s_c."""
    n = f.shape[0]
    fs, vs = _staged(f, vals, diag, forward)
    fc = _in_chunks(fs, plan.chunks, plan.rows)
    vc = _in_chunks(vs, plan.chunks, plan.rows)
    zero = torch.zeros(plan.chunks, plan.tb, dtype=f.dtype, device=f.device)
    y, s_hat = _walk(fc, vc, offsets, zero)
    if plan.chunks > 1 and plan.tb:
        s = [zero[0]]
        for c in range(plan.chunks - 1):
            s.append(s_hat[c] + torch.matmul(s[c], plan.t[c]))
        y = torch.cat([y[:1], _walk(fc[1:], vc[:, 1:], offsets,
                                    torch.stack(s[1:]))[0]])
    y = y.reshape(-1)[:n]
    return y if forward else y.flip(0)


def _check_diag(f: torch.Tensor, vals: torch.Tensor, offsets, diag,
                forward: bool) -> None:
    """``f``: (n,); ``vals``: (K, n), K = len(offsets) ≤ DIAG_MAX_OFFSETS,
    offsets descending and positive; backward, ``diag`` (n,)."""
    n = f.shape[0] if f.dim() == 1 else -1
    if f.dim() != 1 or vals.dim() != 2 or vals.shape != (len(offsets), n):
        raise ValueError(f"want f (n,) and values (K, n) for K ="
                         f" {len(offsets)} offsets, got {tuple(f.shape)}"
                         f" and {tuple(vals.shape)}")
    if len(offsets) > DIAG_MAX_OFFSETS or any(
            o < 1 for o in offsets) or list(offsets) != sorted(
                set(offsets), reverse=True):
        raise ValueError(f"offsets must be at most {DIAG_MAX_OFFSETS}"
                         f" distinct positive distances, descending: got"
                         f" {tuple(offsets)}")
    if not forward and (diag is None or tuple(diag.shape) != (n,)):
        raise ValueError("the backward sweep needs U's diagonal, (n,)")


def _sweep(f, vals, offsets, diag, plan, forward: bool) -> torch.Tensor:
    """One checked sweep: the twin on the CPU, else kernel B4b, counted."""
    if f.device.type == "cpu":
        return diag_sweep_chunked_plain(f, vals, offsets, diag, plan, forward)
    y = _kernels.diag_sweep(f, vals, offsets, diag, plan, forward)
    diag_sweep.launches += 1
    return y


def _need_plans(*plans) -> None:
    if any(p is None for p in plans):
        raise ValueError("kernel B4b needs the sweep's plan (diag_plan, made"
                         " once per factor)")


def diag_sweep(f: torch.Tensor, vals: torch.Tensor, offsets, diag,
               plan: DiagPlan, forward: bool) -> torch.Tensor:
    """One triangular sweep ``f [n] → y [n]`` of the diagonal-form route,
    forward over L's strict part (``diag`` None: unit diagonal) or backward
    over U.  CPU tensors run the plain twin, CUDA tensors kernel B4b with
    ``plan`` (:func:`diag_plan`, made once per factor), which both
    require."""
    _check_diag(f, vals, offsets, diag, forward)
    _need_plans(plan)
    return _sweep(f, vals, offsets, diag, plan, forward)


diag_sweep.launches = 0


def diag_msolve_plain(f: torch.Tensor, lo_vals, lo_offs, up_vals, up_offs,
                      up_diag, plans) -> torch.Tensor:
    """Plain PyTorch twin of kernel B4a on the diagonal-form route: the
    forward sweep, then the backward one, each phase for phase."""
    y = diag_sweep_chunked_plain(f, lo_vals, lo_offs, None, plans[0], True)
    return diag_sweep_chunked_plain(y, up_vals, up_offs, up_diag, plans[1],
                                    False)


def diag_msolve(f: torch.Tensor, lo_vals, lo_offs, up_vals, up_offs,
                up_diag, plans) -> torch.Tensor:
    """``M⁻¹f = U \\ (L \\ f)`` over n rows on the diagonal-form route.
    CPU tensors run the plain twin, CUDA tensors kernel B4a: B4b forward,
    then backward, with ``plans`` (lower, upper), counted once here and
    once each by B4b."""
    _check_diag(f, lo_vals, lo_offs, None, True)
    _check_diag(f, up_vals, up_offs, up_diag, False)
    _need_plans(*plans)
    if f.device.type == "cpu":
        return diag_msolve_plain(f, lo_vals, lo_offs, up_vals, up_offs,
                                 up_diag, plans)
    y = _sweep(f, lo_vals, lo_offs, None, plans[0], True)
    x = _sweep(y, up_vals, up_offs, up_diag, plans[1], False)
    diag_msolve.launches += 1
    return x


diag_msolve.launches = 0


@dataclasses.dataclass(frozen=True)
class DiagTriSolver:
    """ILU(0) triangular-solve pair over true-n vectors on the values'
    device, the factor kept by offset (the diagonal-form route; counterpart
    of ``cuda_mat_tpu.ops.pallas_trisolve.PallasBandedTriSolver``)."""

    lo_vals: torch.Tensor   # (K_lo, n): row i's entry at column i − lo_offs[k]
    lo_offs: tuple          # L's offsets as distances, descending
    up_vals: torch.Tensor   # (K_up, n): row i's entry at column i + up_offs[k]
    up_offs: tuple          # U's offsets as distances, descending
    up_diag: torch.Tensor   # (n,) U's diagonal
    n: int
    plan_lo: DiagPlan = dataclasses.field(init=False)   # kernel B4b's
    plan_up: DiagPlan = dataclasses.field(init=False)   # plans, per factor

    def __post_init__(self):
        object.__setattr__(self, "plan_lo", diag_plan(
            self.lo_vals, self.lo_offs, None, self.n, True))
        object.__setattr__(self, "plan_up", diag_plan(
            self.up_vals, self.up_offs, self.up_diag, self.n, False))

    @classmethod
    def from_factor(cls, csr, mvals: np.ndarray, block: int = 128,
                    dtype=torch.float32, *, device) -> "DiagTriSolver":
        """From a CSR combined ILU(0) factor (strict lower = L with unit
        diagonal, diag + upper = U), its values unchanged, stored by offset
        in ``dtype`` on ``device``.  Requires :func:`diag_route_fits`."""
        if not diag_route_fits(csr, block):
            raise ValueError(f"the factor's band exceeds block {block} or a"
                             f" triangle has more than {DIAG_MAX_OFFSETS}"
                             f" offsets")
        n = csr.n
        lo_offs, up_offs = factor_offsets(csr)
        rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
        offs = csr.indices.astype(np.int64) - rows
        m_ = np.asarray(mvals, dtype=np.float64)
        cdt = np.float64 if dtype == torch.float64 else np.float32

        def by_offset(sel, dists):
            out = np.zeros((len(dists), n), dtype=cdt)
            slot = np.zeros(max(dists, default=0) + 1, dtype=np.int64)
            slot[list(dists)] = np.arange(len(dists))
            out.reshape(-1)[slot[np.abs(offs[sel])] * n + rows[sel]] = \
                m_[sel]
            return torch.from_numpy(out).to(device=device)

        diag = np.zeros(n, dtype=cdt)
        diag[rows[offs == 0]] = m_[offs == 0]
        return cls(by_offset(offs < 0, lo_offs), lo_offs,
                   by_offset(offs > 0, up_offs), up_offs,
                   torch.from_numpy(diag).to(device=device), n)

    def solve_lower(self, f: torch.Tensor) -> torch.Tensor:
        return diag_sweep(f.contiguous(), self.lo_vals, self.lo_offs, None,
                          self.plan_lo, True)

    def solve_upper(self, f: torch.Tensor) -> torch.Tensor:
        return diag_sweep(f.contiguous(), self.up_vals, self.up_offs,
                          self.up_diag, self.plan_up, False)

    def msolve(self, f: torch.Tensor) -> torch.Tensor:
        """``M⁻¹ f = U \\ (L \\ f)``: one application of kernel B4a."""
        return diag_msolve(f.contiguous(), self.lo_vals, self.lo_offs,
                           self.up_vals, self.up_offs, self.up_diag,
                           (self.plan_lo, self.plan_up))
