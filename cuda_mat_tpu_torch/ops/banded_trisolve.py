"""Exact banded ILU(0) triangular solves (counterpart of
:mod:`cuda_mat_tpu.ops.pallas_trisolve`).

For factors whose bandwidth is at most the block size B, each sweep of
``M⁻¹f = U \\ (L \\ f)`` is a blocked recurrence with one neighbour:

    y_b = W_b (f_b − C_b y_{b−1})  =  f_b·Wt[b] − y_{b−1}·WCt[b]

``Wt[b]`` is the transposed inverse of the b-th diagonal triangular block and
``WCt[b]`` the transposed product of that inverse with the coupling block;
both are made once on the host (:meth:`BandedTriSolver.from_factor`, the
same numpy code as the JAX package, so both packages hold the same arrays).
The backward (upper) sweep walks the blocks from the last to the first.

Kernel front ends, each beside its plain PyTorch twin (``*_plain``):
:func:`banded_sweep_padded` (kernel B4b, one sweep) and
:func:`fused_msolve_padded` (kernel B4a, both sweeps: B4b forward, then B4b
backward).  A front end sends a CPU tensor to the twin and a CUDA tensor to
the hand-written kernel (:mod:`._kernels`), or raises; it never falls back.
Each keeps a plain-int ``launches`` count: one per application (a sweep, or
a whole msolve), though the kernels behind it run as up to three or six
CUDA launches.

On the card a sweep is cut into chunks of ``m`` blocks that run at once
(``csrc/banded_trisolve.cu``); :func:`sweep_plan` derives, once per factor,
what that needs from the arrays, and :func:`banded_sweep_chunked_plain` is
the same three-phase algorithm in PyTorch, which tests hold against the
sequential twin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_mat_tpu_torch.ops import _kernels

MAX_BLOCK = 1024   # columns of a block: kernels B4a/B4b give each a thread
H100_SMS = 132     # the chunk count's target for arrays off the card


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
    """Set both kernels' launch counts to 0."""
    banded_sweep_padded.launches = 0
    fused_msolve_padded.launches = 0


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


def bandwidth(csr) -> int:
    """max |col − row| over the stored entries of ``csr``."""
    offs = csr.indices.astype(np.int64) - np.repeat(
        np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    return int(np.abs(offs).max(initial=0))


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
