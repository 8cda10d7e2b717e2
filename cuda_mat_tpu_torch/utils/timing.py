"""The port's one recorder of host time, and phase timing with
device-completion semantics.

The reference wraps a wall clock around phases with a
``cudaDeviceSynchronize`` before the stop reading (reference
pbicgstab.cu:372-374).  PyTorch returns before the device finishes, so a
phase on a CUDA device ends with ``torch.cuda.synchronize(device)``.

**The recorder.**  A call of the program (a ``solve``, a ``make_solver``,
a ``refine``) opens a record with :func:`record`; inside it
:func:`span` times a named part of the call with two readings of
``time.perf_counter_ns`` and adds the nanoseconds to the record opened
last.  A closed record joins a ring of the last :data:`CAPACITY` records,
:func:`records`.  The recording has no switch.  The loops do not open a
span an iteration: :class:`LoopClock` sums the host's queueing of each
step (``loop.step``, from the step's start to its poll) and the blocking
poll (``loop.poll``) in two integers and writes them into the record when
the loop ends.  While a ``torch.profiler`` records, every span, the
per-iteration ones included, is also a ``record_function`` of its name,
so it lands as a ``user_annotation`` on the kernels' timeline; whether a
profiler records is read once when a record opens (once a span outside a
record), and without one no ``record_function`` is made.

The names a record keeps, nested as the program opens them:

- ``make_solver``: ``make_solver.operator`` (the operator: DIA
  conversion, stencil proof, layout, upload), ``make_solver.precond``
  (the preconditioner: layout re-plan, factors' operators or block
  inverses, uploads), inside it ``precond.factor`` (the host ILU(0) /
  MILU(0) factorization) and, on exact ILU(0)'s ``"levels"`` route,
  ``precond.levels`` (the level analysis of both triangles and its
  upload; the record counts the levels of a forward and a backward sweep
  together as ``levels``, and their chunks on the chunked layout as
  ``chunks``); ``bicgstab_split`` and ``bicg`` build no
  preconditioner and open no ``make_solver.precond``; the distributed
  solver opens neither phase, only ``precond.factor`` where it factors;
- ``solve``: ``solve.prep`` (``solve.prep.b``: b staged, uploaded, cast
  and padded on the device; ``solve.prep.x0``: the default x0 made on the
  device, or a caller's x0 as b; ``solve.prep.sync``: the wait for the
  uploads), ``solve.loop`` (from after that wait to after the loop's
  synchronise: ``SolveResult.dt_alg``, reference pbicgstab.h:108-109;
  the loop's ``loop.step`` and ``loop.poll`` sums inside it),
  ``solve.finish`` (x unpadded and downloaded, the history and scalars
  read back); the record counts the bytes of the vectors that crossed
  the host boundary each way as ``h2d_bytes`` and ``d2h_bytes``;
- ``refine``: ``refine.residual`` (the host f64 residual and its norm)
  and ``refine.inner`` (an inner solve), once a restart.

A span of another name (:class:`PhaseTimer`'s ``phase.<name>``) is only a
profiler annotation.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional

import torch

SPANS = ("make_solver", "make_solver.operator", "make_solver.precond",
         "precond.factor", "precond.levels",
         "solve", "solve.prep", "solve.prep.b", "solve.prep.x0",
         "solve.prep.sync", "solve.loop", "loop.step", "loop.poll",
         "solve.finish",
         "refine", "refine.residual", "refine.inner")
_SLOT = {name: k for k, name in enumerate(SPANS)}
CAPACITY = 16384          # records the ring keeps, the newest last


def second() -> float:
    """Wall clock in seconds (name kept from reference helper_cusolver.h:124)."""
    return time.perf_counter()


def device_sync(device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Record(NamedTuple):
    """One closed call: its ``kind`` (``"solve"``, ``"make_solver"``,
    ``"refine"``), the nanoseconds of each span of :data:`SPANS` (None
    where it did not run), for a solve its iteration count, the loop
    steps executed (a first-half exit included) and the bytes of vectors
    staged up to the device and down from it, and for a make_solver the
    levels of its triangular sweeps (0 off the ``"levels"`` route) and
    their chunks (0 where no sweep takes the chunked layout)."""
    kind: str
    ns: tuple
    iters: int
    steps: int
    levels: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    chunks: int = 0

    def seconds(self, name: str) -> Optional[float]:
        v = self.ns[_SLOT[name]]
        return None if v is None else v / 1e9

    @property
    def spans(self) -> Dict[str, float]:
        """Seconds by span name, of the spans that ran."""
        return {n: v / 1e9 for n, v in zip(SPANS, self.ns) if v is not None}


class OpenRecord:
    """The record of a call in progress (what :func:`record` yields)."""

    __slots__ = ("kind", "ns", "iters", "steps", "levels", "h2d_bytes",
                 "d2h_bytes", "chunks", "profiling")

    def __init__(self, kind: str, profiling: bool):
        self.kind = kind
        self.ns: List[Optional[int]] = [None] * len(SPANS)
        self.iters = 0
        self.steps = 0
        self.levels = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.chunks = 0
        self.profiling = profiling

    def add(self, name: str, ns: int) -> None:
        k = _SLOT.get(name)
        if k is not None:
            self.ns[k] = ns if self.ns[k] is None else self.ns[k] + ns

    def seconds(self, name: str) -> Optional[float]:
        v = self.ns[_SLOT[name]]
        return None if v is None else v / 1e9


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()


def _stack() -> list:
    s = getattr(_local, "open", None)
    if s is None:
        s = _local.open = []
    return s


def current() -> Optional[OpenRecord]:
    """The record this thread opened last and has not closed, or None."""
    s = _stack()
    return s[-1] if s else None


def records() -> List[Record]:
    """The closed records, oldest first (at most :data:`CAPACITY`)."""
    return list(_ring)


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    return torch.autograd._profiler_enabled()


def _annotation(name: str):
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class span:
    """``with span(name) as s:`` times the block into the open record (see
    the module's docstring); ``s.seconds`` holds its duration after it."""

    __slots__ = ("name", "seconds", "_rec", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        rec = self._rec = current()
        prof = rec.profiling if rec is not None else profiling()
        self._rf = _annotation(self.name) if prof else None
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = perf_counter_ns() - self._t0
        self.seconds = ns / 1e9
        if self._rec is not None:
            self._rec.add(self.name, ns)
        if self._rf is not None:
            self._rf.__exit__(*exc)


@contextlib.contextmanager
def record(kind: str):
    """Open a record of ``kind`` and its span of the same name around the
    block; the record joins the ring when the block ends without raising.
    Yields the :class:`OpenRecord` (its ``seconds(kind)`` is the call's
    duration once the block has ended)."""
    rec = OpenRecord(kind, profiling())
    stack = _stack()
    stack.append(rec)
    try:
        with span(kind):
            yield rec
    finally:
        stack.pop()
    _ring.append(Record(kind, tuple(rec.ns), rec.iters, rec.steps,
                        rec.levels, rec.h2d_bytes, rec.d2h_bytes,
                        rec.chunks))


def add_bytes(h2d: int = 0, d2h: int = 0) -> None:
    """Count vector bytes staged to the device (``h2d``) and back
    (``d2h``) into the record opened last, if any."""
    rec = current()
    if rec is not None:
        rec.h2d_bytes += h2d
        rec.d2h_bytes += d2h


class LoopClock:
    """A solver loop's host time without a span an iteration: call
    :meth:`step` as an iteration starts queueing its work (without it the
    step starts where the last poll returned), :meth:`polling` and
    :meth:`polled` around the blocking read that ends it, and
    :meth:`close` after the loop, which adds ``loop.step`` and
    ``loop.poll`` and the steps counted to the record open when the clock
    was made."""

    __slots__ = ("_rec", "_prof", "_rf", "_t", "step_ns", "poll_ns",
                 "steps")

    def __init__(self):
        self._rec = current()
        self._prof = self._rec.profiling if self._rec is not None \
            else profiling()
        self._rf = None
        self._t = perf_counter_ns()
        self.step_ns = self.poll_ns = self.steps = 0

    def step(self) -> None:
        if self._prof:
            self._rf = _annotation("loop.step")
        self._t = perf_counter_ns()

    def polling(self) -> None:
        t = perf_counter_ns()
        self.step_ns += t - self._t
        self._t = t
        if self._prof:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            self._rf = _annotation("loop.poll")

    def polled(self) -> None:
        t = perf_counter_ns()
        self.poll_ns += t - self._t
        self._t = t
        self.steps += 1
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def close(self) -> None:
        if self._rec is not None and self.steps:
            self._rec.add("loop.step", self.step_ns)
            self._rec.add("loop.poll", self.poll_ns)
            self._rec.steps += self.steps


class PhaseTimer:
    """Named phase timers (load / setup / solve, as the reference prints).
    Each phase is a recorder span ``phase.<name>``, so it shows in a
    profiler's trace."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device: Optional[object] = None):
        sp = span("phase." + name)
        try:
            with sp:
                try:
                    yield
                finally:
                    if device is not None:
                        device_sync(device)
        finally:
            self.times[name] = self.times.get(name, 0.0) + sp.seconds

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.6f} s" for k, v in self.times.items())
