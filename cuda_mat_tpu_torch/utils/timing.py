"""Phase timing with device-completion semantics.

The reference wraps a wall clock around phases with a
``cudaDeviceSynchronize`` before the stop reading (reference
pbicgstab.cu:372-374).  PyTorch returns before the device finishes, so a
phase on a CUDA device ends with ``torch.cuda.synchronize(device)``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def second() -> float:
    """Wall clock in seconds (name kept from reference helper_cusolver.h:124)."""
    return time.perf_counter()


def device_sync(device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Named phase timers (load / setup / solve, as the reference prints)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None:
                device_sync(device)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.6f} s" for k, v in self.times.items())
