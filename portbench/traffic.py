"""The one traffic generator.  A mix is a JSON file of parameters:

- ``rhs_count``: K right-hand sides made in set-up from the seed;
- ``rhs``: their distribution, ``{"distribution": "uniform", "low", "high"}``
  (i.i.d. entries at the configuration's dtype, drawn on the card);
- ``loop``, ``callers``, ``order``, ``x0``: ``"closed"``, 1, ``"cycle"``,
  ``"ones"``: one caller solving b_0 .. b_{K-1} in turn, each call waiting
  for its answer, until the window ends, with the program's default
  starting guess (all ones), which the reference assumes;
- ``check_sample``: how many of the window's answers the reference judges,
  drawn from the seed (the one that took the most iterations is judged as
  well);
- ``trace_solves``: the whole solves a traced run profiles after the window.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

_DTYPES = {"float32": np.float32, "float64": np.float64}
# the one kind of mix this generator makes
FIXED = {"loop": "closed", "callers": 1, "order": "cycle", "x0": "ones"}


def check(traffic: dict) -> None:
    for key, value in FIXED.items():
        if traffic[key] != value:
            raise ValueError(f"traffic {traffic['name']!r}: {key} ="
                             f" {traffic[key]!r}; this generator makes only"
                             f" {key} = {value!r}")


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """Stream ``stream`` of ``seed``: any whole number, negative or past
    64 bits, maps to one seed sequence."""
    return np.random.SeedSequence([seed % 2 ** 64, stream])


def right_hand_sides(traffic: dict, n: int, dtype: str, seed: int,
                     device="cpu") -> np.ndarray:
    """``(K, n)`` host array of the mix's right-hand sides, drawn one at a
    time on ``device`` by a torch generator seeded from ``seed`` (one seed
    gives the same vectors on one kind of device) and copied to the
    host."""
    import torch

    dist = traffic["rhs"]
    if dist["distribution"] != "uniform":
        raise ValueError(f"unknown distribution {dist['distribution']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_sequence(seed, 0).generate_state(
        1, np.uint64)[0]))
    out = np.empty((int(traffic["rhs_count"]), n), dtype=_DTYPES[dtype])
    for row in out:
        b = torch.rand(n, generator=gen, device=device,
                       dtype=getattr(torch, dtype))
        b.mul_(dist["high"] - dist["low"]).add_(dist["low"])
        row[:] = b.cpu().numpy()
    return out


class Sample:
    """A uniform sample of ``size`` of the window's answers, drawn from the
    seed as they come (reservoir sampling), plus the answer that took the
    most iterations."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self._rng = random.Random(int(seed_sequence(seed, 1).generate_state(1)[0]))
        self._kept: List[tuple] = []
        self._count = 0
        self.longest = None            # (iters, index, item)

    def offer(self, index: int, iters: int, item) -> None:
        if self.longest is None or iters > self.longest[0]:
            self.longest = (iters, index, item)
        self._count += 1
        if len(self._kept) < self.size:
            self._kept.append((index, item))
        else:
            j = self._rng.randrange(self._count)
            if j < self.size:
                self._kept[j] = (index, item)

    def items(self) -> list:
        """``[(index, item)]`` in window order, the longest included once."""
        kept = dict(self._kept)
        if self.longest is not None:
            kept[self.longest[1]] = self.longest[2]
        return sorted(kept.items())
