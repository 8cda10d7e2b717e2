#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``limits/<cell>.json``).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--out <file>.jsonl]

In one process on the card: the program set up once as the cell runs it;
for each seed the first ``ANSWERS`` of the mix's right-hand sides solved
once each, in turn, as the window solves them, and every answer judged by
the reference's numbers; a seed's reading of a number is the largest over
its answers.
Then the control, the limits file's ``control``, on its seeds:

- ``{"kind": "program", "solver": {...}}``: the program with the given
  solver fields changed (its own lower-precision path);
- ``{"kind": "reference", "dtype": ...}``: the reference's plain BiCGSTAB
  (``reference/bicgstab.py``) in the program's place, in that dtype.

Prints one JSON line a seed and side, and the largest reading of the
program and the smallest of the control for each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import matrices, spec, traffic  # noqa: E402
from portbench.reference.check import NAMES, answer_readings  # noqa: E402

ANSWERS = 16      # answers judged a seed: more than a run judges (13)


def _reading(a_ref, x0_ref, rhs, answers, seed, side, t0) -> dict:
    """answers: ``[(x, converged, iters, reported_residual, peak)]`` a b,
    ``peak`` the largest residual norm the solve recorded over its first
    (None where it records none)."""
    r = answer_readings(a_ref, x0_ref, [(b, x, res) for b, (x, _, _, res, _)
                                        in zip(rhs, answers)])
    r["unconverged"] = sum(not a[1] for a in answers)
    gaps = [answer_readings(a_ref, x0_ref, [(b, a[0], a[3])])["res_gap"]
            for b, a in zip(rhs, answers)]
    return dict(side=side, seed=seed, **r, iters=[a[2] for a in answers],
                gaps=gaps, peaks=[a[4] for a in answers],
                seconds=time.perf_counter() - t0)


def program_readings(cell, seeds, device, overrides=None, count=ANSWERS):
    import torch

    from portbench.harness import prepared_solver
    from portbench.reference.operator import CSROperator

    cfg = cell.config
    solver = dict(cfg["solver"], **(overrides or {}))
    csr = matrices.make(cfg["matrix"])
    x0_ref = np.ones(csr.n)
    ps = prepared_solver(csr, cfg, solver, torch.device(device))
    ps.solve(traffic.right_hand_sides(cell.traffic, csr.n, solver["dtype"],
                                      seeds[0], device)[0])
    a_ref = CSROperator(csr.indptr, csr.indices, csr.data, device,
                        torch.float64)
    side = "control" if overrides else "program"
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        rhs = traffic.right_hand_sides(cell.traffic, csr.n, solver["dtype"],
                                       seed, device)[:count]
        answers = []
        for b in rhs:
            r = ps.solve(b)
            hist = r.residual_history[r.residual_history >= 0]
            answers.append((r.x, r.converged, int(r.iters), r.residual,
                            float(hist.max() / r.residual0)))
        out.append(_reading(a_ref, x0_ref, rhs, answers, seed, side, t0))
        print(json.dumps(out[-1]), flush=True)
    del ps, a_ref
    return out


def reference_readings(cell, seeds, device, dtype: str, count=ANSWERS):
    import torch

    from portbench.reference import bicgstab
    from portbench.reference.operator import CSROperator

    cfg = cell.config
    csr = matrices.make(cfg["matrix"])
    x0_ref = np.ones(csr.n)
    a_low = CSROperator(csr.indptr, csr.indices, csr.data, device,
                        getattr(torch, dtype))
    a_ref = CSROperator(csr.indptr, csr.indices, csr.data, device,
                        torch.float64)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        rhs = traffic.right_hand_sides(cell.traffic, csr.n,
                                       cfg["solver"]["dtype"], seed,
                                       device)[:count]
        answers = [bicgstab.solve(a_low, b, x0_ref, cfg["solver"]["tol"],
                                  cfg["solver"]["maxit"]) + (None,)
                   for b in rhs]
        out.append(_reading(a_ref, x0_ref, rhs, answers, seed, "control", t0))
        print(json.dumps(out[-1]), flush=True)
    return out


def control_readings(cell, seeds, device, count=ANSWERS):
    control = cell.limits["control"]
    if control["kind"] == "program":
        return program_readings(cell, seeds, device, control["solver"],
                                count)
    return reference_readings(cell, seeds, device, control["dtype"], count)


def summary(program, control) -> dict:
    """The lower reading (the program's largest) and the upper (the
    control's smallest) of each number."""
    return {name: {"lower": max(r[name] for r in program),
                   "upper": min(r[name] for r in control) if control
                   else None} for name in NAMES}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    prog = program_readings(cell, seeds, args.device)
    ctrl = control_readings(cell, cseeds, args.device) if cseeds else []
    line = {"workload": args.workload, "summary": summary(prog, ctrl)}
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in prog + ctrl + [line]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
