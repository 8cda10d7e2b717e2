#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this directory
and ``cuda_mat_tpu_torch``.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``.  Set-up makes the matrix and the right-hand sides (from
``--seed``), builds the prepared solver and runs one warm-up solve; the
window then solves for ``--seconds``; with ``--trace 1`` a few whole solves
are profiled after it.  Once the window has closed the reference judges a
sample of its answers.  The last line of standard output is the result, a
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.  Without a card, or with fewer cards than the cell
asks for, the run exits 2 and prints no result; it exits 3 if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def process_age() -> float:
    """Seconds since this process started (Linux; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi not read ({e})"
    return "card (name, power limit, max SM clock): " + out.replace("\n", "; ")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this"
              f" machine has {torch.cuda.device_count()} usable",
              file=sys.stderr)
        return 2
    result, info, checks = harness.run(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        T_START, AGE_AT_START)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    info.append(card_line())
    info.append(f"cards used {cell.chips} of {torch.cuda.device_count()},"
                f" torch {torch.__version__}, CUDA {torch.version.cuda}")
    for line in info:
        print(line, flush=True)
    for line in checks:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
