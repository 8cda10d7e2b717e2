#!/usr/bin/env python3
"""Compare the stencil kernels B1, B2, B5, B6 and B7 of several checkouts
of the port on one CUDA card, in turns, with chip_smoke.py's own checks and
timers.

    python3 tools/stencil_ab.py ROOT [ROOT ...]

Each ROOT (a directory holding ``cuda_mat_tpu_torch/``; ``.`` for this
checkout) runs in a process of its own, in the order given, so that two
versions are compared on one card as old, new, new, old.  The process
imports ROOT's package and this checkout's ``chip_smoke.py`` and runs four
of its phases: B1 and B2 against their twins at the flagship layout in f32
(``kernel_parity``), B5 (three and two input streams) and B6 (one launch,
its dots' cross-block sum included) at the flagship's fuse_blas1 layout in
f32 with B6's unfused yardstick (``fusion_parity``), the f64 device
times of B2, B5 and B6 at those layouts (``f64_times``), and the 3163 x 3163
grid (``stencil2d_parity``: B1 and B7, constant and variable coefficients,
in f32 and f64).  They print each kernel's time from launch to launch
(``ms``) and on the device (``device_ms``) beside its bound, and fail where
a kernel differs from its twin.  Then it profiles 30 iterations of the
flagship loop and of path 4a's (i) fuse_blas1 and (iii) fused_dots loops
with ``chip_smoke.loop_split``.  The last line is a JSON list of {root,
stats}: chip_smoke's stats of the five kernels.
"""

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("const_stencil_spmv", "const_series_msolve", "const_series_msolve_fma",
         "const_stencil_spmv_dots", "stencil2d_spmv")


def one(root):
    """Run the four phases and the three profiles with the package under
    ``root``; return the stats."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not cs.torch.cuda.is_available():
        raise SystemExit("stencil_ab: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{root}: package {cs.ct.__file__}; {smi}", flush=True)
    stats = {k: {"max_abs_err": 0.0} for k in cs.KERNELS}
    a = cs.ct.grid_laplacian(*cs.FLAGSHIP)
    ps = cs.ct.make_solver(a, cs.FLAGSHIP_CFG, device="cuda")
    cs.kernel_parity(ps, cs.torch.float32, "flagship layout", stats,
                     timed=True)
    cfg_f = cs.FLAGSHIP_CFG.replace(fuse_blas1=True)
    ps_f = cs.ct.make_solver(a, cfg_f, device="cuda")
    cs.fusion_parity(ps_f, cs.torch.float32, "flagship fuse_blas1 layout",
                     stats, timed=True)
    cs.f64_times(ps, ps_f, stats)
    b = cs.np.ones(a.n)
    cut = cs.bs.PreparedSolver(
        a, ps.op, ps.pre, cs.FLAGSHIP_CFG.replace(maxit=cs.PROFILE_ITERS),
        ps.dt_setup)
    cs.loop_split(f"flagship ({root})", lambda: cut.solve(b))
    cs.fusion_profiles(a, ps, ps_f, b, f" ({root})")
    del a, ps, ps_f, cut
    a3 = cs.ct.grid_laplacian(cs.BENCH_SIDE, cs.BENCH_SIDE)
    ps3 = cs.ct.make_solver(a3, cs.ct.SolverConfig(maxit=20000, tol=1e-6),
                            device="cuda")
    cs.stencil2d_parity(ps3, a3, stats, smi)
    return {k: stats[k] for k in NAMES}


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if not argv:
        print(__doc__)
        return 2
    results = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], cwd=REPO, capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            return proc.returncode
        results.append({"root": root, "stats": json.loads(
            proc.stdout.splitlines()[-1])})
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
