#!/usr/bin/env python3
"""Time kernels B2 and B5 over ring geometries around their plan, on one
CUDA card.

    python3 tools/msolve_sweep.py

At the flagship layout (grid_laplacian(100000, 100), Neumann-ILU k=4; B2)
and at its fuse_blas1 layout (B5 with three and with two input streams),
in f32 and f64, each kernel runs under its plan (``_kernels.msolve_plan``)
and under every other geometry of ``_kernels.msolve_candidates`` that keeps
P_l's whole reach in the p ring and the u ring's copies: each tile, 1 to
MAX_STAGES input stages.  Each line gives the geometry, the blocks an SM
holds, the device time (chip_smoke.device_ms), the time from launch to
launch (chip_smoke.cuda_ms) and whether the outputs equal the plain twin
bit for bit; the plan's line is marked.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cuda_mat_tpu_torch.ops import _kernels as K  # noqa: E402
from cuda_mat_tpu_torch.ops import stencil as st  # noqa: E402

MAX_STAGES = 4   # on an H100 more stages time as two do


def sweep(ps, dtype, nin, sms):
    """Time B2 (``nin`` 1) or B5 on ``ps``'s layout over the geometries."""
    op, pre = ps.op, ps.pre
    rng = np.random.default_rng(7)
    vecs = [op.pad_vec(rng.standard_normal(op.n)).to(dtype)
            for _ in range(3)]
    layout = (pre.inv_d.to(dtype), pre.gap_ext.to(dtype),
              pre.nl.strided_terms, pre.nu.strided_terms, op.np_true,
              op.block, op.sub)
    if nin == 1:
        def call():
            return (st.const_series_msolve_padded(vecs[0], *layout),)
        want = (st.const_series_msolve_padded_plain(vecs[0], *layout),)
        name = "B2"
    else:
        c1 = torch.tensor(0.5, dtype=dtype, device="cuda")
        c2 = torch.tensor(-0.5, dtype=dtype, device="cuda")
        args = (vecs[0], c1, vecs[1], c2 if nin == 3 else None,
                vecs[2] if nin == 3 else None, *layout)

        def call():
            return st.const_series_msolve_fma_padded(*args)
        want = st.const_series_msolve_fma_padded_plain(*args)
        name = f"B5, {nin} streams"
    tl, tu = tuple(pre.nl.strided_terms), tuple(pre.nu.strided_terms)
    isz = vecs[0].element_size()
    plan = K.msolve_plan
    g0 = plan(op.npad, op.block, tl, tu, isz, nin, sms)
    nbytes = ((nin + 1 + (1 if nin == 1 else 2)) * vecs[0].numel()
              + op.block) * isz
    print(f"{name} {str(dtype)[6:]}, block {op.block}: plan {g0}; bound"
          f" {nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    for key, g in K.msolve_candidates(op.block, K._reach(tl), K._reach(tu),
                                      isz, nin):
        if key is None or not key[0] or not key[1] \
                or g.stages > MAX_STAGES:
            continue
        n = op.npad // g.tile
        g = dataclasses.replace(g, ctas=min(n, sms * g.blocks),
                                run=-(-n // min(n, sms * g.blocks)))
        K.msolve_plan = lambda *a, g=g: g
        try:
            equal = all(torch.equal(a, b) for a, b in zip(call(), want))
            dev = cs.device_ms(call)
            ms = cs.cuda_ms(call)
        finally:
            K.msolve_plan = plan
        print(f"  tile {g.tile} stages {g.stages} smem {g.smem} blocks/SM"
              f" {g.blocks} ctas {g.ctas} run {g.run}: device {dev:.4f} ms,"
              f" launch to launch {ms:.4f} ms, equal {equal}"
              f"{'  <- plan' if g == g0 else ''}", flush=True)
        if not equal:
            raise RuntimeError(f"{name} differs from its twin")


def main():
    if not torch.cuda.is_available():
        print("msolve_sweep: no CUDA device", file=sys.stderr)
        return 1
    sms = K._sm_count(torch.device("cuda"))
    a = cs.ct.grid_laplacian(*cs.FLAGSHIP)
    for fuse, nins in ((False, (1,)), (True, (3, 2))):
        ps = cs.ct.make_solver(a, cs.FLAGSHIP_CFG.replace(fuse_blas1=fuse),
                               device="cuda")
        for dtype in (torch.float32, torch.float64):
            for nin in nins:
                sweep(ps, dtype, nin, sms)
        del ps
    return 0


if __name__ == "__main__":
    sys.exit(main())
