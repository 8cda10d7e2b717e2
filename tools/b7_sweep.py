#!/usr/bin/env python3
"""Time kernel B7 over ring geometries around its plan, on one CUDA card.

    python3 tools/b7_sweep.py

At the 3163 x 3163 grid (path 4b's), in f32 and f64, with constant and
variable coefficients, B7 runs under its plan (``_kernels.stencil2d_plan``)
and under variations of it: one row a step or 8 / P, 1 to 4 stages loaded
ahead, the plan's strip width and half of it.  Each line gives the
geometry, the blocks an SM holds, the device time (chip_smoke.device_ms),
the time from launch to launch (chip_smoke.cuda_ms) and whether the output
equals the plain twin bit for bit; the plan's line is marked.
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
from cuda_mat_tpu_torch.ops import stencil2d as t2d  # noqa: E402


def variants(g, n_var, itemsize, sms):
    """Geometries around plan ``g``: (width, step rows, stages ahead)."""
    for div in (1, 2):
        strips = -(-g.cw // (g.width // div))
        width = -(-(-(-g.cw // strips)) // g.vec) * g.vec
        per = -(-width // K.STREAM_THREADS)
        per = 4 if per > 2 else per
        slot = width + 2 * g.hc
        for step in sorted({1, 8 // per}):
            for ahead in range(step, step + 4):
                stages = 2 * g.hr + step + ahead
                smem = ((stages * slot + (step + ahead) * n_var * width
                         + 2 * step * width + per * K.STREAM_THREADS)
                        * itemsize + 8 * stages)
                if smem > K.SMEM_LIMIT - K.STATIC_SMEM:
                    continue
                ranges = max(1, round(sms * K._blocks_per_sm(smem) / strips))
                rows = -(-g.r_eff // ranges)
                yield dataclasses.replace(
                    g, width=width, strips=strips, slot=slot,
                    step_rows=step, stages=stages, smem=smem, rows=rows,
                    ctas=strips * -(-g.r_eff // rows))


def main():
    if not torch.cuda.is_available():
        print("b7_sweep: no CUDA device", file=sys.stderr)
        return 1
    side = cs.BENCH_SIDE
    sms = K._sm_count(torch.device("cuda"))
    plan = K.stencil2d_plan
    x = np.random.default_rng(6).standard_normal(side * side)
    for dtype in (torch.float32, torch.float64):
        for constant in (True, False):
            op = cs.ct.StencilOperator2D.laplacian(
                side, side, dtype, constant=constant, device="cuda")
            xp = op.pad_vec(x)
            args = (op.coeffs, xp, op.offsets, op.tr, op.tc, op.rp, op.cp,
                    op.r, op.c)
            yp = t2d.stencil_spmv_padded_plain(*args)
            g0 = plan(op.rp, op.cp, op.tr, op.tc, op.r, op.c,
                      t2d._needs_mask(op.offsets, op.rp, op.cp, op.r, op.c),
                      tuple(op.offsets), xp.element_size(), sms, True)
            nbytes = (2 * xp.numel() + op.coeffs.numel()) * xp.element_size()
            mode = "constant" if constant else "variable"
            print(f"{side}^2 {str(dtype)[6:]} {mode}: plan {g0}; bound"
                  f" {nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
            for g in variants(g0, op.coeffs.shape[0], xp.element_size(),
                              sms):
                K.stencil2d_plan = lambda *a, g=g: g
                try:
                    equal = torch.equal(t2d.stencil_spmv_padded(*args), yp)
                    dev = cs.device_ms(lambda: t2d.stencil_spmv_padded(*args))
                    ms = cs.cuda_ms(lambda: t2d.stencil_spmv_padded(*args))
                finally:
                    K.stencil2d_plan = plan
                print(f"  width {g.width} step {g.step_rows} stages"
                      f" {g.stages} ({g.stages - 2 * g.hr - g.step_rows}"
                      f" ahead) smem {g.smem} blocks/SM"
                      f" {K._blocks_per_sm(g.smem)}: device {dev:.4f} ms,"
                      f" launch to launch {ms:.4f} ms, equal {equal}"
                      f"{'  <- plan' if g == g0 else ''}", flush=True)
                if not equal:
                    raise RuntimeError("B7 differs from its twin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
