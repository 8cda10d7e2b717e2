"""Device time of the kernels that PyTorch and the CUDA libraries launch
(elementwise passes, reductions, cuBLAS dots; every kernel that is not the
program's own) over the traced solves' iterations, in ms."""


def read(rec):
    iters = sum(r.iters for r in rec.traced)
    if rec.trace is None or not iters:
        return None
    return rec.trace.library_seconds() * 1e3 / iters
