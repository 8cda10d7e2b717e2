"""One rank of the port's multi-process distributed test on the CPU.

    python tests/torch_parallel_runner.py <rank> <world> <port>

Joins a gloo process group on localhost, builds a mesh of 2 row shards a
process, and prints one JSON line: the distributed SpMV's error against the
host product, whether the overlapped (interior, then edges) matvec equals
the unsplit one bit for bit across processes, the Jacobi and ilu0_neumann
solves' status, iterations, true relative residual and the recorder's
record of each; then the same for the "stencil" engine (kernel B1's and
the fused msolve's twins a shard): its matvec and msolve in the split
form (edge rows recomputed while the strips cross processes) against the
scatter form, and its const-factor Neumann solve, plain and with
fuse_blas1.  Imports no JAX; tests/test_torch_parallel_gloo.py spawns it.
"""

import json
import os
import sys


def main() -> int:
    rank, world, port = (int(v) for v in sys.argv[1:4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from cuda_mat_tpu_torch.config import SolverConfig
    from cuda_mat_tpu_torch.models.problems import banded_laplacian
    from cuda_mat_tpu_torch.parallel import (dist_bicgstab, dist_spmv,
                                             init_distributed, make_mesh)
    from cuda_mat_tpu_torch.parallel.collectives import ShardComm
    from cuda_mat_tpu_torch.parallel.dist_solver import (_make_local_matvec,
                                                         fetch_global,
                                                         put_global)
    from cuda_mat_tpu_torch.parallel.partition import RowPartitionedBanded
    from cuda_mat_tpu_torch.utils import timing

    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(2 * world, device="cpu")
    a = banded_laplacian(20)                       # n=400, w=20
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.n)
    y = dist_spmv(a, x, mesh)
    out = {"rank": rank, "shards": mesh.local,
           "spmv_err": float(np.abs(y - a.matvec(x)).max()
                             / np.abs(a.matvec(x)).max())}

    part = RowPartitionedBanded.from_matrix(a, mesh.ndev)
    data = put_global(part.data, mesh, torch.float64, axis=1)
    xs = put_global(part.pad_vector(x), mesh, torch.float64)
    comm = ShardComm(mesh)
    ys = [fetch_global(_make_local_matvec(part.offsets, part.halo,
                                          part.shard_rows, comm,
                                          overlap=ov)(data, xs), mesh)
          for ov in (False, True)]
    out["overlap_bitwise"] = bool(np.array_equal(ys[0], ys[1]))

    b = rng.uniform(1.0, 5.0, a.n)
    for p in ("jacobi", "ilu0_neumann"):
        r = dist_bicgstab(a, b, mesh, SolverConfig(maxit=2000, tol=1e-8,
                                                   precond=p))
        rec = timing.records()[-1]
        out[p] = {"status": r.status.name, "iters": r.iters,
                  "rel": float(np.linalg.norm(b - a.matvec(r.x))
                               / np.linalg.norm(b)),
                  "x_head": [float(v) for v in r.x[:4]],
                  "record": [rec.kind, rec.iters, rec.seconds("solve.loop")
                             == r.dt_alg, sorted(rec.spans)]}
    stencil_cases(out, mesh, comm, rng)
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


STENCIL_CFG = dict(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                   neumann_terms=3)


def stencil_cases(out, mesh, comm, rng):
    import numpy as np
    import torch

    from cuda_mat_tpu_torch.config import SolverConfig
    from cuda_mat_tpu_torch.models.problems import grid_laplacian
    from cuda_mat_tpu_torch.ops import stencil as st
    from cuda_mat_tpu_torch.parallel import make_dist_bicgstab
    from cuda_mat_tpu_torch.parallel import dist_solver as dsol
    from cuda_mat_tpu_torch.precond.preconditioners import neumann_factors

    g = grid_laplacian(64, 126)                    # n=8064, stride 128
    ds = make_dist_bicgstab(g, mesh, SolverConfig(**STENCIL_CFG),
                            local_engine="stencil")
    part, s, blk = ds.part, ds.part.shard_rows, ds.part.block
    x = dsol.put_global(dsol._to_carry(part.pad_vector(
        rng.standard_normal(g.n)), mesh.ndev, s, blk), mesh, torch.float64)
    gap = torch.from_numpy(part.gapmask.astype(np.float64))
    ys = [dsol.fetch_global(dsol._make_local_matvec_stencil(
        part, comm, overlap=ov)(gap, x), mesh) for ov in (False, True)]
    out["stencil_matvec_bitwise"] = bool(np.array_equal(ys[0], ys[1]))
    low, up, diag_m = neumann_factors(g)
    sts = []
    for f in (low, up):
        t, _ = st.const_factor_terms(f.to_dia(max_diags=128), part.c_grid,
                                     part.stride)
        sts.append(st.strided_offsets(st.neumann_poly_terms(
            t, 3, part.c_grid, part.stride), part.c_grid, part.stride))
    ext = torch.from_numpy(st.extend_gapmask(part.gapmask.astype(np.float64),
                                             st.msolve_halo(sts[1])))
    invd_g = np.concatenate([np.ones(blk),
                             part.strided_scatter(1.0 / diag_m, fill=1.0),
                             np.ones(blk)])
    d_pad = dsol.put_global(np.concatenate([
        invd_g[i * s:i * s + s + 2 * blk] for i in range(mesh.ndev)]), mesh,
        torch.float64)
    ms = [dsol.fetch_global(dsol._make_local_msolve_kernel(
        part, comm, sts[0], sts[1], overlap=ov)(ext, d_pad, x), mesh)
        for ov in (False, True)]
    out["stencil_msolve_bitwise"] = bool(np.array_equal(ms[0], ms[1]))
    b = rng.uniform(1.0, 5.0, g.n)
    for tag, extra in (("stencil", {}), ("stencil_fma", {"fuse_blas1": True})):
        r = make_dist_bicgstab(g, mesh, SolverConfig(**STENCIL_CFG, **extra),
                               local_engine="stencil").solve(b)
        out[tag] = {"status": r.status.name, "iters": r.iters,
                    "rel": float(np.linalg.norm(b - g.matvec(r.x))
                                 / np.linalg.norm(b)),
                    "x_head": [float(v) for v in r.x[:4]]}


if __name__ == "__main__":
    sys.exit(main())
