"""One rank of the port's multi-process distributed test on the CPU.

    python tests/torch_parallel_runner.py <rank> <world> <port>

Joins a gloo process group on localhost, builds a mesh of 2 row shards a
process, and prints one JSON line: the distributed SpMV's error against the
host product, whether the overlapped (interior, then edges) matvec equals
the unsplit one bit for bit across processes, and the Jacobi and
ilu0_neumann solves' status, iterations and true relative residual.
Imports no JAX; tests/test_torch_parallel_gloo.py spawns it.
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
        out[p] = {"status": r.status.name, "iters": r.iters,
                  "rel": float(np.linalg.norm(b - a.matvec(r.x))
                               / np.linalg.norm(b)),
                  "x_head": [float(v) for v in r.x[:4]]}
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
