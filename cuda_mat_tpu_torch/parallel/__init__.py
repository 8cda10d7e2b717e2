"""The distributed layer (counterpart of :mod:`cuda_mat_tpu.parallel`):
a mesh of row shards, row-partitioned matrices, halo-exchange and
all-gather SpMV, and BiCGSTAB over the mesh.

The reference is single-GPU.  Here the rows of A, x and b are split into
shards; halo segments of x move between neighbouring shards, dots are
reduced over the mesh, and the solver loop is the single-device one closed
over the sharded matvec, msolve and dot.  Shards may share one device (one
process) or sit in several processes joined by ``torch.distributed``.
"""

from cuda_mat_tpu_torch.parallel.mesh import init_distributed, make_mesh
from cuda_mat_tpu_torch.parallel.partition import (RowPartitionedBanded,
                                                   RowPartitionedStencil)
from cuda_mat_tpu_torch.parallel.dist_solver import (dist_bicgstab,
                                                     dist_spmv,
                                                     make_dist_bicgstab)

__all__ = [
    "make_mesh",
    "init_distributed",
    "RowPartitionedBanded",
    "RowPartitionedStencil",
    "dist_bicgstab",
    "dist_spmv",
    "make_dist_bicgstab",
]
