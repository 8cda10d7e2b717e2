"""The transport between row shards: what ``shard_map`` gives the JAX
package for free (its ``ppermute``, ``psum`` and ``all_gather`` over the
mesh axis, cuda_mat_tpu/parallel/dist_solver.py:45-98, :465-469, :846-854).

A process keeps a loop vector as one ``(S, shard_rows)`` tensor, S its
shards (:class:`~.mesh.Mesh`), so the body of the JAX ``shard_map`` is one
batched torch expression over the leading axis: the launches an operation
takes do not grow with S.  Between the shards of one process a halo is a
slice of the neighbouring row; between processes only the two edge strips
move, each to its neighbour, by ``torch.distributed.batch_isend_irecv``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cuda_mat_tpu_torch.parallel.mesh import Mesh


class _Pending:
    """Halo strips in flight from the neighbouring processes: ``wait()``
    gives ``(from_left, from_right)``, each ``(1, w)``, zeros at the
    mesh's global edges (the JAX package's non-circular ``ppermute``,
    dist_solver.py:48-50)."""

    def __init__(self, reqs, left, right):
        self._reqs, self._left, self._right = reqs, left, right

    def wait(self):
        for r in self._reqs:
            r.wait()
        return self._left, self._right


class ShardComm:
    """Collectives of one process's run of shards of ``mesh``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.world = mesh.world_size
        self.rank = mesh.rank
        self.local = mesh.local

    # -- ppermute ---------------------------------------------------------

    def start_halos(self, x: torch.Tensor, w: int) -> _Pending:
        """Post the exchange of ``x``'s edge strips with the neighbouring
        processes: this process's first ``w`` rows go left, its last ``w``
        rows go right."""
        if self.world == 1:
            return _Pending((), None, None)
        ops = []
        left = right = None
        if self.rank > 0:
            left = torch.empty((1, w), dtype=x.dtype, device=x.device)
            ops += [dist.P2POp(dist.isend, x[0, :w], self.rank - 1),
                    dist.P2POp(dist.irecv, left, self.rank - 1)]
        else:
            left = x.new_zeros((1, w))
        if self.rank < self.world - 1:
            right = torch.empty((1, w), dtype=x.dtype, device=x.device)
            ops += [dist.P2POp(dist.isend, x[-1, x.shape[1] - w:],
                               self.rank + 1),
                    dist.P2POp(dist.irecv, right, self.rank + 1)]
        else:
            right = x.new_zeros((1, w))
        return _Pending(dist.batch_isend_irecv(ops), left, right)

    def halos(self, x: torch.Tensor, w: int, pending: _Pending = None):
        """``(left, right)``, each ``(S, w)``: the ``w`` x entries before
        and after each shard's rows, zeros past the mesh's ends."""
        s = x.shape[1]
        if self.world == 1:
            return (F.pad(x[:-1, s - w:], (0, 0, 1, 0)),
                    F.pad(x[1:, :w], (0, 0, 0, 1)))
        edge_l, edge_r = (pending or self.start_halos(x, w)).wait()
        return (torch.cat([edge_l, x[:-1, s - w:]]),
                torch.cat([x[1:, :w], edge_r]))

    # -- psum -------------------------------------------------------------

    def psum(self, partials: torch.Tensor) -> torch.Tensor:
        """The sum over every shard of the mesh of the ``(S,)`` per-shard
        ``partials``: one reduction of this process's S in a fixed order,
        then one ``all_reduce`` across processes.  Every process gets the
        same 0-d tensor, so every process takes the same branches."""
        total = partials.sum()
        if self.world > 1:
            dist.all_reduce(total.view(1))
        return total

    # -- all_gather -------------------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole ``(ndev * shard_rows,)`` vector on every process."""
        flat = x.reshape(-1)
        if self.world == 1:
            return flat
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        dist.all_gather(parts, flat)
        return torch.cat(parts)
