"""The collectives of the data-sharded fit, with their gradients (what
GSPMD inserts for the JAX package's ``fit(mesh=)``, written out).

Each rank of the mesh's "data" axis holds a share of the training points
(rows).  An objective evaluated there is split into shares that sum to it:
the terms of this rank's rows, and 1/P of every term that each of the P
ranks computes whole (the M-step's KL).  Two autograd Functions complete
the sums and keep the gradient whole on every rank:

* ``reduce_rows``: all-reduce (sum) forward, identity backward.  It turns
  a share into the whole sum; in the backward each rank takes the gradient
  of its own share.
* ``enter_rows``: identity forward, all-reduce (sum) backward.  It marks
  where a value every rank holds whole (a parameter: theta, logA; or a sum
  that ``reduce_rows`` completed inside the objective: lambda0) enters the
  shares; its backward sums the shares' gradients.

Only the pair gives every rank the whole gradient: ``reduce_rows`` alone
gives each rank its share's gradient, and an all-reduce that sums in both
directions (``torch.distributed.nn.functional.all_reduce``) gives P times
it wherever every rank holds the loss whole.

``Rows`` bundles one rank's row range with its group; the fit's functions
take it as ``rows`` (None: one device, unchanged code).  ``calls`` counts
the collectives launched here, by kind.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import check_device, row_range

# collectives launched by this module and parallel/sharded_linalg, by kind,
# since import (or since the caller cleared it)
calls: collections.Counter = collections.Counter()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``t`` over ``group`` (no autograd)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    calls["all_reduce"] += 1
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape on each), by group rank."""
    t = t.detach().contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    calls["all_gather"] += 1
    dist.all_gather(out, t, group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank (in place; contiguous)."""
    calls["broadcast"] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def gather_cat(t: torch.Tensor, group, sizes: Sequence[int],
               dim: int = 0) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's ``t``, rank r's
    holding ``sizes[r]`` entries there: each is padded to the largest for
    the gather and trimmed after it."""
    dim = dim % t.dim()
    pad = max(sizes) - t.shape[dim]
    if pad:
        t = torch.cat([t, t.new_zeros(t.shape[:dim] + (pad,)
                                      + t.shape[dim + 1:])], dim)
    parts = all_gather(t, group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim)


class _ReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        # every gradient in one reduction
        flat = all_reduce(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        parts = flat.split([g.numel() for g in gs])
        return (None, *(p.view_as(g) for p, g in zip(parts, gs)))


def reduce_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's share ``t``: all-reduce forward, identity
    backward (see the module docstring)."""
    return _ReduceRows.apply(t, group)


def enter_rows(t, group):
    """``t`` (a tensor, or a dict of tensors) as it enters the shares:
    identity forward, all-reduce of its gradient backward (one reduction
    for all of a dict's tensors)."""
    if isinstance(t, dict):
        keys = list(t)
        return dict(zip(keys, _EnterRows.apply(group,
                                               *(t[k] for k in keys))))
    return _EnterRows.apply(group, t)[0]


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's share of the training points: rows [lo, hi) of n, split
    over the ``size`` ranks of ``group`` (the mesh's "data" axis), whose
    collectives take tensors on ``device``."""
    group: object
    lo: int
    hi: int
    n: int
    size: int
    device: torch.device

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return reduce_rows(t, self.group)

    def enter(self, t):
        return enter_rows(t, self.group)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The max of ``t`` over its last axis and every rank's rows,
        detached (the distributed logsumexp's shift)."""
        local = (t.detach().amax(-1) if t.shape[-1] else
                 t.new_full(t.shape[:-1], float("-inf")))
        return all_reduce(local, self.group, dist.ReduceOp.MAX)

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a tensor every rank holds whole."""
        return t.narrow(dim, self.lo, self.hi - self.lo)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's rows of ``t`` (this rank's along ``dim``), whole."""
        sizes = [row_range(self.n, self.size, i).stop
                 - row_range(self.n, self.size, i).start
                 for i in range(self.size)]
        return gather_cat(t, self.group, sizes, dim)

    def agree_min(self, v: Optional[int]) -> Optional[int]:
        """The least of every rank's ``v`` (the ranks' chunk sizes, sized
        from each card's free memory, must agree: each chunk holds a
        collective); None stays None."""
        if v is None:
            return None
        t = torch.tensor([v], dtype=torch.int64, device=self.device)
        return int(all_reduce(t, self.group, dist.ReduceOp.MIN))


def data_rows(mesh, n: int, like: torch.Tensor) -> Rows:
    """This rank's ``Rows`` of n training points on the mesh's "data"
    axis; ``like`` must lie on the mesh's device type (ValueError)."""
    check_device(mesh, like)
    size = mesh.size(1)
    sl = row_range(n, size, mesh.get_local_rank("data"))
    return Rows(mesh.get_group("data"), sl.start, sl.stop, n, size,
                like.device)
