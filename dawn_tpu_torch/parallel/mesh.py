"""The ('data', 'seq') process mesh and its collectives.

Port of ``dawn_tpu/parallel/mesh.py``. The JAX package lays its devices out
as a ('data', 'seq') mesh and lets GSPMD place the collectives; here each
process is one rank of the mesh, holds its own rows ('data') and frames
('seq') of a batch, and calls the collectives itself. Rank r sits at
('data', 'seq') = (r // seq, r % seq), the row-major layout of
``make_mesh``'s device grid. A mesh of one process without a process group
needs none: its collectives are the identity.

The helpers take the place of ``batch_sharding`` / ``replicated``: every
rank receives the whole inputs and slices its own part (:meth:`Mesh.rows`,
:meth:`Mesh.frames`); :func:`gather_frames` collects a seq-sharded output
back into the whole video. :func:`all_reduce_sum` is differentiable (its
backward all-reduces the gradient), so a loss whose forward sums over
ranks gets the gradient of the global sum; so are :func:`all_reduce_extreme`
(a MIN or MAX whose gradient goes to the one rank that holds the extreme)
and :func:`all_gather_grad`, under the same rule: each rank backpropagates
its own share of a global loss. :class:`GroupReduce` bundles them for the
data-parallel losses of :mod:`dawn_tpu_torch.models.pbnet.losses`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

AXES = ("data", "seq")


class Mesh:
    """This rank's view of the ('data', 'seq') mesh.

    ``shape`` maps each axis to its size; :meth:`index` is this rank's
    coordinate on an axis, :meth:`ranks` the global ranks of its row along
    it (in axis order) and :meth:`group` that row's process group (None
    without ``torch.distributed``)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Optional[Dict[str, dist.ProcessGroup]] = None):
        self.shape = dict(shape)
        self.rank = rank
        self._groups = groups or {}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["seq"]

    @property
    def distributed(self) -> bool:
        """True when the mesh has process groups (collectives run)."""
        return bool(self._groups)

    def index(self, axis: str) -> int:
        seq = self.shape["seq"]
        return self.rank // seq if axis == "data" else self.rank % seq

    def ranks(self, axis: str) -> List[int]:
        seq = self.shape["seq"]
        if axis == "seq":
            return [self.index("data") * seq + s for s in range(seq)]
        return [d * seq + self.index("seq") for d in range(self.shape["data"])]

    def group(self, axis: Optional[str]) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's row along ``axis`` (None: all
        ranks); None for a mesh without process groups."""
        return self._groups.get(axis or "world")

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` along 'data'."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"a batch of {n} does not divide over the {d} 'data' ranks")
        per = n // d
        return slice(self.index("data") * per, (self.index("data") + 1) * per)

    def frames(self, t_glob: int) -> slice:
        """This rank's frames of a ``t_glob``-frame clip along 'seq'."""
        n_sh = self.shape["seq"]
        assert t_glob % n_sh == 0, (t_glob, n_sh)
        t_loc = t_glob // n_sh
        return slice(self.index("seq") * t_loc, (self.index("seq") + 1) * t_loc)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, seq_parallel: int = 1) -> Mesh:
    """The mesh over all processes: ('data', 'seq') = (n/seq, seq).

    With ``torch.distributed`` initialized, every rank creates every row's
    and column's process group (``dist.new_group`` must see the same calls
    in the same order everywhere) and keeps its own; ``n_devices`` must then
    be the world size. Without it the mesh has one rank and no groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs {n} processes, found {world}")
    assert n % seq_parallel == 0, (n, seq_parallel)
    shape = {"data": n // seq_parallel, "seq": seq_parallel}
    if not dist.is_initialized():
        return Mesh(shape, 0)
    rank = dist.get_rank()
    groups = {"world": dist.group.WORLD}
    for d in range(shape["data"]):
        g = dist.new_group([d * seq_parallel + s for s in range(seq_parallel)])
        if rank // seq_parallel == d:
            groups["seq"] = g
    for s in range(seq_parallel):
        g = dist.new_group([d * seq_parallel + s for d in range(shape["data"])])
        if rank % seq_parallel == s:
            groups["data"] = g
    return Mesh(shape, rank, groups)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (x itself for None).
    Differentiable: each rank backpropagates its own share of a global loss,
    and the backward all-reduces the gradient, so the input's gradient on
    every rank is that of the global loss."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _AllReduceExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        y = x.detach().clone()
        dist.all_reduce(y, op=op, group=group)
        # the lowest rank that holds the extreme takes its gradient
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        owner = torch.where(x.detach() == y, rank, size).to(torch.int64)
        dist.all_reduce(owner, op=dist.ReduceOp.MIN, group=group)
        ctx.group, ctx.mine = group, (owner == rank).to(x.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g * ctx.mine, None, None


def all_reduce_extreme(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                       op: str) -> torch.Tensor:
    """The 'min' or 'max' of the scalar ``x`` over the ranks of ``group`` (x
    itself for None). Differentiable: the backward all-reduces the gradient
    (each rank backpropagates its share of a global loss) and hands it to
    the lowest rank whose ``x`` is the extreme; the others get zero."""
    if group is None:
        return x
    return _AllReduceExtreme.apply(x, group, {"min": dist.ReduceOp.MIN,
                                              "max": dist.ReduceOp.MAX}[op])


class _AllGatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(ctx.size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.rank], None, None


def all_gather_grad(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                    dim: int) -> torch.Tensor:
    """:func:`all_gather_cat` with a gradient: the backward all-reduces the
    whole tensor's gradient (each rank backpropagates its share of a global
    loss) and keeps this rank's part. A term computed alike on every rank
    from the gathered tensor must therefore enter each rank's loss divided
    by the group's size."""
    if group is None:
        return x
    return _AllGatherGrad.apply(x, group, dim)


class GroupReduce:
    """The reductions of a loss term over the ranks of ``group`` (see
    :mod:`dawn_tpu_torch.models.pbnet.losses`): called on a count it gives
    the count over the ranks; ``sum``, ``min``, ``max`` and ``gather``
    (along dim 0, in rank order) are differentiable; ``size`` is the number
    of ranks."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.size = dist.get_world_size(group)

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(count, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x, self.group)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_extreme(x, self.group, "min")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_extreme(x, self.group, "max")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_grad(x, self.group, 0)


def all_gather_cat(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (x itself
    for None); no gradient."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_frames(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """A seq-sharded tensor collected into the whole clip along ``dim``."""
    return all_gather_cat(x, mesh.group("seq"), dim)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A data-sharded tensor collected into the whole batch along dim 0."""
    return all_gather_cat(x, mesh.group("data"), 0)
