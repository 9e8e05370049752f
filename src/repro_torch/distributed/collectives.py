"""The port's collectives: counted wrappers over ``torch.distributed``, and
the autograd gather that lends a sharded leaf whole to one use.

The JAX package leaves its collectives to GSPMD, which inserts them into
the compiled step.  Here the sharded train step
(``training.train_loop.make_train_step``) issues them itself:

* :func:`gather` — all-gather a leaf's local shard over the groups of the
  mesh axes its spec names, just before the leaf is used; its backward
  reduce-scatters the gradient back to the shard, all-reduces it over the
  data axes the leaf is replicated on, and scales it to the mean over the
  data replicas (a :class:`GatherPlan` says which groups, in which order).
  It is a function of the port's own, not DTensor's ``redistribute``:
  DTensor takes the gradient of a replicated tensor to be the same on
  every rank and only slices it, which is wrong when the ranks computed
  on different batch shards;
* :func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce_`,
  :func:`all_to_all_` — one collective each, counted in the log that
  :func:`count_collectives` opens (kinds and wire bytes as
  ``launch.hlo_analysis`` counts XLA's: ring algorithms, an all-reduce
  moves its tensor twice).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

# wire bytes a device moves per call, per byte of the counted tensor: the
# output of an all-gather, the input of a reduce-scatter, the tensor of an
# all-reduce or all-to-all
_WIRE = {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 2, "all-to-all": 1}
_LOG: contextvars.ContextVar = contextvars.ContextVar("collectives", default=None)

# the names torch 2.13 gives the single-tensor collectives, or the older ones
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_single = (
    getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
)


@contextlib.contextmanager
def count_collectives():
    """Count every collective the port issues inside the block, backward
    passes included: yields ``{kind: [calls, wire bytes]}``, filled as
    they run."""
    log: dict[str, list[int]] = {}
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def _record(log, kind: str, t: torch.Tensor) -> None:
    """Count one call in ``log``, or in the calling context's log."""
    log = _LOG.get() if log is None else log
    if log is not None:
        entry = log.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += t.numel() * t.element_size() * _WIRE[kind]


def all_gather(t: torch.Tensor, dim: int, group, log=None) -> torch.Tensor:
    """``t`` of every rank of ``group`` joined along ``dim`` in rank order
    (the ranks' tensors stacked by the collective, then one copy into
    place where ``dim`` is not the leading one)."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _gather_single(out, src, group=group)
    _record(log, "all-gather", out)
    if dim == 0 or n == 1:
        return out
    return torch.cat(out.view((n,) + tuple(src.shape)).unbind(0), dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group, log=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, cut along ``dim`` into one chunk
    per rank in rank order; this rank's chunk (the chunks laid out one
    after another by one copy where ``dim`` is not the leading one)."""
    n = dist.get_world_size(group)
    shape = tuple(t.shape)
    part = shape[:dim] + (shape[dim] // n,) + shape[dim + 1 :]
    if n == 1 or dim == 0:
        src = t.contiguous()
    else:
        src = t.reshape(shape[:dim] + (n, part[dim]) + shape[dim + 1 :])
        src = src.movedim(dim, 0).reshape((n * part[0],) + part[1:])
    out = src.new_empty(part)
    _scatter_single(out, src, op=dist.ReduceOp.SUM, group=group)
    _record(log, "reduce-scatter", src)
    return out


def all_reduce_(t: torch.Tensor, group, log=None) -> torch.Tensor:
    """``t`` summed over ``group``, in place."""
    dist.all_reduce(t, group=group)
    _record(log, "all-reduce", t)
    return t


def all_to_all_(out: torch.Tensor, t: torch.Tensor, group, log=None) -> None:
    """Chunk ``r`` of ``t`` (dim 0) to rank ``r``; chunk ``r`` of ``out``
    from rank ``r``."""
    dist.all_to_all_single(out, t, group=group)
    _record(log, "all-to-all", t)


# ---------------------------------------------------------------------------
# the gather of one sharded leaf, reduce-scattered in the backward pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class GatherPlan:
    """How one leaf's shard becomes the whole leaf and its gradient the
    shard's (built by ``distributed.sharding.gather_plan``).

    ``gather``: (tensor dim, group) in the order the forward gathers them,
    the minor mesh axis of a dim first; ``reduce``: the groups of the data
    axes the leaf is replicated on; ``scale``: 1 over the number of data
    replicas times the size of every other axis that ``gather`` names (the
    ranks along such an axis computed the same gradient)."""

    gather: tuple[tuple[int, object], ...]
    reduce: tuple[object, ...]
    scale: float


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, plan):
        ctx.plan, ctx.dtype, ctx.log = plan, local.dtype, _LOG.get()
        full = local
        for dim, group in plan.gather:
            full = all_gather(full, dim, group, ctx.log)
        return full if plan.gather else local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        # a new f32 tensor: the collectives below write into it
        if plan.scale == 1:
            g = grad.to(torch.float32, copy=True)
        else:
            g = grad.float() * plan.scale
        for dim, group in reversed(plan.gather):
            g = reduce_scatter(g, dim, group, ctx.log)
        for group in plan.reduce:
            all_reduce_(g, group, ctx.log)
        return g.to(ctx.dtype), None


def gather(local: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """The whole leaf from this rank's shard ``local``; under autograd its
    gradient is reduce-scattered back to the shard and averaged over the
    data replicas, summed in f32."""
    return _Gather.apply(local, plan)
