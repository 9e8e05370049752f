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
* the tensor-parallel pair over the "model" axis (:class:`ModelAxis`),
  conjugate under autograd: :func:`copy_to_model` is the identity forward
  and an all-reduce of the gradient backward, where a replicated
  activation enters a product split over "model"; :func:`reduce_from_model`
  all-reduces forward and is the identity backward, after a product whose
  contraction dim is split.  :func:`scatter_from_model` is the
  reduce-scatter form of the second (its backward all-gathers).  Partial
  sums are reduced in f32 and rounded once, to the input's dtype;
* :func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce_`,
  :func:`all_to_all_` — one collective each, counted in the log that
  :func:`count_collectives` opens (kinds and wire bytes as
  ``launch.hlo_analysis`` counts XLA's: ring algorithms, an all-reduce
  moves its tensor twice; the log's ``groups`` counts them by kind and
  the process group they run over).

Nothing is issued over a mesh axis of one rank, as GSPMD issues nothing
there: ``distributed.sharding.gather_plan`` leaves such axes out of a
plan, a plan with nothing to gather or reduce lends the shard itself
(:func:`gather`), and a "model" axis of one is never lent
(``sharding.model_axis``), so the tensor-parallel functions are not
reached at width 1.
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


class CollectiveLog(dict):
    """``{kind: [calls, wire bytes]}``, and in ``groups`` ``{(kind, process
    group): calls}``."""

    def __init__(self):
        super().__init__()
        self.groups: dict = {}

    def by_axis(self, mesh, kinds=None) -> dict[str, int]:
        """The calls (of ``kinds``, or all) by the axis of ``mesh`` whose
        process group they ran over: "world" for the whole group where no
        axis spans it, "?" for another group."""
        names = {mesh.group(a): a for a in mesh.axis_names}
        names.setdefault(dist.group.WORLD, "world")
        out: dict[str, int] = {}
        for (kind, group), calls in self.groups.items():
            if kinds is None or kind in kinds:
                axis = names.get(group, "?")
                out[axis] = out.get(axis, 0) + calls
        return out


@contextlib.contextmanager
def count_collectives():
    """Count every collective the port issues inside the block, backward
    passes included: yields a :class:`CollectiveLog`, filled as they
    run."""
    log = CollectiveLog()
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def _record(log, kind: str, t: torch.Tensor, group) -> None:
    """Count one call over ``group`` in ``log``, or in the calling
    context's log."""
    log = _LOG.get() if log is None else log
    if log is not None:
        entry = log.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += t.numel() * t.element_size() * _WIRE[kind]
        log.groups[kind, group] = log.groups.get((kind, group), 0) + 1


def all_gather(t: torch.Tensor, dim: int, group, log=None) -> torch.Tensor:
    """``t`` of every rank of ``group`` joined along ``dim`` in rank order
    (the ranks' tensors stacked by the collective, then one copy into
    place where ``dim`` is not the leading one)."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _gather_single(out, src, group=group)
    _record(log, "all-gather", out, group)
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
    _record(log, "reduce-scatter", src, group)
    return out


def all_reduce_(
    t: torch.Tensor, group, log=None, op=dist.ReduceOp.SUM
) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) over ``group``, in place."""
    dist.all_reduce(t, op=op, group=group)
    _record(log, "all-reduce", t, group)
    return t


def all_to_all_(out: torch.Tensor, t: torch.Tensor, group, log=None) -> None:
    """Chunk ``r`` of ``t`` (dim 0) to rank ``r``; chunk ``r`` of ``out``
    from rank ``r``."""
    dist.all_to_all_single(out, t, group=group)
    _record(log, "all-to-all", t, group)


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
    data replicas, summed in f32.  A plan with nothing to gather or reduce
    (every axis it would name has one rank) lends ``local`` itself."""
    if not plan.gather and not plan.reduce:
        return local
    return _Gather.apply(local, plan)


# ---------------------------------------------------------------------------
# tensor parallelism over the "model" axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's line along the mesh's "model" axis: its ``size``, the
    rank's place on it (``rank``) and its process ``group``.  A layer
    whose leaves are its slices along "model" reads it from the params
    tree it is lent (``distributed.sharding.lend_params``)."""

    size: int
    rank: int
    group: object


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    """A new f32 tensor of ``t`` (the collectives write into it)."""
    return t.to(torch.float32, copy=True)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis, ctx.log = axis, _LOG.get()
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        g = _f32_copy(grad)
        all_reduce_(g, ctx.axis.group, ctx.log)
        return g.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        g = _f32_copy(t)
        all_reduce_(g, axis.group)
        return g.to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis, ctx.log = dim, axis, _LOG.get()
        return reduce_scatter(t.float(), dim, axis.group).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.dim, ctx.axis.group, ctx.log), None, None


def copy_to_model(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``t``, replicated along "model", as it enters a product split over
    it: the identity; under autograd the ranks' partial gradients of ``t``
    are summed (f32)."""
    return t if axis.size == 1 else _CopyToModel.apply(t, axis)


def reduce_from_model(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum over "model" of the ranks' partial ``t`` (in f32, rounded
    once to ``t``'s dtype); under autograd each rank's gradient is the
    sum's."""
    return t if axis.size == 1 else _ReduceFromModel.apply(t, axis)


def scatter_from_model(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The sum over "model" of the ranks' partial ``t`` (f32), cut along
    ``dim`` into one chunk a rank: this rank's; under autograd the
    gradient of every rank's ``t`` is the chunks' gradients joined."""
    if axis.size == 1:
        return t
    return _ScatterFromModel.apply(t, dim % t.dim(), axis)


def max_over_model(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The elementwise maximum of ``t`` over "model" (no gradient: it
    shifts a softmax, which does not depend on the shift)."""
    t = t.detach()
    if axis.size == 1:
        return t
    return all_reduce_(t.clone(), axis.group, op=dist.ReduceOp.MAX)


def gather_from_model(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The ranks' ``t`` joined along ``dim`` in rank order (no gradient:
    the whole logits and the decode step's heads)."""
    if axis.size == 1:
        return t
    return all_gather(t.detach(), dim % t.dim(), axis.group)
