"""Train-step factories: the sharded step and the explicit DP step.

Counterpart of ``repro.training.train_loop``.  Two step factories, one
contract — ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``:

* :func:`make_train_step` — loss and gradients by autograd (microbatch
  gradients accumulated in f32), then AdamW in place.  The JAX package
  ``jax.jit``s it with the mesh's shardings and GSPMD partitions it; here
  the step runs eagerly and partitions itself.  On a mesh that a process
  group backs, params and optimizer state are DTensors placed by their
  specs, each rank holding its shards: the model gathers a layer's
  leaves over the data axes just before it runs that layer (FSDP), each
  rank computes on its shard of the batch, and each gradient is
  reduce-scattered back to its leaf's shard, averaged over the data axes
  (``distributed.collectives.gather``).  Along "model" the ranks divide
  the work (tensor parallelism, ``distributed.sharding.lend_params``):
  each keeps its slices of the heads, ff columns, vocab, experts and lru
  channels and computes its share of every layer (its run of attention
  and SSD heads) on the same batch shard; only the leaves whose even cut
  does not fall on the rank's share are gathered over "model" and read in
  parts (the router, the SSD block's packed ``in_proj`` and conv,
  attention's weights where the width does not divide the heads).
  Nothing is issued over an axis of one rank, so on a group of one the
  step is the one-device step's arithmetic, bit for bit.  On one device
  without a group the step is the plain one;
* :func:`make_dp_train_step` — explicit data parallelism over the data
  axes of the mesh, with gradient compression (int8 / top-k with error
  feedback) on the cross-replica mean, level by level: over "data", then
  over "pod", each level with its own compression.  Params are
  replicated in this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch._tree import leaves, tree_map
from repro_torch.distributed.collectives import all_reduce_
from repro_torch.distributed.compression import (
    CompressionConfig,
    compressed_mean,
    init_error_state,
    pmean,
)
from repro_torch.distributed.sharding import (
    FSDP_TP,
    MeshRules,
    NamedSharding,
    batch_axes,
    batch_shardings,
    lend_params,
    locals_of,
    params_shardings,
    place,
    spec_axes,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import on_each_leaf
from repro_torch.models.model import ModelConfig, init_params, loss_fn
from repro_torch.training.optimizer import (
    OptConfig,
    adamw_update,
    global_norm,
    init_opt_state,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1  # grad-accumulation factor
    compression: CompressionConfig = CompressionConfig()


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _split_micro(batch: Any, n: int) -> Any:
    """(B, ...) -> (n, B/n, ...) for microbatch accumulation."""

    def r(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by microbatches {n}")
        return x.reshape((n, B // n) + tuple(x.shape[1:]))

    return tree_map(r, batch)


def _value_and_grad(
    cfg: ModelConfig, params: Any, batch: Any, lend: Callable | None = None
) -> tuple[torch.Tensor, Any]:
    """Loss and its gradient for every leaf of ``params`` (the params are
    not marked: autograd differentiates detached views of them).  ``lend``
    turns the marked leaves into the tree the model reads (the gathers of
    a sharded step)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(cfg, live if lend is None else lend(live), batch)
        # a leaf the loss does not reach gets a zero gradient, as in JAX
        grads = torch.autograd.grad(
            loss, leaves(live), allow_unused=True, materialize_grads=True
        )
    flat = iter(grads)
    return loss.detach(), tree_map(lambda _: next(flat), live)


def loss_and_grads(
    cfg: ModelConfig,
    params: Any,
    batch: Any,
    microbatches: int = 1,
    *,
    lend: Callable | None = None,
) -> tuple[torch.Tensor, Any]:
    """Mean loss + grads; with microbatches, the gradients accumulate in f32
    buffers and are scaled by 1/microbatches at the end.  ``lend``: as in
    ``_value_and_grad``, once a microbatch."""
    if microbatches == 1:
        return _value_and_grad(cfg, params, batch, lend)
    micro = _split_micro(batch, microbatches)
    loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
    acc = tree_map(_f32_zeros, params)
    for i in range(microbatches):
        lv, g = _value_and_grad(cfg, params, tree_map(lambda x: x[i], micro), lend)
        loss = loss + lv
        tree_map(lambda a, b: a.add_(b), acc, g)
        del g
    inv = 1.0 / microbatches
    return loss * inv, tree_map(lambda a: a.mul_(inv), acc)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def _data_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of a per-rank scalar over the mesh's data axes, one axis
    after the other (the JAX package's DP step: "pod", then "data"); an
    axis of one rank issues nothing."""
    sizes = mesh.axis_sizes
    for ax in batch_axes(mesh):
        if sizes[ax] > 1:
            x = pmean(x, mesh.group(ax))
    return x


def sharded_norm(grads: Any, shardings: Any, mesh: Mesh) -> torch.Tensor:
    """The global norm of a gradient held as local shards: each rank's
    squares of a leaf over the number of ranks that hold the same shard,
    summed over every rank of the mesh (and no other: a tenant's sub-mesh
    sums over its own ranks), so that each element counts once.  The ranks
    that hold one shard hold the same gradient of it: reduced over the
    data axes, and along "model" either this rank's slice's alone or,
    for a leaf whole along "model", equal on every rank (the activations'
    gradients are all-reduced where they leave a split product,
    ``collectives.copy_to_model``)."""
    sizes = mesh.axis_sizes

    def part(g, sh):
        split = math.prod(sizes[a] for e in sh.spec for a in spec_axes(e))
        return g.float().square().sum() / (mesh.size // split)

    per_leaf = leaves(tree_map(part, grads, shardings))
    total = torch.sum(torch.stack(per_leaf))
    for ax in mesh.axis_names:  # summed over every rank of the mesh, axis by axis
        if sizes[ax] > 1:
            total = all_reduce_(total, mesh.group(ax))
    return torch.sqrt(total)


def sharded_step_fn(
    cfg: ModelConfig, mesh: Mesh, train: TrainConfig, shardings: Any
) -> Callable:
    """The sharded step on local shards: ``fn(params, opt_state, batch) ->
    (loss, grad_norm)``, every argument this rank's local tensors (the
    batch its shard), params and state updated in place.  The dry run
    (``launch.steps``) runs it on meta shards."""

    def fn(params, opt_state, batch):
        lend = lambda live: lend_params(live, shardings, cfg)  # noqa: E731
        loss, grads = loss_and_grads(cfg, params, batch, train.microbatches, lend=lend)
        loss = _data_mean(loss, mesh)
        gnorm = sharded_norm(grads, shardings, mesh)
        adamw_update(train.opt, params, grads, opt_state, grad_norm=gnorm)
        return loss, gnorm

    return fn


def _like(ref, t: torch.Tensor):
    """``t`` as ``ref`` is held: a DTensor placed as ``ref``, or plain."""
    if isinstance(ref, DTensor):
        return DTensor.from_local(t, ref.device_mesh, ref.placements, run_check=False)
    return t


def make_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    train: TrainConfig = TrainConfig(),
    rules: MeshRules = FSDP_TP,
    donate: bool = True,
) -> tuple[Callable, Callable]:
    """(step, jitted): ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` and ``jitted(params, opt_state, batch)``, which
    checks that every leaf is placed by its sharding on ``mesh`` and
    returns ``step`` (it runs eagerly: there is no compiled form of it
    here).  ``donate`` (JAX's ``donate_argnums`` of params and state):
    the step updates the caller's params and state in place and returns
    them; with ``False`` it leaves them untouched and returns new trees.

    On a mesh that a process group backs, params and state are DTensors
    placed by ``params_shardings`` / ``opt_shardings`` (``init_sharded``,
    ``checkpoint.restore``) and the batch by ``batch_shardings``
    (``data.make_batch``; a whole batch is sliced).  On one device every
    leaf lies whole on it."""

    def step(params, opt_state, batch):
        if not donate:
            params, opt_state = (tree_map(torch.clone, t) for t in (params, opt_state))
        if mesh.device_mesh is None:
            loss, grads = loss_and_grads(cfg, params, batch, train.microbatches)
            metrics = {"loss": loss, "grad_norm": global_norm(grads)}
            params, opt_state = adamw_update(train.opt, params, grads, opt_state)
            del grads
            metrics["step"] = opt_state["step"]
            return params, opt_state, metrics
        p_sh = params_shardings(params, mesh, rules)
        local_o = locals_of(opt_state, opt_shardings(params, mesh, rules))
        fn = sharded_step_fn(cfg, mesh, train, p_sh)
        local_b = locals_of(batch, batch_shardings(batch, mesh))
        loss, gnorm = fn(locals_of(params, p_sh), local_o, local_b)
        opt_state["step"] = _like(opt_state["step"], local_o["step"])
        metrics = {"loss": loss, "grad_norm": gnorm, "step": local_o["step"]}
        return params, opt_state, metrics

    def jitted(params_tree, opt_tree, batch_tree):
        trees = {
            "params": (params_tree, params_shardings(params_tree, mesh, rules)),
            "opt_state": (opt_tree, opt_shardings(params_tree, mesh, rules)),
            "batch": (batch_tree, batch_shardings(batch_tree, mesh)),
        }
        for name, (tree, shardings) in trees.items():
            for t, sh in zip(leaves(tree), leaves(shardings)):
                _check_placed(name, t, sh)
        return step

    return step, jitted


def _check_placed(name: str, t, sh: NamedSharding) -> None:
    dm = sh.mesh.device_mesh
    if dm is None:
        home = sh.mesh.devices.flat[0]
        if t.device != home:
            raise ValueError(f"{name} leaf on {t.device}, the mesh is on {home}")
        return
    placed = isinstance(t, DTensor) and t.device_mesh == dm
    if not placed or tuple(t.placements) != sh.placements:
        got = tuple(t.placements) if isinstance(t, DTensor) else "a plain tensor"
        raise ValueError(
            f"{name} leaf placed {got}, its spec {sh.spec} asks {sh.placements}"
        )


def opt_shardings(params_tree, mesh: Mesh, rules: MeshRules = FSDP_TP) -> dict:
    """The optimizer state's shardings: master, m and v as the params,
    the step replicated."""
    sh = params_shardings(params_tree, mesh, rules)
    return {"master": sh, "m": sh, "v": sh, "step": NamedSharding(mesh, ())}


class _ByShard:
    """The hook (``models.layers.on_each_leaf``) of the sharded draw: the
    leaves, in the order drawn, each placed by its sharding; an
    initialiser that draws by shard (``draw``) allocates only this rank's
    shard of its leaf."""

    def __init__(self, shardings: list):
        self._todo = iter(shardings)

    def __call__(self, t: torch.Tensor):
        return next(self._todo).place(t)

    def draw(self, shape, dtype, fill):
        return next(self._todo).draw(shape, dtype, fill)


def init_params_sharded(
    cfg: ModelConfig, mesh: Mesh, seed: int = 0, rules: MeshRules = FSDP_TP
) -> Any:
    """``init_params(cfg, seed)`` placed on ``mesh``, no leaf ever held
    whole: each initialiser is handed its leaf's sharding before it
    allocates and allocates this rank's shard alone, drawing the whole
    leaf's row blocks in the generator's order (the same numbers on every
    rank) and keeping the part of each that falls in the shard.  A rank's
    peak is its shards plus one draw block (``layers._DRAW_ELEMS`` f32
    elements, 256 MiB) and rglru's ``lambda``, which is drawn whole in f32
    ((layers, lru width): 266 KB at recurrentgemma-2b) and then placed.
    The shards are those of the whole tree placed at once, bit for bit."""
    drawn: list = []
    with on_each_leaf(lambda t: drawn.append(t) or t):
        shapes = init_params(cfg, device="meta")
    order = {id(t): i for i, t in enumerate(drawn)}
    shardings = [None] * len(drawn)
    for t, sh in zip(leaves(shapes), leaves(params_shardings(shapes, mesh, rules))):
        shardings[order[id(t)]] = sh
    with on_each_leaf(_ByShard(shardings)):
        return init_params(cfg, seed, device=mesh.local_device)


def init_sharded(
    cfg: ModelConfig, mesh: Mesh, seed: int = 0, rules: MeshRules = FSDP_TP
) -> tuple[Any, Any]:
    """Params and optimizer state drawn and placed on ``mesh``: the params
    leaf by leaf (``init_params_sharded``), the state from the placed
    shards."""
    params = init_params_sharded(cfg, mesh, seed, rules)
    opt_state = init_opt_state(params)
    return params, place(opt_state, opt_shardings(params, mesh, rules))


# ---------------------------------------------------------------------------
# explicit DP step with gradient compression (hierarchical reduce)
# ---------------------------------------------------------------------------


def _replicated(name: str, t):
    """The local tensor of a replicated leaf (a plain tensor is one)."""
    if not isinstance(t, DTensor):
        return t
    if t.to_local().shape != t.shape:
        raise ValueError(f"the DP step replicates its {name}; a leaf is sharded")
    with torch.no_grad():
        return t.to_local()


def dp_mean(
    grads: Any, err: Any, mesh: Mesh, compression: CompressionConfig
) -> tuple[Any, Any]:
    """This rank's gradients compressed and mean-reduced over the mesh's
    data axes, one level at a time — intra-pod ("data") first, then
    cross-pod ("pod") — the error state carried through both levels."""
    for ax in reversed(batch_axes(mesh)):
        grads, err = compressed_mean(grads, err, mesh.group(ax), compression)
    return grads, err


def make_dp_train_step(
    cfg: ModelConfig, mesh: Mesh, train: TrainConfig = TrainConfig()
) -> Callable:
    """Explicit-DP step: params replicated, batch sharded over the data
    axes, grads compressed (error feedback) then mean-reduced per axis
    level — over "data" (within a pod), then over "pod" — each level with
    the compression and the error state (the JAX package's loop).  On a
    mesh no process group backs, every level is one replica.

    step(params, opt_state, err_state, batch)
        -> (params, opt_state, err_state, metrics)

    The batch is placed by ``batch_shardings`` or whole (each rank keeps
    its shard); params, state and errors are this rank's, plain tensors
    or replicated DTensors, updated in place.
    """

    def step(params, opt_state, err, batch):
        local_p = tree_map(lambda t: _replicated("params", t), params)
        local_o = tree_map(lambda t: _replicated("optimizer state", t), opt_state)
        local_e = tree_map(lambda t: _replicated("error state", t), err)
        local_b = locals_of(batch, batch_shardings(batch, mesh))
        loss, grads = loss_and_grads(cfg, local_p, local_b, train.microbatches)
        grads, local_e = dp_mean(grads, local_e, mesh, train.compression)
        metrics = {"loss": _data_mean(loss, mesh), "grad_norm": global_norm(grads)}
        adamw_update(train.opt, local_p, grads, local_o)
        opt_state["step"] = _like(opt_state["step"], local_o["step"])
        metrics["step"] = local_o["step"]
        err = tree_map(_like, err, local_e)
        return params, opt_state, err, metrics

    return step


def init_dp_error_state(params: Any) -> Any:
    return init_error_state(tree_map(_f32_zeros, params))
