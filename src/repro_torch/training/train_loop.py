"""Train-step factories: the single-program step and the explicit DP step.

Counterpart of ``repro.training.train_loop``.  Two step factories, one
contract — ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``:

* :func:`make_train_step` — loss and gradients by autograd (microbatch
  gradients accumulated in f32), then AdamW in place.  The JAX package
  ``jax.jit``s it with the mesh's shardings; here the step runs eagerly,
  on the mesh's one device;
* :func:`make_dp_train_step` — explicit data parallelism over a
  ``torch.distributed`` process group (``None``: one replica), with
  gradient compression (int8 / top-k with error feedback) on the
  cross-replica mean.  Params are replicated in this path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch._tree import leaves, tree_map
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
    params_shardings,
    place,
)
from repro_torch.launch.mesh import Mesh
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
    cfg: ModelConfig, params: Any, batch: Any
) -> tuple[torch.Tensor, Any]:
    """Loss and its gradient for every leaf of ``params`` (the params are
    not marked: autograd differentiates detached views of them)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(cfg, live, batch)
        # a leaf the loss does not reach gets a zero gradient, as in JAX
        grads = torch.autograd.grad(
            loss, leaves(live), allow_unused=True, materialize_grads=True
        )
    flat = iter(grads)
    return loss.detach(), tree_map(lambda _: next(flat), live)


def loss_and_grads(
    cfg: ModelConfig, params: Any, batch: Any, microbatches: int = 1
) -> tuple[torch.Tensor, Any]:
    """Mean loss + grads; with microbatches, the gradients accumulate in f32
    buffers and are scaled by 1/microbatches at the end."""
    if microbatches == 1:
        return _value_and_grad(cfg, params, batch)
    micro = _split_micro(batch, microbatches)
    loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
    acc = tree_map(_f32_zeros, params)
    for i in range(microbatches):
        lv, g = _value_and_grad(cfg, params, tree_map(lambda x: x[i], micro))
        loss = loss + lv
        tree_map(lambda a, b: a.add_(b), acc, g)
        del g
    inv = 1.0 / microbatches
    return loss * inv, tree_map(lambda a: a.mul_(inv), acc)


# ---------------------------------------------------------------------------
# the single-program step
# ---------------------------------------------------------------------------


def make_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    train: TrainConfig = TrainConfig(),
    rules: MeshRules = FSDP_TP,
) -> tuple[Callable, Callable]:
    """(step, jitted): ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, updating params and state in place, and
    ``jitted(params, opt_state, batch)``, which checks that every leaf lies
    on the mesh's device and returns ``step`` (it runs eagerly: there is no
    compiled form of it here).  ``rules`` is the JAX signature's; on a
    one-device mesh every spec places a leaf whole on that device."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, train.microbatches)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        params, opt_state = adamw_update(train.opt, params, grads, opt_state)
        del grads
        metrics["step"] = opt_state["step"]
        return params, opt_state, metrics

    def jitted(params_tree, opt_tree, batch_tree):
        home = mesh.devices.flat[0]
        trees = {"params": params_tree, "opt_state": opt_tree, "batch": batch_tree}
        for name, tree in trees.items():
            for t in leaves(tree):
                if t.device != home:
                    raise ValueError(
                        f"{name} leaf on {t.device}, the mesh is on {home}"
                    )
        return step

    return step, jitted


def opt_shardings(params_tree, mesh: Mesh, rules: MeshRules = FSDP_TP) -> dict:
    """The optimizer state's shardings: master, m and v as the params,
    the step replicated."""
    sh = params_shardings(params_tree, mesh, rules)
    return {"master": sh, "m": sh, "v": sh, "step": NamedSharding(mesh, ())}


def init_sharded(
    cfg: ModelConfig, mesh: Mesh, seed: int = 0, rules: MeshRules = FSDP_TP
) -> tuple[Any, Any]:
    """Params and optimizer state drawn and placed on ``mesh``."""
    params = init_params(cfg, seed, device=mesh.devices.flat[0])
    params = place(params, params_shardings(params, mesh, rules))
    opt_state = init_opt_state(params)
    return params, place(opt_state, opt_shardings(params, mesh, rules))


# ---------------------------------------------------------------------------
# explicit DP step with gradient compression
# ---------------------------------------------------------------------------


def make_dp_train_step(
    cfg: ModelConfig, train: TrainConfig = TrainConfig(), group=None
) -> Callable:
    """Explicit DP over ``group`` (each rank passes its shard of the batch;
    ``None`` is one replica): grads compressed with error feedback, then
    mean-reduced.

    step(params, opt_state, err_state, batch)
        -> (params, opt_state, err_state, metrics)
    """

    def step(params, opt_state, err, batch):
        loss, grads = loss_and_grads(cfg, params, batch, train.microbatches)
        grads, err = compressed_mean(grads, err, group, train.compression)
        loss = pmean(loss, group)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        params, opt_state = adamw_update(train.opt, params, grads, opt_state)
        metrics["step"] = opt_state["step"]
        return params, opt_state, err, metrics

    return step


def init_dp_error_state(params: Any) -> Any:
    return init_error_state(tree_map(_f32_zeros, params))
