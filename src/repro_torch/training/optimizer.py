"""AdamW with f32 master weights + cosine LR schedule, in plain PyTorch.

Counterpart of ``repro.training.optimizer``.  bf16 training keeps an f32
master copy of every parameter inside the optimizer state; the model's
bf16 params are re-cast from the masters after each update.  The state is a
tree mirroring the params.

The JAX update is out of place; here the masters, ``m``, ``v`` and the
params are updated in place, leaf by leaf in the JAX package's leaf order,
with the same operations in the same order (a second copy of the state
would not fit beside the model on one card).  The temporaries are one
leaf's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._tree import leaves, leaves_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def cosine_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac·lr`` (f32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
    peak = (1 - cfg.min_lr_frac) * cfg.lr * 0.5
    cos = cfg.min_lr_frac * cfg.lr + peak * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict[str, Any]:
    """master (an f32 copy, never the param itself), m, v, step."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return {
        "master": master,
        "m": tree_map(torch.zeros_like, master),
        "v": tree_map(torch.zeros_like, master),
        "step": torch.zeros((), dtype=torch.int32, device=leaves(master)[0].device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    per_leaf = [x.float().square().sum() for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(per_leaf)))


_NO_DECAY = (
    "scale",
    "bias",
    "ba",
    "bx",
    "bq",
    "bk",
    "bv",
    "lambda",
    "A_log",
    "D",
    "dt_bias",
)


def _decay_mask(path) -> bool:
    """No weight decay on norms/biases/scalars (standard practice)."""
    return str(path[-1]) not in _NO_DECAY


@torch.no_grad()
def adamw_update(
    cfg: OptConfig,
    params: Any,
    grads: Any,
    state: dict[str, Any],
    *,
    grad_norm: torch.Tensor | None = None,
) -> tuple[Any, dict[str, Any]]:
    """One AdamW step, in place.  Returns (params, state) — the same trees,
    updated — so ``params, state = adamw_update(...)`` reads as in the JAX
    package.  ``grads`` is not written.  Every leaf may be a rank's local
    shard (the update is elementwise); ``grad_norm`` is then the norm of
    the whole gradient, which the shards alone cannot give (default:
    ``global_norm(grads)``)."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(path, master, g, m, v, p):
        g = g.float() * clip
        # m2 = b1·m + (1-b1)·g, each product rounded (no fused multiply-add)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        delta = m / b1c
        denom = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
        delta.div_(denom)
        if _decay_mask(path):
            delta.add_(torch.mul(master, cfg.weight_decay, out=denom))
        master.sub_(delta.mul_(lr))
        p.copy_(master)

    for (path, master), g, m, v, p in zip(
        leaves_with_path(state["master"]),
        leaves(grads),
        leaves(state["m"]),
        leaves(state["v"]),
        leaves(params),
    ):
        upd(path, master, g, m, v, p)
    state["step"] = step
    return params, state
