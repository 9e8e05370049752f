"""Step builders for the dry run.

Counterpart of ``repro.launch.steps``.  ``build_lowerable(spec, cell,
mesh)`` returns a :class:`Lowerable` whose ``lower()`` runs exactly the
computation of that (architecture × input-shape) cell:

* ``train_4k``    → full train step (loss and gradients, AdamW update);
* ``prefill_32k`` → chunked-attention forward, last-position logits;
* ``decode_*``    → single-token ``decode_step`` against a seq_len cache.

Every argument is a tensor on the meta device (``configs.params_spec``,
``configs.input_specs``): shapes and dtypes, nothing allocated, so any host
runs a cell at the production meshes' global shapes.  The JAX package hands
the cell's shardings to ``jax.jit``; here the :class:`Lowerable` carries
them as the port's ``NamedSharding``s, built by the same ``*_shardings``
rules, and ``lower()`` reads from them the bytes each device holds.
``jax.jit``'s ``donate_argnums`` has no counterpart: AdamW
(``training.optimizer.adamw_update``) and ``decode_step`` already update
the params, the optimizer state and the cache in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchSpec, input_specs, params_spec
from repro_torch.distributed.sharding import (
    FSDP_TP,
    MeshRules,
    NamedSharding,
    batch_shardings,
    cache_shardings,
    params_shardings,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import decode_step, prefill
from repro_torch.training.optimizer import adamw_update, init_opt_state
from repro_torch.training.train_loop import TrainConfig, loss_and_grads, opt_shardings


@dataclasses.dataclass(frozen=True)
class Lowered:
    """What one run of a step on its meta arguments gives.

    ``flops`` counts the matrix products (``torch.utils.flop_counter``: mm,
    bmm, addmm, einsum's products, convolutions; a product recomputed by
    remat in the backward pass counts again, as XLA keeps the remat dots);
    ``arg_bytes`` and ``out_bytes`` are what one device of the mesh holds
    of the arguments and outputs, each leaf's shard from its spec (an
    output without a sharding counts whole on every device)."""

    outputs: Any
    flops: int
    flops_by_op: dict[str, int]
    arg_bytes: int
    out_bytes: int


@dataclasses.dataclass(frozen=True)
class Lowerable:
    """A step, its meta arguments, and the cell's shardings of both
    (``out_shardings`` is None where the JAX package leaves the outputs'
    to the compiler)."""

    step: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    kind: str
    arch_id: str
    cell_name: str

    def lower(self) -> Lowered:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            outputs = self.step(*self.args)
        by_op = counter.get_flop_counts().get("Global", {})
        return Lowered(
            outputs=outputs,
            flops=int(counter.get_total_flops()),
            flops_by_op={str(op): int(n) for op, n in by_op.items()},
            arg_bytes=device_bytes(self.args, self.in_shardings),
            out_bytes=device_bytes(outputs, self.out_shardings),
        )


def device_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (tuples and dicts of tensors):
    each leaf's shard under the sharding at its place in ``shardings``, a
    tree of the same structure, or the whole leaf where that is None."""
    if isinstance(tree, (tuple, list)):
        shs = shardings if shardings is not None else (None,) * len(tree)
        return sum(device_bytes(t, s) for t, s in zip(tree, shs))
    if isinstance(tree, dict):
        return sum(
            device_bytes(v, None if shardings is None else shardings[k])
            for k, v in tree.items()
        )
    shape = tree.shape if shardings is None else shardings.shard_shape(tree.shape)
    return math.prod(shape) * tree.element_size()


def build_lowerable(
    spec: ArchSpec,
    cell_name: str,
    mesh: Mesh,
    rules: MeshRules = FSDP_TP,
    train: TrainConfig = TrainConfig(),
    reduced: bool = False,
) -> Lowerable:
    cfg = spec.smoke if reduced else spec.model
    cell = spec.cell(cell_name)
    if reduced:
        # shrink the cell to smoke-config scale (CPU runs in the tests)
        specs = input_specs(
            cfg, cell, batch=min(cell.global_batch, 4), seq=min(cell.seq_len, 32)
        )
    else:
        specs = input_specs(cfg, cell)
    p_sds = params_spec(cfg)
    p_sh = params_shardings(p_sds, mesh, rules)

    if cell.kind == "train":
        batch_sds = specs
        b_sh = batch_shardings(batch_sds, mesh)
        o_sds = init_opt_state(p_sds)
        o_sh = opt_shardings(p_sds, mesh, rules)

        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(cfg, params, batch, train.microbatches)
            new_p, new_o = adamw_update(train.opt, params, grads, opt_state)
            return new_p, new_o, loss

        return Lowerable(
            step,
            (p_sds, o_sds, batch_sds),
            (p_sh, o_sh, b_sh),
            (p_sh, o_sh, NamedSharding(mesh, ())),
            "train",
            spec.arch_id,
            cell_name,
        )

    if cell.kind == "prefill":
        batch_sds = specs
        b_sh = batch_shardings(batch_sds, mesh)

        def step(params, batch):
            return prefill(
                cfg,
                params,
                batch["tokens"],
                frames=batch.get("frames"),
                patches=batch.get("patches"),
            )

        return Lowerable(
            step,
            (p_sds, batch_sds),
            (p_sh, b_sh),
            None,
            "prefill",
            spec.arch_id,
            cell_name,
        )

    if cell.kind == "decode":
        cache_sds = specs["cache"]
        c_sh = cache_shardings(cache_sds, mesh)
        tok_sh = batch_shardings(
            {"token": specs["token"], "cache_len": specs["cache_len"]}, mesh
        )

        def step(params, cache, token, cache_len):
            return decode_step(cfg, params, cache, token, cache_len)

        return Lowerable(
            step,
            (p_sds, cache_sds, specs["token"], specs["cache_len"]),
            (p_sh, c_sh, tok_sh["token"], tok_sh["cache_len"]),
            (None, c_sh),
            "decode",
            spec.arch_id,
            cell_name,
        )

    raise ValueError(cell.kind)
