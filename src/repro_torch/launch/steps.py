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

``Lowerable.partition()`` runs the cell's step once more as rank 0 of the
mesh runs it, on meta shards, in a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once), the port's counterpart of XLA's partitioned module: it
counts the port's collectives and the rank's peak of live bytes beyond
its arguments (``torch.distributed._tools.mem_tracker.MemTracker``).  The
rank runs the cell's step as :func:`sharded_prefill_fn`,
:func:`sharded_decode_fn` and ``training.train_loop.sharded_step_fn``
run it on real tensors over gloo or NCCL: each layer's leaves gathered
over the data axes (FSDP), the heads, ff columns, vocab, experts, lru
channels and SSD heads computed split over "model" (tensor parallelism),
and the decode cache split as ``cache_shardings`` says (batch over the
data axes, KV sequence over "model").  Nothing is issued over an axis of
one rank.  The port partitions by its own rules, not GSPMD's (where the
width does not divide the attention heads, a full-sequence step gives
each rank a run of whole heads read from the gathered ``wq`` and ``wo``,
and the decode step projects on the placed columns), so its counts are
its own, not XLA's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchSpec, input_specs, params_spec
from repro_torch.distributed.collectives import count_collectives
from repro_torch.distributed.sharding import (
    FSDP_TP,
    MeshRules,
    NamedSharding,
    batch_shardings,
    cache_shardings,
    lend_cache,
    lend_params,
    params_shardings,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import ModelConfig, decode_step, prefill
from repro_torch.training.optimizer import adamw_update, init_opt_state
from repro_torch.training.train_loop import (
    TrainConfig,
    loss_and_grads,
    opt_shardings,
    sharded_step_fn,
)


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
class Partitioned:
    """What rank 0 of the mesh does in one run of a step
    (``Lowerable.partition``): ``collectives`` {kind: [calls, wire bytes]}
    under the JAX names, ``temp_bytes`` its peak of live bytes beyond the
    arguments, ``microbatches`` the accumulation its batch shard allows,
    ``flops`` its matrix products (as ``Lowered.flops`` counts them)."""

    collectives: dict[str, list[int]]
    temp_bytes: int
    microbatches: int
    flops: int

    @property
    def collective_bytes(self) -> int:
        return sum(b for _, b in self.collectives.values())


@dataclasses.dataclass(frozen=True)
class Lowerable:
    """A step, its meta arguments, and the cell's shardings of both
    (``out_shardings`` is None where the JAX package leaves the outputs'
    to the compiler); ``sharded(mesh)`` gives the step as one rank of
    ``mesh`` runs it and that rank's meta arguments."""

    step: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    kind: str
    arch_id: str
    cell_name: str
    mesh: Mesh = None
    sharded: Callable = None

    def partition(self) -> Partitioned:
        """Run the step as rank 0 of the mesh runs it (see the module's
        docstring); on one device, the step itself."""
        from torch.distributed._tools.mem_tracker import MemTracker

        with _fake_group(self.mesh) as mesh:
            fn, args, micro = self.sharded(mesh)
            tracker = MemTracker()
            flops = FlopCounterMode(display=False)
            with torch.no_grad(), count_collectives() as log, tracker, flops:
                fn(*args)
            peak = tracker.get_tracker_snapshot("peak")
        temp = sum(per_dev["Total"] for per_dev in peak.values())
        n = int(flops.get_total_flops())
        return Partitioned(dict(sorted(log.items())), int(temp), micro, n)

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


@contextlib.contextmanager
def _fake_group(mesh: Mesh):
    """``mesh`` backed by a DeviceMesh over a fake process group of its
    size, this process rank 0; a one-device mesh as it is."""
    if mesh.size == 1:
        yield mesh
        return
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is up: the dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        dm = init_device_mesh("cpu", mesh.devices.shape, mesh_dim_names=mesh.axis_names)
        yield dataclasses.replace(mesh, device_mesh=dm)
    finally:
        dist.destroy_process_group()


def _meta_shards(tree, shardings):
    """Rank 0's shard of every meta leaf of ``tree``, on the meta device."""
    if isinstance(tree, dict):
        return {k: _meta_shards(v, shardings[k]) for k, v in tree.items()}
    shape = shardings.shard_shape(tree.shape)
    return torch.empty(shape, dtype=tree.dtype, device="meta")


def sharded_prefill_fn(cfg: ModelConfig, shardings: Any) -> Callable:
    """The prefill step on local shards: ``fn(params, batch) -> logits``,
    ``params`` this rank's shards placed by ``shardings`` and ``batch`` its
    batch shard; the (B/data, 1, vocab) logits are whole.  Runs on real
    tensors over gloo or NCCL and on meta shards in the dry run's fake
    group."""

    def fn(params, batch):
        return prefill(
            cfg,
            lend_params(params, shardings, cfg),
            batch["tokens"],
            frames=batch.get("frames"),
            patches=batch.get("patches"),
        )

    return fn


def sharded_decode_fn(cfg: ModelConfig, shardings: Any, cache_sh: Any) -> Callable:
    """The decode step on local shards: ``fn(params, cache, token,
    cache_len, live=None) -> (logits, cache)``, every argument this rank's
    shard (``cache`` placed by ``cache_sh``: its batch over the data axes,
    its KV sequence over "model"; written in place); the logits are whole
    over the vocab."""

    def fn(params, cache, token, cache_len, live=None):
        lent = lend_params(params, shardings, cfg, decode=True)
        split = lend_cache(cache, cache_sh)
        logits, _ = decode_step(cfg, lent, split, token, cache_len, live)
        return logits, cache

    return fn


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
    lowerable = functools.partial(
        Lowerable, arch_id=spec.arch_id, cell_name=cell_name, mesh=mesh
    )

    if cell.kind == "train":
        batch_sds = specs
        b_sh = batch_shardings(batch_sds, mesh)
        o_sds = init_opt_state(p_sds)
        o_sh = opt_shardings(p_sds, mesh, rules)

        def step(params, opt_state, batch):
            loss, grads = loss_and_grads(cfg, params, batch, train.microbatches)
            new_p, new_o = adamw_update(train.opt, params, grads, opt_state)
            return new_p, new_o, loss

        def sharded(m: Mesh):
            if m.device_mesh is None:
                return step, (p_sds, o_sds, batch_sds), train.microbatches
            psh = params_shardings(p_sds, m, rules)
            local_b = _meta_shards(batch_sds, batch_shardings(batch_sds, m))
            rows = local_b["tokens"].shape[0]
            micro = math.gcd(rows, train.microbatches)
            fn = sharded_step_fn(
                cfg, m, dataclasses.replace(train, microbatches=micro), psh
            )
            local_p = _meta_shards(p_sds, psh)
            local_o = _meta_shards(o_sds, opt_shardings(p_sds, m, rules))
            return fn, (local_p, local_o, local_b), micro

        return lowerable(
            step,
            (p_sds, o_sds, batch_sds),
            (p_sh, o_sh, b_sh),
            (p_sh, o_sh, NamedSharding(mesh, ())),
            "train",
            sharded=sharded,
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

        def sharded(m: Mesh):
            if m.device_mesh is None:
                return step, (p_sds, batch_sds), 1
            psh = params_shardings(p_sds, m, rules)
            local_p = _meta_shards(p_sds, psh)
            local_b = _meta_shards(batch_sds, batch_shardings(batch_sds, m))
            return sharded_prefill_fn(cfg, psh), (local_p, local_b), 1

        return lowerable(
            step,
            (p_sds, batch_sds),
            (p_sh, b_sh),
            None,
            "prefill",
            sharded=sharded,
        )

    if cell.kind == "decode":
        cache_sds = specs["cache"]
        c_sh = cache_shardings(cache_sds, mesh)
        tok = {"token": specs["token"], "cache_len": specs["cache_len"]}
        tok_sh = batch_shardings(tok, mesh)

        def step(params, cache, token, cache_len):
            return decode_step(cfg, params, cache, token, cache_len)

        def sharded(m: Mesh):
            args = (p_sds, cache_sds, specs["token"], specs["cache_len"])
            if m.device_mesh is None:
                return step, args, 1
            psh = params_shardings(p_sds, m, rules)
            csh = cache_shardings(cache_sds, m)
            local_t = _meta_shards(tok, batch_shardings(tok, m))
            local = (
                _meta_shards(p_sds, psh),
                _meta_shards(cache_sds, csh),
                local_t["token"],
                local_t["cache_len"],
            )
            return sharded_decode_fn(cfg, psh, csh), local, 1

        return lowerable(
            step,
            (p_sds, cache_sds, specs["token"], specs["cache_len"]),
            (p_sh, c_sh, tok_sh["token"], tok_sh["cache_len"]),
            (None, c_sh),
            "decode",
            sharded=sharded,
        )

    raise ValueError(cell.kind)
