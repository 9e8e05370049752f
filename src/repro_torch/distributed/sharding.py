"""Logical-axis sharding rules → a partition spec for every leaf.

Counterpart of ``repro.distributed.sharding`` (MaxText-style FSDP + TP):

* every parameter leaf gets a tuple of **logical axes** from its path in
  the parameter tree (``logical_axes_of``);
* ``MeshRules`` maps logical axes to mesh axes (``embed`` → "data" for
  FSDP; heads, ff, vocab, … → "model" for TP; the stacked layer axis
  replicated);
* a dim is sharded only if the mesh axis divides it — otherwise it is
  replicated — so one rule set is valid for every config and mesh.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names, or ``None``, entry for entry the JAX ``PartitionSpec`` in its
normal form (``_pspec``).  A
:class:`NamedSharding` places a tensor by its spec.  On a mesh that a
process group backs (``launch.mesh``), that is DTensor's
``distribute_tensor``: each rank keeps the slice that JAX's
``NamedSharding.devices_indices_map`` gives the device at its place in
the mesh.  On one device without a group it is ``.to(device)``.

For use, a sharded leaf is gathered whole (``distributed.collectives``):
:func:`gather_plan` says over which axes' groups, and :func:`lend_params`
gives the model a tree of local shards that it gathers as it reads them,
one layer at a time for the stacked blocks (:class:`ShardedStack`).

Batches shard their dim 0 over ("pod", "data"); decode caches shard the
batch over the data axes and the KV sequence over "model".
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch._tree import map_with_path, tree_map
from repro_torch.distributed.collectives import GatherPlan, gather
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import ModelConfig

# ---------------------------------------------------------------------------
# logical axes per parameter path
# ---------------------------------------------------------------------------

# leaf-name → logical axes (no leading "layers" axis; that is added for
# stacked block params automatically).
_LEAF_RULES: dict[str, tuple[str | None, ...]] = {
    # embeddings / head
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "enc_pos": (None, "embed"),
    "dec_pos": (None, "embed"),
    # attention
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv"),
    "wv": ("embed", "kv"),
    "wo": ("heads", "embed"),
    "bq": ("heads",),
    "bk": ("kv",),
    "bv": ("kv",),
    # dense MLP
    "gate": ("embed", "ff"),
    "up": ("embed", "ff"),
    "down": ("ff", "embed"),
    # norms
    "scale": ("embed",),
    "bias": ("embed",),
    # moe (expert-leading)
    "router": ("embed", "expert"),
    # ssd
    "in_proj": ("embed", "ssm"),
    "out_proj": ("ssm", "embed"),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    # rglru
    "in_x": ("embed", "lru"),
    "in_gate": ("embed", "lru"),
    "wa": ("lru", "lru_out"),
    "wx": ("lru", "lru_out"),
    "ba": ("lru",),
    "bx": ("lru",),
    "lambda": ("lru",),
    "out": ("lru", "embed"),
    # conv1d
    "w": (None, "ssm"),
    "b": ("ssm",),
}

# leaves that live under a "moe" subtree get an "expert" axis prepended
_MOE_3D = {"gate", "up", "down"}

# subtrees whose direct arrays are stacked over layers
_STACKED_PREFIXES = ("blocks", "enc_blocks", "dec_blocks")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """logical axis → mesh axis (None = replicate)."""

    embed: Any = "data"  # FSDP
    heads: Any = "model"
    kv: Any = "model"
    ff: Any = "model"
    vocab: Any = "model"
    expert: Any = "model"
    ssm: Any = "model"
    lru: Any = "model"
    lru_out: Any = None
    layers: Any = None

    def mesh_axis(self, logical: str | None) -> Any:
        if logical is None:
            return None
        return getattr(self, logical, None)


TP_ONLY = MeshRules(embed=None)
FSDP_TP = MeshRules()
REPLICATED = MeshRules(
    embed=None,
    heads=None,
    kv=None,
    ff=None,
    vocab=None,
    expert=None,
    ssm=None,
    lru=None,
)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, major to minor."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh; ``place(t)`` puts ``t`` where the spec says."""

    mesh: Mesh
    spec: tuple

    def _entry(self, i: int):
        return self.spec[i] if i < len(self.spec) else None

    @property
    def placements(self) -> tuple:
        """DTensor's placements, one per mesh axis: ``Shard(dim)`` for the
        tensor dim whose entry names the axis, else ``Replicate()``.  A dim
        that names several axes is split over them major to minor, as in
        JAX; DTensor splits in mesh order, so the names must come in it."""
        order = self.mesh.axis_names
        on: dict[str, int] = {}
        for i, entry in enumerate(self.spec):
            names = spec_axes(entry)
            if list(names) != sorted(names, key=order.index):
                raise ValueError(f"spec entry {entry} is not in mesh order {order}")
            on.update((a, i) for a in names)
        return tuple(Shard(on[a]) if a in on else Replicate() for a in order)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (whole) placed by the spec: a DTensor of this rank's shard
        where a process group backs the mesh, else ``t`` on the mesh's one
        device.  A DTensor already placed so is returned as it is."""
        dm = self.mesh.device_mesh
        if dm is None:
            if self.mesh.size != 1:
                raise NotImplementedError(
                    "a mesh of placeholder devices places nothing: build the "
                    "mesh while a process group is up (launch.mesh)"
                )
            return t.to(self.mesh.devices.flat[0])
        if isinstance(t, DTensor):
            if t.device_mesh is not dm or tuple(t.placements) != self.placements:
                raise ValueError(f"a DTensor placed {t.placements}, not {self.spec}")
            return t
        # every rank holds the whole of ``t``: keep the slice, send nothing
        return distribute_tensor(t, dm, self.placements, src_data_rank=None)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape each device holds of a ``shape`` tensor: every dim
        divided by the product of the mesh axes its spec entry names (as
        ``jax.sharding.NamedSharding.shard_shape``; raises where a dim does
        not divide)."""
        sizes = self.mesh.axis_sizes
        out = []
        for i, dim in enumerate(shape):
            parts = int(np.prod([sizes[a] for a in spec_axes(self._entry(i))]))
            if dim % parts:
                raise ValueError(
                    f"dim {i} of {tuple(shape)} does not split {parts} ways"
                )
            out.append(dim // parts)
        return tuple(out)

    def local_slices(self, shape, coord) -> tuple[slice, ...]:
        """The slice of a ``shape`` tensor that the device at mesh place
        ``coord`` holds (``devices_indices_map``'s entry for it)."""
        sizes = self.mesh.axis_sizes
        at = dict(zip(self.mesh.axis_names, coord))
        out = []
        for i, size in enumerate(self.shard_shape(shape)):
            k = 0
            for a in spec_axes(self._entry(i)):
                k = k * sizes[a] + at[a]
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``t``: a DTensor's local tensor (the same
        storage), or the slice of a whole tensor."""
        if isinstance(t, DTensor):
            with torch.no_grad():
                return t.to_local()
        dm = self.mesh.device_mesh
        if dm is None:
            return t
        return t[self.local_slices(t.shape, dm.get_coordinate())]


def _pspec(*entries) -> tuple:
    """A spec in ``PartitionSpec``'s normal form: an axis list is a tuple,
    a tuple of one name is the name, an empty one is ``None``."""

    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e

    return tuple(norm(e) for e in entries)


def logical_axes_of(path, leaf) -> tuple[str | None, ...]:
    """Logical axes for one parameter leaf, from its path (a tuple of keys)."""
    names = [str(k) for k in path]
    leaf_name = names[-1]
    axes = _LEAF_RULES.get(leaf_name)
    if axes is None:
        axes = (None,) * leaf.ndim
    if "moe" in names and leaf_name in _MOE_3D:
        axes = ("expert",) + axes
    # stacked-block leading layer axis
    if any(names[0].startswith(p) for p in _STACKED_PREFIXES):
        axes = ("layers",) + axes
    # pad/trim to rank (robust to bias-vs-matrix reuse of names)
    if len(axes) < leaf.ndim:
        axes = (None,) * (leaf.ndim - len(axes)) + axes
    elif len(axes) > leaf.ndim:
        axes = axes[-leaf.ndim :]
    return axes


def _divisible(dim: int, mesh: Mesh, axis) -> bool:
    if axis is None:
        return False
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if isinstance(axis, (tuple, list)):
        total = int(np.prod([sizes[a] for a in axis]))
    else:
        total = sizes[axis]
    return dim % total == 0


def param_pspec(path, leaf, mesh: Mesh, rules: MeshRules) -> tuple:
    """The spec of one leaf under ``rules`` on ``mesh``."""
    spec = []
    used: set = set()
    for dim, ax in zip(leaf.shape, logical_axes_of(path, leaf)):
        mesh_ax = rules.mesh_axis(ax)
        # never map two tensor dims to the same mesh axis
        key = tuple(mesh_ax) if isinstance(mesh_ax, list) else mesh_ax
        if mesh_ax is not None and key not in used and _divisible(dim, mesh, mesh_ax):
            spec.append(mesh_ax)
            used.add(key)
        else:
            spec.append(None)
    return _pspec(*spec)


def params_shardings(params_tree, mesh: Mesh, rules: MeshRules = FSDP_TP):
    """A ``NamedSharding`` tree matching ``params_tree`` (tensors, meta
    tensors included)."""
    return map_with_path(
        lambda p, x: NamedSharding(mesh, param_pspec(p, x, mesh, rules)), params_tree
    )


def place(tree, shardings):
    """Each leaf of ``tree`` placed by its sharding."""
    return tree_map(lambda t, sh: sh.place(t), tree, shardings)


def locals_of(tree, shardings):
    """Each leaf's local shard (``NamedSharding.local``)."""
    return tree_map(lambda t, sh: sh.local(t), tree, shardings)


# ---------------------------------------------------------------------------
# lending sharded params to the model
# ---------------------------------------------------------------------------


def gather_plan(sh: NamedSharding, skip: int = 0) -> GatherPlan:
    """How a leaf placed by ``sh`` is gathered whole for use and its
    gradient reduced back (``collectives.GatherPlan``); ``skip`` drops that
    many leading dims of the spec (1 for a layer of a stacked leaf, whose
    layer dim no rule shards)."""
    mesh = sh.mesh
    sizes = mesh.axis_sizes
    entries = [sh._entry(i) for i in range(len(sh.spec))]
    if any(spec_axes(e) for e in entries[:skip]):
        raise ValueError(f"the leading dims of {sh.spec} are sharded")
    steps, named = [], set()
    for i, entry in enumerate(entries[skip:]):
        for a in reversed(spec_axes(entry)):  # the minor axis first
            steps.append((i, mesh.group(a)))
            named.add(a)
    data = batch_axes(mesh)
    replicas = int(np.prod([sizes[a] for a in data]))
    copies = int(np.prod([sizes[a] for a in named if a not in data]))
    return GatherPlan(
        gather=tuple(steps),
        reduce=tuple(mesh.group(a) for a in data if a not in named),
        scale=1.0 / (replicas * copies),
    )


class ShardedStack(dict):
    """A stacked-layer subtree of local shards.  ``models.model`` reads a
    layer through ``gather_layer``, which gathers that layer's leaves
    whole (inside the layer's rematerialised body: the backward gathers
    again instead of keeping them)."""

    def __init__(self, local: dict, shardings: dict):
        super().__init__(local)
        self.plans = tree_map(lambda sh: gather_plan(sh, skip=1), shardings)

    def gather_layer(self, layer: dict) -> dict:
        return tree_map(gather, layer, self.plans)


def lend_params(local, shardings) -> dict:
    """The params tree the model reads, from local shards: each stacked
    subtree a :class:`ShardedStack`, every other leaf gathered whole now
    (once a forward pass)."""
    out = {}
    for k, v in local.items():
        if k.startswith(_STACKED_PREFIXES):
            out[k] = ShardedStack(v, shardings[k])
        else:
            out[k] = tree_map(lambda t, sh: gather(t, gather_plan(sh)), v, shardings[k])
    return out


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------


def choose_mesh_shape(
    cfg: ModelConfig,
    n_chips: int = 256,
    tp_candidates: tuple[int, ...] = (16, 8, 4, 2, 1),
) -> tuple[int, int]:
    """(data, model) factorization of ``n_chips`` for this architecture: the
    widest TP that divides n_heads, n_kv_heads (when grouped), d_ff and
    d_model; everything else goes to the data (FSDP) axis."""
    for tp in tp_candidates:
        if n_chips % tp:
            continue
        dims = [d for d in (cfg.n_heads, cfg.d_ff, cfg.d_model) if d]
        # MQA (kv=1): replicating the single KV head is standard; only
        # grouped KV (>1) must divide the TP width
        if cfg.n_kv_heads > 1:
            dims.append(cfg.n_kv_heads)
        if not dims:  # attention-free (mamba2): d_inner splits instead
            dims = [cfg.ssm_expand * cfg.d_model]
        if all(d % tp == 0 for d in dims):
            return (n_chips // tp, tp)
    return (n_chips, 1)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes carrying data parallelism ("pod" included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_pspec(mesh: Mesh) -> tuple:
    return _pspec(batch_axes(mesh))


def batch_shardings(batch_tree, mesh: Mesh):
    """Shard every batch leaf's dim 0 over the data axes."""
    ax = batch_axes(mesh)

    def spec(x):
        if x.shape and _divisible(x.shape[0], mesh, list(ax)):
            return NamedSharding(mesh, _pspec(ax))
        return NamedSharding(mesh, ())

    return tree_map(spec, batch_tree)


def cache_pspec(path, leaf, mesh: Mesh) -> tuple:
    """Decode-cache spec: batch (dim 1) over the data axes; for KV caches
    (L, B, S, KV, D) the sequence dim over "model"."""
    names = [str(k) for k in path]
    ax = batch_axes(mesh)
    spec: list = [None] * leaf.ndim
    if leaf.ndim >= 2 and _divisible(leaf.shape[1], mesh, list(ax)):
        spec[1] = ax
    kv_names = ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v")
    is_kv = any(n in kv_names for n in names)
    if (
        is_kv
        and leaf.ndim == 5
        and "model" in mesh.axis_names
        and _divisible(leaf.shape[2], mesh, "model")
    ):
        spec[2] = "model"
    return _pspec(*spec)


def cache_shardings(cache_tree, mesh: Mesh):
    return map_with_path(
        lambda p, x: NamedSharding(mesh, cache_pspec(p, x, mesh)), cache_tree
    )
