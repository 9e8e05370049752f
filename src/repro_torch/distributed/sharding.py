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
process group backs (``launch.mesh``), that is a ``DTensor`` of this
rank's local slice: each rank keeps the slice that JAX's
``NamedSharding.devices_indices_map`` gives the device at its place in
the mesh.  On one device without a group it is ``.to(device)``.

For use, a sharded leaf is gathered over the data axes
(``distributed.collectives``, FSDP) and, over "model", only where the
layer that reads it cannot compute on its slice (:func:`model_use`): the
attention heads, the ff columns, the vocab, the experts, the lru channels
and the SSD heads are computed split over "model", each rank on its share
(tensor parallelism; ``models.layers``, ``models.moe``, ``models.rglru``,
``models.ssm``, ``models.model``), and a leaf whose even cut does not
fall on the rank's share is gathered and read in parts.  As GSPMD, the
port issues nothing over an axis of one rank: :func:`gather_plan` leaves
such axes out, and at a "model" width of one nothing is lent split.
:func:`gather_plan` says over which axes' groups a leaf is gathered and
how its gradient is reduced, and :func:`lend_params` gives the model a
tree of local shards that it gathers as it reads them, one layer at a
time for the stacked blocks (:class:`ShardedStack`).  A layer dict whose
leaves are computed on their split is a :class:`SplitParams`, which
carries the "model" axis (its width and this rank's place on it); the
layer reads it there, never the mesh.

Batches shard their dim 0 over ("pod", "data"); decode caches shard the
batch over the data axes and the KV sequence over "model".
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch._tree import leaves, map_with_path, tree_map
from repro_torch.distributed.collectives import GatherPlan, ModelAxis, gather
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
            # equal meshes are one mesh: DTensor's sharding propagation may
            # hand back an equal DeviceMesh (the same ranks and names)
            if t.device_mesh != dm or tuple(t.placements) != self.placements:
                raise ValueError(f"a DTensor placed {t.placements}, not {self.spec}")
            return t
        # every rank holds the whole of ``t``: keep the slice, send nothing.
        # A copy of this rank's slice alone (``distribute_tensor`` copies
        # every rank's chunk first), so that the whole of ``t`` is freed
        # with ``t`` and a rank's peak is its shards plus one whole leaf
        local = t[self.local_slices(t.shape, self.mesh.coordinate())]
        if local.numel() < t.numel():
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(
            local,
            dm,
            self.placements,
            run_check=False,
            shape=t.shape,
            stride=t.stride(),
        )

    def draw(self, shape, dtype, fill) -> torch.Tensor:
        """A ``shape`` leaf placed by the spec, of which only this rank's
        shard is allocated: ``fill(out, box)`` writes the part ``box`` (a
        slice a dim) of the leaf into ``out``, on this rank's device.  On
        one device without a group the box is the whole leaf."""
        dm = self.mesh.device_mesh
        if dm is None:
            if self.mesh.size != 1:
                raise NotImplementedError(
                    "a mesh of placeholder devices places nothing"
                )
            out = torch.empty(shape, dtype=dtype, device=self.mesh.devices.flat[0])
            fill(out, tuple(slice(0, n) for n in shape))
            return out
        box = self.local_slices(shape, self.mesh.coordinate())
        out = torch.empty(
            [s.stop - s.start for s in box], dtype=dtype, device=self.mesh.local_device
        )
        fill(out, box)
        return DTensor.from_local(
            out,
            dm,
            self.placements,
            run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride(),
        )

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
        return t[self.local_slices(t.shape, self.mesh.coordinate())]


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


def _on_model(sh: NamedSharding, dim: int) -> bool:
    """Whether tensor dim ``dim`` of a leaf placed by ``sh`` is split over
    "model"."""
    return "model" in spec_axes(sh.spec[dim])


# the layer dicts that can compute on leaves split over "model", and the
# dim of each leaf that must be split for them to (negative: from the end)
_SPLIT_DIMS = {
    "attn": {"wq": -1, "wo": -2},
    "cross": {"wq": -1, "wo": -2},
    "mlp": {"gate": -1, "up": -1, "down": -2},
    "moe": {"gate": -3, "up": -3, "down": -3},  # the expert dim
    "rglru": {
        "in_x": -1, "in_gate": -1, "wa": -2, "wx": -2, "ba": -1, "bx": -1,
        "lambda": -1, "out": -2,
    },
}
_KV = ("wk", "wv", "bk", "bv")
_LAYER_KEYS = (*_SPLIT_DIMS, "ssd")


def _layer_splits(key: str, shs: dict) -> bool:
    """Whether the layer dict ``key`` computes its share of the work along
    "model": every leaf of ``_SPLIT_DIMS`` split on its dim (the rglru's
    conv too).  Mamba2's SSD block always does: each rank takes its run of
    the SSD heads (``models.ssm``), reading the leaves whose even cut
    straddles what they pack in parts (:func:`model_use`)."""
    if key == "ssd":
        return True
    dims = _SPLIT_DIMS.get(key)
    if dims is None:
        return False
    if not all(_on_model(shs[n], d) for n, d in dims.items() if n in shs):
        return False
    if key == "rglru":
        return all(_on_model(sh, -1) for sh in shs["conv"].values())
    return True


def model_use(
    name: str,
    sh: NamedSharding,
    cfg: ModelConfig,
    tp: int,
    layer: str | None,
    decode: bool = False,
) -> str:
    """How the layer reads leaf ``name`` (in layer dict ``layer``, None
    outside one) along "model", ``tp`` wide, in the decode step
    (``decode``) or the full-sequence paths:

    * ``"split"`` — it computes on this rank's slice: no gather over
      "model", and the slice's gradient is this rank's alone;
    * ``"part"`` — it gathers the leaf whole (where split) and reads the
      part its rank's share of the work needs: the ranks' gradients are
      partial sums, summed over "model".  So are read the router (its
      gates reach only the rank's experts' outputs); the SSD block but
      ``out_proj`` (the even cut of the packed ``in_proj`` and the conv
      straddles z, x, B, C and dt; each rank reads its heads' z, x and dt
      and the shared B and C, ``models.ssm``); attention's weights where
      the width does not divide the heads (each rank its run of whole
      heads, ``models.layers.head_run``) and its kv projection where the
      kv heads do not divide (the kv heads of the rank's query heads).
      In decode, attention computes on the placed columns wherever the
      heads do not divide, fractions of a head included
      (``models.layers.project_on_columns``);
    * ``"whole"`` — every rank of "model" computes the same on the whole
      leaf: gathered over "model" where split, and the gradients, equal on
      every rank, are summed and divided by the width.
    """
    if layer is None:  # the vocab tables
        dim = {"embed": 0, "lm_head": -1}.get(name)
        return "split" if dim is not None and _on_model(sh, dim) else "whole"
    if layer in ("attn", "cross"):
        heads = cfg.n_heads % tp == 0
        if name not in _KV:
            return "split" if heads or decode else "part"
        kv = cfg.n_kv_heads % tp == 0
        on = _on_model(sh, -1) and (kv if heads else decode)
        return "split" if on else "part"
    if layer == "ssd":  # out_proj's even cut of rows is whole heads
        rows = name == "out_proj" and _on_model(sh, -2)
        return "split" if rows and cfg.ssm_cfg.n_heads % tp == 0 else "part"
    if name == "router":
        return "part"
    return "split"


def gather_plan(sh: NamedSharding, skip: int = 0, use: str = "whole") -> GatherPlan:
    """How a leaf placed by ``sh`` is gathered for use and its gradient
    reduced back (``collectives.GatherPlan``): over every axis of more
    than one rank that its spec names but "model" where the layer computes
    on the split (``use``, see :func:`model_use`); ``skip`` drops that many
    leading dims of the spec (1 for a layer of a stacked leaf, whose layer
    dim no rule shards).  An axis of one rank is named nowhere in the plan
    and counts in no scale."""
    mesh = sh.mesh
    sizes = mesh.axis_sizes
    entries = [sh._entry(i) for i in range(len(sh.spec))]
    if any(spec_axes(e) for e in entries[:skip]):
        raise ValueError(f"the leading dims of {sh.spec} are sharded")
    steps, named = [], set()
    for i, entry in enumerate(entries[skip:]):
        for a in reversed(spec_axes(entry)):  # the minor axis first
            if sizes[a] == 1 or (a == "model" and use == "split"):
                continue
            steps.append((i, mesh.group(a)))
            named.add(a)
    data = [a for a in batch_axes(mesh) if sizes[a] > 1]
    reduce = [mesh.group(a) for a in data if a not in named]
    part = use == "part" and sizes.get("model", 1) > 1
    if part and "model" not in named:
        reduce.append(mesh.group("model"))  # replicated, read in parts
    replicas = int(np.prod([sizes[a] for a in data]))
    same = [a for a in named if a not in data and not (a == "model" and part)]
    copies = int(np.prod([sizes[a] for a in same]))
    return GatherPlan(
        gather=tuple(steps), reduce=tuple(reduce), scale=1.0 / (replicas * copies)
    )


class SplitParams(dict):
    """A layer's params of which some leaves are this rank's slices along
    "model": ``tp`` is that axis (``collectives.ModelAxis``), from which
    the layer computes its share of the work.  The top of a lent tree is
    one where the vocab tables are split."""

    def __init__(self, tree: dict, tp: ModelAxis):
        super().__init__(tree)
        self.tp = tp


def model_axis(mesh: Mesh) -> ModelAxis | None:
    """This rank's line along "model" where a process group backs the
    mesh and that axis has more than one rank, else None (nothing is lent
    split, and no layer issues a tensor-parallel collective)."""
    if mesh.device_mesh is None or mesh.axis_sizes.get("model", 1) == 1:
        return None
    rank = mesh.device_mesh.get_local_rank("model")
    return ModelAxis(mesh.axis_sizes["model"], rank, mesh.group("model"))


def _plans(shardings: dict, cfg: ModelConfig, skip: int, path=(), decode=False):
    """(the ``GatherPlan`` tree of a params subtree, the paths of its layer
    dicts that compute on their split)."""
    mesh = leaves(shardings)[0].mesh
    tp = mesh.axis_sizes.get("model", 1)
    split: set = set()

    def walk(shs, path, layer, on):
        if not isinstance(shs, dict):
            if layer and not on:
                return gather_plan(shs, skip, "whole")
            use = model_use(path[-1], shs, cfg, tp, layer, decode)
            return gather_plan(shs, skip, use)
        if path and path[-1] in _LAYER_KEYS:
            layer, on = path[-1], _layer_splits(path[-1], shs)
            if on:
                split.add(path)
        return {k: walk(v, path + (k,), layer, on) for k, v in shs.items()}

    return walk(shardings, path, None, False), frozenset(split)


def _lent(tree, plans, split, tp, path=()):
    """``tree`` of local shards gathered by ``plans``; the dicts at
    ``split`` a :class:`SplitParams` of ``tp`` (where it is not None)."""
    if not isinstance(tree, dict):
        return gather(tree, plans)
    out = {k: _lent(v, plans[k], split, tp, path + (k,)) for k, v in tree.items()}
    return SplitParams(out, tp) if tp is not None and path in split else out


class ShardedStack(dict):
    """A stacked-layer subtree of local shards.  ``models.model`` reads a
    layer through ``gather_layer``, which gathers that layer's leaves for
    use (inside the layer's rematerialised body: the backward gathers
    again instead of keeping them), its split layers' dicts
    :class:`SplitParams`; ``decode``: as :func:`lend_params`."""

    def __init__(self, local: dict, shardings: dict, cfg: ModelConfig, decode=False):
        super().__init__(local)
        self.plans, self.split = _plans(shardings, cfg, skip=1, decode=decode)
        self.tp = model_axis(leaves(shardings)[0].mesh)

    def gather_layer(self, layer: dict) -> dict:
        return _lent(layer, self.plans, self.split, self.tp)


def lend_params(local, shardings, cfg: ModelConfig, decode: bool = False) -> dict:
    """The params tree the model reads, from local shards: each stacked
    subtree a :class:`ShardedStack`, every other leaf gathered for use now
    (once a forward pass); the whole tree a :class:`SplitParams` where the
    vocab tables are split over "model".  ``decode``: lent to
    ``models.model.decode_step``, whose attention projects on the placed
    columns (:func:`model_use`)."""
    out = {}
    tp = model_axis(leaves(shardings)[0].mesh)
    for k, v in local.items():
        if k.startswith(_STACKED_PREFIXES):
            out[k] = ShardedStack(v, shardings[k], cfg, decode)
            continue
        plans, split = _plans(shardings[k], cfg, skip=0, path=(k,), decode=decode)
        out[k] = _lent(v, plans, split, tp, (k,))
    vocab = all(
        model_use(k, shardings[k], cfg, 1, None) == "split"
        for k in ("embed", "lm_head")
    )
    return SplitParams(out, tp) if vocab and tp is not None else out


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


class SplitCache(dict):
    """A decode cache of local shards: ``seq`` maps each KV cache whose
    sequence dim is split over "model" to that axis
    (``collectives.ModelAxis``), which ``models.model.decode_step`` reads."""

    def __init__(self, local: dict, seq: dict):
        super().__init__(local)
        self.seq = seq


def lend_cache(local: dict, shardings: dict) -> SplitCache:
    """The cache tree ``decode_step`` reads from this rank's shards."""
    tp = model_axis(leaves(shardings)[0].mesh)
    seq = {
        k: tp
        for k, sh in shardings.items()
        if tp is not None and not isinstance(sh, dict) and _on_model(sh, 2)
    }
    return SplitCache(local, seq)
