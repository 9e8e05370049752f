"""Checkpointing with atomic commit, in the JAX package's on-disk format.

Counterpart of ``repro.training.checkpoint``; each package reads the
other's checkpoints.  Layout of one checkpoint::

    <dir>/step_00000123/
        manifest.json        # step, signature, leaf count, dtypes, extra
        shard_h0000.npz      # every leaf, keyed by its "/"-joined path
    <dir>/step_00000123.tmp/ # staging dir; atomic os.replace on commit

Writers stage into ``.tmp`` and ``os.replace`` it to the final name only
after everything (manifest last) is flushed: a reader never sees a
half-written checkpoint, and ``latest_step`` ignores ``.tmp`` leftovers.

A tree of DTensors (a state sharded over a process group's ranks) is
saved by every rank together: each leaf is gathered whole, rank 0 writes
the same files as for one device, and the other ranks wait at a barrier.
``restore`` places each leaf by the shardings it is given, on a mesh of
any shape: elastic, as in the JAX package.

npz cannot store bf16: a bf16 leaf is stored as its ``uint16`` bits and
the manifest records ``"bfloat16"``.  The tree signature hashes each key
with ``str(shape)`` as NumPy prints a shape tuple and the dtype's NumPy
name, so it is computed here without NumPy knowing bf16.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch._tree import leaves, leaves_with_path, map_with_path

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _dtype_name(dtype: torch.dtype) -> str:
    """NumPy's name for a tensor dtype ("float32", "int32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    """{key: (storable array, true dtype name)} in the JAX leaf order."""
    return {
        _key(p): (_to_numpy(t), _dtype_name(t.dtype))
        for p, t in leaves_with_path(tree)
    }


def _tree_signature(flat: dict[str, tuple[tuple[int, ...], str]]) -> str:
    """Hash of {key: (shape, dtype name)}, keys sorted."""
    h = hashlib.sha256()
    for k in sorted(flat):
        shape, dtype = flat[k]
        h.update(k.encode())
        h.update(str(tuple(int(d) for d in shape)).encode())
        h.update(dtype.encode())
    return h.hexdigest()[:16]


def _sync(dm) -> None:
    """Every rank of the DeviceMesh ``dm`` waits for the others: a barrier
    over each of its axes' groups in turn (after the last, each rank has
    met every other through a chain of them); none over an axis of one.
    The ranks outside ``dm`` take no part."""
    for group in dm.get_all_groups():
        if dist.get_world_size(group) > 1:
            dist.barrier(group)


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Write a checkpoint atomically; returns the committed directory.  A
    tree of DTensors is saved by all the ranks of its mesh together (the
    mesh's first rank writes), and by no other rank: a tenant's sub-mesh
    saves on its own ranks."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    sharded = [t for t in leaves(tree) if isinstance(t, DTensor)]
    dm = sharded[0].device_mesh if sharded else None
    if dm is not None and dist.get_rank() != int(dm.mesh.flatten()[0]):
        for t in sharded:  # the gathers the writer makes
            t.full_tensor()
        _sync(dm)
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    flat = _flatten(tree)
    arrays = {k: a for k, (a, _) in flat.items()}
    np.savez(os.path.join(tmp, "shard_h0000.npz"), **arrays)
    manifest = {
        "step": step,
        "signature": _tree_signature({k: (a.shape, dt) for k, (a, dt) in flat.items()}),
        "n_leaves": len(flat),
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if dm is not None:
        _sync(dm)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Highest committed step (ignores .tmp staging dirs), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if (
            name.startswith("step_")
            and not name.endswith(".tmp")
            and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json"))
        ):
            steps.append(int(name[len("step_") :]))
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any | None = None) -> Any:
    """Load ``step`` into the structure of ``like`` (a tree of tensors, meta
    tensors included).

    Each leaf goes where its sharding in ``shardings`` (a tree of
    ``distributed.sharding.NamedSharding``) places it — on a mesh of any
    shape, whatever mesh saved it — or else to the device of its ``like``
    leaf (the CPU for a meta leaf).
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_flat = {
        _key(p): (t.shape, _dtype_name(t.dtype)) for p, t in leaves_with_path(like)
    }
    sig = _tree_signature(like_flat)
    if sig != manifest["signature"]:
        raise ValueError(
            f"checkpoint structure mismatch: ckpt {manifest['signature']} "
            f"vs target {sig} (did the model config change?)"
        )
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(d, "shard_h0000.npz")) as data:

        def load(path, leaf, sh=None):
            key = _key(path)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
            t = _from_numpy(arr, dtypes.get(key, str(arr.dtype)))
            if sh is not None:
                return sh.place(t)
            return t if leaf.device.type == "meta" else t.to(leaf.device)

        if shardings is None:
            return map_with_path(load, like)
        return map_with_path(load, like, shardings)


def restore_latest(
    ckpt_dir: str, like: Any, shardings: Any | None = None
) -> tuple[int, Any] | None:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return step, restore(ckpt_dir, step, like, shardings)
