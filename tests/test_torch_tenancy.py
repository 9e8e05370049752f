"""Mesh-level multi-tenancy in the port — ``TenantMeshManager(mesh,
"model", policy)`` over the port's ``launch.mesh.Mesh``, a tenant's
sub-mesh with its own process groups, two jobs training side by side on
disjoint column slices, the survivor restored onto its wider slice — and
the sharded draw (``training.train_loop.init_params_sharded``), which
never allocates a whole leaf, against the JAX package and the port's own
one-device step.

* Grants: the JAX manager runs on 8 forced host devices in a child (the
  device count is fixed when JAX starts, as in tests/test_tenancy.py),
  the port's on a CPU ``Mesh`` of the same shape whose devices carry
  their flat place as an index; seeded scripts of admit, rebalance,
  release, ``grow_into_free``, ``mark_unhealthy`` and ``mark_healthy``
  under ``equal`` and ``proportional`` on (1, 8) and (2, 4) meshes.  Every
  grant and every sub-mesh's device places: ``==``.
* Training: four gloo children at (1, 4); llama3.2-3b's and mamba2-780m's
  smoke configs on width-2 slices (``equal``), ``STEPS`` steps each,
  interleaved; each tenant's losses within 3e-2 (the JAX package's bf16
  ``TOL``) of the port's one-device step on the same batches from the
  same draw, and every logged collective's group within its tenant's
  ranks.  Then each saves a checkpoint; mamba is released, llama grows to
  width 4, its checkpoint is restored there, and one more step's loss is
  within 3e-2 of the one-device step from that checkpoint.  On a rank
  outside a slice, the sub-mesh's ``local_device`` and ``place`` raise.
* Donation: ``make_train_step(..., donate=False)`` leaves params and
  state as they were and gives the donating step's results bit for bit,
  on one device and on the width-4 sub-mesh.
* The sharded draw: as rank 0..3 of a fake process group
  (``torch.testing._internal.distributed.fake_pg``) in a child, for every
  smoke config at (1, 4), (2, 2) and (4, 1), each shard ``==`` its slice
  of ``init_params`` drawn whole, with the draw block lowered to
  ``DRAW_ELEMS`` elements so that blocks are smaller than leaves; a
  ``TorchDispatchMode`` sees every tensor allocated on a real device
  during the draw, and none may exceed the larger of the rank's largest
  shard and one draw block.

Every child is joined with a time limit.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
BF16_TOL = 3e-2
JOIN_S = 180  # each child's time limit
POLICIES = ("equal", "proportional")
SHAPES = {"1x8": (1, 8), "2x4": (2, 4)}
SCRIPT_SEEDS = range(3)
SCRIPT_OPS = ("admit", "admit", "rebalance", "release", "grow", "fail", "heal")
TENANTS = {"llama": ("llama3.2-3b", 0), "mamba": ("mamba2-780m", 1)}  # arch, seed
STEPS, BATCH, SEQ = 3, 4, 16
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20)
DRAW_LAYOUTS = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
DRAW_ELEMS = 512  # the draw block in the test: smaller than the smoke leaves
DRAW_SEED = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _start(args, env) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, HERE, *args],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def _join(procs) -> None:
    """Wait for every child within ``JOIN_S``; a hang or a failure fails."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=JOIN_S)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# grants: the same scripts through both managers
# ---------------------------------------------------------------------------


def _script(seed: int, cols: int) -> list:
    """A seeded sequence of manager calls, tests/test_tenancy.py's
    canonical one first (equal split, release and grow, a failed column
    inside a tenant, heal)."""
    ops = [
        ["admit", "heavy", 100.0, 1],
        ["admit", "light", 1.0, 1],
        ["rebalance"],
        ["release", "light"],
        ["grow"],
        ["fail", cols // 2 - 1],
        ["rebalance"],
        ["heal", cols // 2 - 1],
        ["rebalance"],
    ]
    rng = np.random.default_rng(seed)
    names = ["heavy"]
    for i in range(30):
        op = str(rng.choice(SCRIPT_OPS))
        if op == "admit" or not names:
            names.append(f"t{i}")
            demand, min_cols = float(rng.integers(1, 50)), int(rng.integers(1, 3))
            ops.append(["admit", names[-1], demand, min_cols])
        elif op == "release":
            ops.append(["release", names.pop(int(rng.integers(len(names))))])
        elif op in ("fail", "heal"):
            ops.append([op, int(rng.integers(cols))])
        else:
            ops.append([op])
    return ops


def _run_script(mgr, ops: list) -> list:
    """Each call's result (grants as strings, evicted tenants) and, after
    it, every placed tenant's sub-mesh: its shape and the flat places of
    its devices in the whole mesh."""
    flat = list(mgr.mesh.devices.flat)
    out = []
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "admit":
            mgr.admit(args[0], demand=args[1], min_cols=args[2])
            got = None
        elif kind == "rebalance":
            got = {k: str(v) for k, v in mgr.rebalance().items()}
        elif kind == "grow":
            got = {k: str(v) for k, v in mgr.grow_into_free().items()}
        elif kind == "release":
            got = mgr.release(args[0])
        elif kind == "fail":
            got = mgr.mark_unhealthy(args[0])
        else:
            got = mgr.mark_healthy(args[0])
        subs = {}
        for t in mgr.tenants():
            if t.partition is not None:
                sub = mgr.submesh(t.name)
                places = [flat.index(d) for d in sub.devices.flat]
                subs[t.name] = (list(sub.devices.shape), places, list(sub.axis_names))
        out.append([op, got, subs, mgr.utilization()])
    return out


def _cases() -> list:
    return [
        (shape, policy, seed)
        for shape in SHAPES
        for policy in POLICIES
        for seed in SCRIPT_SEEDS
    ]


def jax_grants_child(path: str) -> None:
    """The JAX manager on 8 forced host devices: every case's record, and
    the error of a mesh without the column axis."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    from repro.distributed.tenancy import TenantMeshManager

    out = {}
    for shape, policy, seed in _cases():
        mesh = jax.make_mesh(SHAPES[shape], ("data", "model"))
        mgr = TenantMeshManager(mesh, "model", policy=policy)
        out[shape, policy, seed] = _run_script(mgr, _script(seed, SHAPES[shape][1]))
    try:
        TenantMeshManager(jax.make_mesh((1, 8), ("data", "model")), "columns")
    except ValueError as e:
        out["no_axis"] = str(e)
    with open(path, "w") as f:
        json.dump({repr(k): v for k, v in out.items()}, f)


def _cpu_mesh(shape):
    """The port's CPU mesh of ``shape`` whose devices carry their flat
    place as an index (``cpu:i``)."""
    from repro_torch.launch.mesh import Mesh

    grid = np.empty(shape, dtype=object)
    for i in range(grid.size):
        grid.flat[i] = torch.device("cpu", i)
    return Mesh(grid, ("data", "model"))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child started at once: the JAX grants, the four gloo ranks of
    the tenants' run, the sharded draw."""
    d = tmp_path_factory.mktemp("tenancy")
    port = str(_free_port())
    jax_env = _env(JAX_PLATFORMS="cpu")
    procs = {
        "jax": [_start(["--jax-grants", str(d / "jax.json")], jax_env)],
        "tenants": [
            _start(["--tenants", str(r), port, str(d)], _env()) for r in range(4)
        ],
        "draw": [_start(["--draw", str(d)], _env())],
    }
    done: dict = {}

    def wait(key):
        if key not in done:
            _join(procs[key])
            done[key] = True
        return d

    yield wait
    for ps in procs.values():
        for p in ps:
            p.kill()


@pytest.fixture(scope="module")
def jax_grants(children):
    with open(children("jax") / "jax.json") as f:
        return json.load(f)


@pytest.mark.parametrize("shape,policy,seed", _cases())
def test_grants_and_submeshes_match_jax(shape, policy, seed, jax_grants):
    """The same calls give the same grants, evictions and utilization,
    and every placed tenant's sub-mesh the same shape, device places and
    axis names, as the JAX manager's."""
    from repro_torch.distributed.tenancy import TenantMeshManager

    mgr = TenantMeshManager(_cpu_mesh(SHAPES[shape]), "model", policy=policy)
    mine = _run_script(mgr, _script(seed, SHAPES[shape][1]))
    theirs = jax_grants[repr((shape, policy, seed))]
    assert json.loads(json.dumps(mine)) == theirs


def test_manager_signature_checks_and_errors(jax_grants):
    """JAX's signature and checks: ``column_axis`` defaults to "model", a
    mesh without it raises JAX's error, the other axes collapse into the
    rows, and a tenant without a partition has no sub-mesh."""
    from repro_torch.distributed.tenancy import TenantMeshManager

    with pytest.raises(ValueError) as e:
        TenantMeshManager(_cpu_mesh((1, 8)), "columns")
    assert str(e.value) == jax_grants["'no_axis'"]
    mgr = TenantMeshManager(_cpu_mesh((2, 4)))
    assert (mgr.column_axis, mgr.axis_index, mgr.n_cols) == ("model", 1, 4)
    assert mgr._pset.array.rows == 2
    mgr.admit("a", demand=1.0)
    with pytest.raises(ValueError, match="holds no partition"):
        mgr.submesh("a")
    mgr.rebalance()
    sub = mgr.submesh("a")
    assert sub is mgr.submesh("a")  # kept per (tenant, partition)
    assert sub.device_mesh is None and sub.devices.shape == (2, 4)


# ---------------------------------------------------------------------------
# two jobs side by side on sub-meshes of one gloo group
# ---------------------------------------------------------------------------


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _train_setup(name: str, mesh):
    from repro_torch.configs import get
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    arch, _ = TENANTS[name]
    cfg = get(arch).smoke
    train = TrainConfig(opt=OptConfig(**OPT))
    step, jitted = make_train_step(cfg, mesh, train)
    dcfg = DataConfig(vocab=cfg.vocab, batch=BATCH, seq=SEQ, seed=1)
    return cfg, train, step, jitted, dcfg


def _local_copy(tree):
    """This rank's local tensors of a (DTensor) tree, copied."""
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import leaves

    return [
        (t.to_local() if isinstance(t, DTensor) else t).clone() for t in leaves(tree)
    ]


def tenants_child(rank: int, port: str, d: str) -> None:
    """One gloo rank at (1, 4): the tenants' run (module docstring)."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.distributed.sharding import NamedSharding, params_shardings
    from repro_torch.distributed.tenancy import TenantMeshManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import (
        init_sharded,
        make_train_step,
        opt_shardings,
    )

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4
    )
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    mgr = TenantMeshManager(mesh, "model", policy="equal")
    for name, demand in (("llama", 10.0), ("mamba", 5.0)):
        mgr.admit(name, demand=demand)
    out: dict = {"grants": {k: str(v) for k, v in mgr.rebalance().items()}}
    subs = {name: mgr.submesh(name) for name in TENANTS}  # every rank, one order
    out["ranks"] = {n: s.device_mesh.mesh.flatten().tolist() for n, s in subs.items()}
    mine = [n for n, s in subs.items() if s.device_mesh.get_coordinate() is not None]
    out["outside"] = {
        n: [
            _raises(lambda: s.local_device),
            _raises(lambda: NamedSharding(s, ()).place(torch.zeros(2))),
        ]
        for n, s in subs.items()
        if n not in mine
    }
    (name,) = mine
    sub = subs[name]
    cfg, _, step, jitted, dcfg = _train_setup(name, sub)
    params, opt = init_sharded(cfg, sub, seed=TENANTS[name][1])
    losses, groups = [], set()
    for i in range(STEPS):  # the two jobs' steps interleave across the ranks
        batch = make_batch(dcfg, i, sub)
        jitted(params, opt, batch)
        with count_collectives() as log:
            params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        groups |= {tuple(dist.get_process_group_ranks(g)) for _, g in log.groups}
    ckpt.save(os.path.join(d, name), STEPS, {"params": params, "opt": opt})
    out.update(tenant=name, losses=losses, groups=sorted(groups))
    del params, opt

    # mamba drains: released, llama grows over its columns and resumes
    mgr.release("mamba")
    out["grown"] = {k: str(v) for k, v in mgr.grow_into_free().items()}
    wide = mgr.submesh("llama")  # the width-2 sub-mesh's groups are freed
    out["wide_ranks"] = wide.device_mesh.mesh.flatten().tolist()
    dist.barrier()  # llama's checkpoint is written before ranks 2, 3 read it
    cfg, _, step, _, dcfg = _train_setup("llama", wide)
    shapes = init_params(cfg, device="meta")
    like = {"params": shapes, "opt": init_opt_state(shapes)}
    shardings = {
        "params": params_shardings(shapes, wide),
        "opt": opt_shardings(shapes, wide),
    }
    state = ckpt.restore(os.path.join(d, "llama"), STEPS, like, shardings)
    batch = make_batch(dcfg, STEPS, wide)
    before = _local_copy(state)
    keep, _ = make_train_step(cfg, wide, _train_setup("llama", wide)[1], donate=False)
    p_kept, o_kept, m_kept = keep(state["params"], state["opt"], batch)
    out["kept_untouched"] = all(
        torch.equal(a, b) for a, b in zip(before, _local_copy(state))
    )
    with count_collectives() as log:
        p, o, m = step(state["params"], state["opt"], batch)
    out["resumed_loss"] = float(m["loss"])
    out["resumed_groups"] = sorted(
        {tuple(dist.get_process_group_ranks(g)) for _, g in log.groups}
    )
    kept = _local_copy({"p": p_kept, "o": o_kept})
    donated = _local_copy({"p": p, "o": o})
    out["donate_same"] = float(m_kept["loss"]) == float(m["loss"]) and all(
        torch.equal(a, b) for a, b in zip(kept, donated)
    )
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tenant_ranks(children):
    d = children("tenants")
    return [_load(d / f"rank{r}.pkl") for r in range(4)], d


def _one_device(name: str, params, opt, steps):
    """The port's plain one-device step from ``params``/``opt`` on the
    whole batches ``steps``: the losses."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.training.data import make_batch

    _, _, step, _, dcfg = _train_setup(name, _mesh((1, 1), ("data", "model"), "cpu"))
    losses = []
    for i in steps:
        params, opt, m = step(params, opt, make_batch(dcfg, i, device="cpu"))
        losses.append(float(m["loss"]))
    return losses


def test_two_tenants_train_on_their_slices(tenant_ranks):
    """Width-2 slices, ranks (0, 1) and (2, 3); each tenant's losses within
    3e-2 of the one-device step from the same draw on the same batches;
    every collective its step issued ran over a group of its own ranks."""
    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import init_opt_state

    ranks, _ = tenant_ranks
    for r, rec in enumerate(ranks):
        assert rec["grants"] == {"llama": "1x2@0", "mamba": "1x2@2"}
        assert rec["ranks"] == {"llama": [0, 1], "mamba": [2, 3]}
        assert rec["tenant"] == ("llama" if r < 2 else "mamba")
        own = set(rec["ranks"][rec["tenant"]])
        assert rec["groups"], "no collective logged"
        assert all(set(g) <= own for g in rec["groups"]), rec["groups"]
    for name, (arch, seed) in TENANTS.items():
        params = init_params(get(arch).smoke, seed, device="cpu")
        ref = _one_device(name, params, init_opt_state(params), range(STEPS))
        for rec in ranks:
            if rec["tenant"] == name:
                err = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref))
                assert err < BF16_TOL, (name, rec["losses"], ref)


def test_ranks_outside_a_slice_refuse_it(tenant_ranks):
    """On each rank the other tenant's sub-mesh raises for ``local_device``
    and for ``place``: it never falls back to the whole mesh."""
    ranks, _ = tenant_ranks
    for rec in ranks:
        other = "mamba" if rec["tenant"] == "llama" else "llama"
        assert rec["outside"] == {other: [True, True]}


def test_survivor_restored_onto_its_wider_slice(tenant_ranks):
    """After mamba's release, ``grow_into_free`` gives llama all four
    columns; its checkpoint restored there steps on within 3e-2 of the
    one-device step from the same checkpoint, over groups of the four."""
    from repro_torch.configs import get
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import init_opt_state

    ranks, d = tenant_ranks
    shapes = init_params(get(TENANTS["llama"][0]).smoke, device="meta")
    like = {"params": shapes, "opt": init_opt_state(shapes)}
    state = ckpt.restore(str(d / "llama"), STEPS, like)
    (ref,) = _one_device("llama", state["params"], state["opt"], [STEPS])
    for rec in ranks:
        assert rec["grown"] == {"llama": "1x4@0"}
        assert rec["wide_ranks"] == [0, 1, 2, 3]
        err = abs(rec["resumed_loss"] - ref) / abs(ref)
        assert err < BF16_TOL, (rec["resumed_loss"], ref)
        groups = rec["resumed_groups"]
        assert groups and all(set(g) <= {0, 1, 2, 3} for g in groups)


def test_donate_false_leaves_the_inputs(tenant_ranks):
    """``donate=False``: params and state as they were, and the results of
    the donating step bit for bit — on one device, and on the width-4
    sub-mesh of the gloo run."""
    from repro_torch._tree import leaves
    from repro_torch.configs import get
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models.model import init_params
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import make_train_step

    for rec in tenant_ranks[0]:
        assert rec["kept_untouched"] and rec["donate_same"]
    mesh = _mesh((1, 1), ("data", "model"), "cpu")
    cfg, train, step, _, dcfg = _train_setup("llama", mesh)
    keep, _ = make_train_step(cfg, mesh, train, donate=False)
    params = init_params(get(TENANTS["llama"][0]).smoke, 0, device="cpu")
    opt = init_opt_state(params)
    batch = make_batch(dcfg, 0, device="cpu")
    before = [t.clone() for t in leaves({"p": params, "o": opt})]
    p2, o2, m2 = keep(params, opt, batch)
    after = leaves({"p": params, "o": opt})
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    p1, o1, m1 = step(params, opt, batch)
    assert p1 is params  # the donating step updates in place
    assert float(m1["loss"]) == float(m2["loss"])
    donated, kept = leaves({"p": p1, "o": o1}), leaves({"p": p2, "o": o2})
    assert all(torch.equal(a, b) for a, b in zip(donated, kept))


# ---------------------------------------------------------------------------
# the sharded draw
# ---------------------------------------------------------------------------


def draw_child(d: str) -> None:
    """As each rank of a fake process group of four, every smoke config
    drawn by shard at each layout: bit-equality with the whole draw's
    slices, and the largest tensor allocated on a real device."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    import repro_torch.models.layers as L
    from repro_torch._tree import leaves
    from repro_torch.configs import ARCHS, get
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training.train_loop import init_params_sharded

    class Allocations(TorchDispatchMode):
        """The bytes of every storage an op creates on a real device."""

        def __init__(self):
            super().__init__()
            self.largest = (0, "")

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            held = {
                t.untyped_storage().data_ptr()
                for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.device.type != "meta"
            }
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    if t.untyped_storage().data_ptr() not in held:
                        size = t.untyped_storage().nbytes()
                        self.largest = max(self.largest, (size, str(func)))
            return out

    torch.set_num_threads(1)
    L._DRAW_ELEMS = DRAW_ELEMS
    whole = {a: init_params(get(a).smoke, DRAW_SEED, device="cpu") for a in ARCHS}
    out: dict = {}
    for layout, shape in DRAW_LAYOUTS.items():
        for rank in range(4):
            dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            for arch in ARCHS:
                cfg = get(arch).smoke
                with Allocations() as seen:
                    got = init_params_sharded(cfg, mesh, seed=DRAW_SEED)
                shardings = leaves(params_shardings(whole[arch], mesh))
                same = all(
                    torch.equal(g.to_local(), s.local(w))
                    for g, w, s in zip(leaves(got), leaves(whole[arch]), shardings)
                )
                shard = max(
                    int(np.prod(s.shard_shape(w.shape))) * w.element_size()
                    for w, s in zip(leaves(whole[arch]), shardings)
                )
                widest = max(w.shape[-1] for w in leaves(whole[arch]))
                block = 4 * max(DRAW_ELEMS, widest)  # f32 rows, at least one
                out[layout, rank, arch] = {
                    "bit_equal": same,
                    "largest": seen.largest,
                    "bound": max(shard, block),
                    "largest_leaf": max(
                        w.numel() * w.element_size() for w in leaves(whole[arch])
                    ),
                }
            dist.destroy_process_group()
    with open(os.path.join(d, "draw.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def draws(children):
    return _load(children("draw") / "draw.pkl")


@pytest.mark.parametrize("layout", list(DRAW_LAYOUTS))
def test_sharded_draw_is_the_whole_draw(layout, draws):
    """Every rank's shard of every leaf of every smoke config equals, bit
    for bit, its slice of ``init_params`` drawn whole."""
    from repro_torch.configs import ARCHS

    for rank in range(4):
        for arch in ARCHS:
            assert draws[layout, rank, arch]["bit_equal"], (layout, rank, arch)


@pytest.mark.parametrize("layout", list(DRAW_LAYOUTS))
def test_sharded_draw_never_holds_a_whole_leaf(layout, draws):
    """No tensor allocated during the draw exceeds the larger of the
    rank's largest shard and one draw block (``DRAW_ELEMS`` f32 elements,
    or one f32 row where a row is longer); where a leaf is split, that is
    below the leaf."""
    from repro_torch.configs import ARCHS

    below_a_leaf = 0
    for rank in range(4):
        for arch in ARCHS:
            rec = draws[layout, rank, arch]
            assert rec["largest"][0] <= rec["bound"], (layout, rank, arch, rec)
            below_a_leaf += rec["bound"] < rec["largest_leaf"]
    assert below_a_leaf > 0  # the bound bites: some leaf is larger than it


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if sys.argv[1] == "--jax-grants":
        jax_grants_child(sys.argv[2])
    elif sys.argv[1] == "--tenants":
        tenants_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        draw_child(sys.argv[2])
