"""Placement across several devices in the port — meshes over a process
group (``launch.mesh``), DTensor placement (``distributed.sharding``),
the sharded train step, the hierarchical DP step, sharded batches and
elastic checkpoints, the launcher under ``torchrun``, and the dry run's
collective and memory fields — against the JAX package's.

The multi-rank parts run over gloo in four child processes per mesh
layout, (data=2, model=2) and (pod=2, data=2, model=1); one module
fixture per layout starts them, and its cases read what they wrote.  The
JAX references run in one child with four host devices
(``--xla_force_host_platform_device_count=4``), beside them.  Every
child is joined with a time limit.

Tolerances, each stated where it is used:

* placement, batches, checkpoints: ``==``, index for index and bit for bit;
* the DP reduction on the same per-rank gradients in both packages: 1e-6
  of the gradients' magnitude (f32; the replicas' sums may run in another
  order, and XLA fuses the residual's rounding);
* the train steps against the reference: losses, gradient norms, bf16
  params and AdamW's first moment 3e-2 per leaf as max |Δ| / max |ref|
  (``TOL`` of tests/test_kernels.py for bf16); AdamW's second moment and
  the f32 masters and params 6e-2, since each carries the gradient's
  bf16 error twice (``_state_tol``); the step count ``==``.  The f32
  state is computed from bf16 gradients, so it carries the bf16 rounding
  of the two packages' forward passes, not f32's.

Whole DP steps are held on the loss, the gradient norm, params and
optimizer state; their error state is a residual of rounding (int8 codes,
top-k picks), which the two packages' bf16 gradients move by a whole code,
so it is held where the gradients are the same: in the reduction test.
The reference's ``init_opt_state`` returns the f32 params themselves as
the masters, and its DP step donates both, so it is given copies.
"""

import dataclasses
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
F32_TOL = 1e-6
JOIN_S = 120  # each child's time limit
ARCH, SSM = "llama3.2-3b", "mamba2-780m"
LAYOUTS = {
    "data2_model2": ((2, 2), ("data", "model")),
    "pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
}
DP_MESH = {  # the DP step's mesh in each layout's run
    "data2_model2": ((4, 1), ("data", "model")),
    "pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
}
STEP_CASES = ("llama", "ssm", "unequal")
KINDS = ("none", "int8", "topk")
BATCH, SEQ, STEPS = 8, 16, 2
RED_SHAPES = {"b": (40,), "w": (8, 33)}  # the DP reduction's gradient tree
RED_STEPS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _join(procs) -> None:
    """Wait for every child within ``JOIN_S``; a hang or a failure fails."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=JOIN_S)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _state_tol(key: str, dtype: str) -> float:
    """The bound of one trained state leaf, from the bf16 bound of the
    gradient it is computed from: 3e-2 where the leaf is bf16 (a param,
    whose update lies below its rounding) or linear in the gradient (m);
    6e-2 where it carries the gradient's error twice: v (its square), and
    the f32 masters and params (AdamW's update is m / sqrt(v))."""
    if dtype == "bfloat16" or key.startswith("opt/m/"):
        return BF16_TOL
    return 2 * BF16_TOL


def _check_state(got: dict, ref: dict, what, skip=()) -> None:
    assert sorted(got) == sorted(ref), what
    for key, (want, dtype) in ref.items():
        if key.startswith(skip):
            continue
        if key.endswith("step"):
            assert np.array_equal(got[key], want), (what, key)
        else:
            assert _rel(got[key], want) < _state_tol(key, dtype), (what, key)


def _step_cfg(case: str) -> str:
    return SSM if case == "ssm" else ARCH


def _unequal_batch(vocab: int) -> dict:
    """A global batch whose first half (rank 0's shard in both layouts) is
    one token repeated, and the rest a random draw."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, vocab, size=(BATCH, SEQ + 1), dtype=np.int32)
    toks[: BATCH // 2] = 3
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


# ---------------------------------------------------------------------------
# the inputs: initial state, written by the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """JAX checkpoints of the llama and mamba2 smoke params and their
    AdamW state (the port restores them), and the unequal batch."""
    import jax

    import repro.configs as JC
    from repro.models import model as JM
    from repro.training import checkpoint as JCk
    from repro.training import optimizer as JO

    d = tmp_path_factory.mktemp("placement")
    for arch in (ARCH, SSM):
        p = JM.init_params(JC.get(arch).smoke, jax.random.key(0))
        JCk.save(str(d / arch), 0, {"params": p, "opt": JO.init_opt_state(p)})
    with open(d / "unequal.pkl", "wb") as f:
        pickle.dump(_unequal_batch(JC.get(ARCH).smoke.vocab), f)
    return d


JAX_PARTS = ("steps", "dp:data2_model2", "dp:pod2_data2")


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """The JAX children (one per part of the references, side by side),
    started once; ``.get()`` waits for their results."""
    env = _env(
        XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, HERE, "--jax", part, str(inputs)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for part in JAX_PARTS
    ]

    class Refs:
        value = None

        def get(self):
            if self.value is None:
                _join(procs)
                self.value = {"dp": {}, "reduce": {}}
                for part in JAX_PARTS:
                    with open(inputs / f"jax_{part.replace(':', '_')}.pkl", "rb") as f:
                        got = pickle.load(f)
                    for k, v in got.items():
                        self.value.setdefault(k, {}).update(v)
            return self.value

    yield Refs()
    for p in procs:
        p.kill()


def _run_layout(name: str, inputs) -> list:
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, HERE, "--port", name, str(r), str(port), str(inputs)],
            env=_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(4)
    ]
    _join(procs)
    out = []
    for r in range(4):
        with open(inputs / f"{name}_rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def data2_model2(inputs, jax_refs):
    return _run_layout("data2_model2", inputs)


@pytest.fixture(scope="module")
def pod2_data2(inputs, jax_refs):
    return _run_layout("pod2_data2", inputs)


@pytest.fixture
def layout(request):
    return request.getfixturevalue(request.param)


def _archs() -> list[str]:
    import repro_torch.configs as PC

    return list(PC.ARCHS)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("arch", _archs())
def test_placement_matches_jax_devices_indices_map(layout, arch, jax_refs, request):
    """Every params, batch and cache leaf of the smoke config: each rank's
    DTensor shard is the slice JAX's ``devices_indices_map`` gives the
    device at the rank's place in the mesh; ``shard_shape`` and
    ``local_slices`` say the same."""
    name = request.node.callspec.params["layout"]
    ref = jax_refs.get()["placement"][name][arch]
    for r, rank in enumerate(layout):
        mine = rank["placement"][arch]
        assert sorted(mine) == sorted(ref), arch
        for key, slices in mine.items():
            assert slices == ref[key][r], (arch, key, r)
    assert any(  # something is split
        ref[k][0] != ref[k][1] for k in ref
    )


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_jax(layout, case, jax_refs, request):
    """Two sharded train steps on four ranks against the reference's step
    jitted without shardings on the global batch: loss, gradient norm,
    params and AdamW state within 3e-2, the step count ``==``.  The
    ``unequal`` batch gives rank 0 a shard unlike the others'."""
    name = request.node.callspec.params["layout"]
    ref = jax_refs.get()["step"][case]
    got = layout[0]["step"][case]
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            assert _rel(got[key][i], ref[key][i]) < BF16_TOL, (name, case, key, i)
    _check_state(got["state"], ref["state"], (name, case))
    for rank in layout[1:]:  # every rank reports the same numbers
        assert rank["step"][case]["loss"] == got["loss"]


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_issues_nothing_over_an_axis_of_one(layout, case, request):
    """The sharded steps' collectives, by the mesh axis whose group they
    run over: every axis of more than one rank is used, and none of one
    rank — nothing over "model" at (pod=2, data=2, model=1), as GSPMD
    issues nothing there."""
    name = request.node.callspec.params["layout"]
    shape, axes = LAYOUTS[name]
    want = {a for a, n in zip(axes, shape) if n > 1}
    for rank in layout:
        seen = set(rank["step"][case]["axes"]) - {"world"}
        assert seen == want, (name, case, seen)


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
def test_each_rank_holds_only_its_shards(layout):
    """Params and AdamW state are DTensors placed by their specs, local
    shapes ``shard_shape``; the state a rank holds is the whole state over
    the number of ranks that share each shard."""
    for rank in layout:
        held = rank["held"]
        assert held["placed"] and held["local_elems"] < held["global_elems"]
        assert held["local_elems"] == held["expected_local_elems"]


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
def test_batch_shards_join_to_the_one_device_batch(layout, request):
    """``make_batch`` on the mesh: the ranks' shards joined in mesh order
    are the one-device batch, bit for bit."""
    import repro_torch.configs as PC
    from repro_torch.training.data import DataConfig, make_batch

    name = request.node.callspec.params["layout"]
    cfg = PC.get(ARCH).smoke
    whole = make_batch(DataConfig(cfg.vocab, BATCH, SEQ), 1, device="cpu")
    shape, axes = LAYOUTS[name]
    for key, t in whole.items():
        joined = np.zeros(t.shape, np.int64) - 1
        for rank in layout:
            rows = rank["batch"]["rows"]
            joined[rows[0] : rows[1]] = rank["batch"][key]
        assert np.array_equal(joined, t.numpy()), key


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_matches_jax(layout, kind, jax_refs, request):
    """Two steps of ``make_dp_train_step(cfg, mesh, train)`` on (data=4)
    and (pod=2, data=2) against the reference's on the same mesh shape:
    loss, gradient norm, params and AdamW state within 3e-2."""
    name = request.node.callspec.params["layout"]
    ref = jax_refs.get()["dp"][name][kind]
    got = layout[0]["dp"][kind]
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            assert _rel(got[key][i], ref[key][i]) < BF16_TOL, (kind, key, i)
    # top-k's picks near the k-th magnitude follow the packages' bf16
    # gradients, so its moments differ wherever one entry was picked in
    # place of another: they are held on equal gradients in the reduction
    # test below
    skip = ("opt/m/", "opt/v/") if kind == "topk" else ()
    _check_state(got["state"], ref["state"], (name, kind), skip)


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("kind", KINDS)
def test_dp_reduction_matches_jax(layout, kind, jax_refs, request):
    """The DP step's reduction (``dp_mean``: data, then pod, with error
    feedback) on the same per-rank gradients as the reference's loop in a
    ``shard_map``, ``RED_STEPS`` steps: every rank's reduced gradient and
    error state within 1e-6 of the gradient's magnitude of the reference
    device's.  Both are sums and differences of numbers of the gradient's
    size (the error is what rounding left of it, and XLA fuses its
    multiply and subtract into one rounding), so they are held in units
    of the gradient, not of themselves."""
    name = request.node.callspec.params["layout"]
    ref = jax_refs.get()["reduce"][name][kind]
    for r, rank in enumerate(layout):
        got = rank["reduce"][kind]
        for s in range(RED_STEPS):
            scale = max(np.abs(g).max() for g in _red_grads(r, s).values())
            for part in ("mean", "err"):
                for leaf in RED_SHAPES:
                    diff = np.abs(got[s][part][leaf] - ref[s][part][leaf][r]).max()
                    assert diff <= F32_TOL * scale, (r, s, part, leaf, diff / scale)


def test_checkpoint_restores_onto_other_meshes(data2_model2, inputs):
    """Saved on (data=2, model=2) after two steps: restored onto (data=4,
    model=1) and onto one device, every leaf equals the saved state bit
    for bit, on every rank; the reference's ``restore`` of the same files
    too."""
    from repro.training import checkpoint as JCk

    saved = data2_model2[0]["ckpt"]["saved"]
    for rank in data2_model2:
        for where in ("mesh4x1", "one_device"):
            got = rank["ckpt"][where]
            assert sorted(got) == sorted(saved)
            for key, bits in saved.items():
                assert np.array_equal(got[key], bits), (where, key)
    like = pickle.loads(data2_model2[0]["ckpt"]["like"])
    jax_state = JCk.restore(str(inputs / "ckpt22"), STEPS, like)
    flat = _jax_bits(jax_state)
    assert sorted(flat) == sorted(saved)
    for key, bits in saved.items():
        assert np.array_equal(flat[key], bits), key


def _jax_bits(tree) -> dict:
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(k.key) for k in path)
        a = np.asarray(leaf)
        out[key] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


def _losses(out: str) -> list[float]:
    return [float(ln.split()[3]) for ln in out.splitlines() if ln.startswith("step ")]


def test_launcher_under_torchrun_matches_one_process():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train ... --device
    cpu``: the sharded step over (data=2, model=1), printed by rank 0
    only, gives the one-process run's losses within 3e-2."""
    flags = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4"]
    flags += ["--seq", "16", "--log-every", "1"]
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *flags],
        capture_output=True, text=True, env=_env(), timeout=JOIN_S,
    )
    assert one.returncode == 0, one.stderr[-3000:]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    run += ["--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags]
    two = subprocess.run(
        run, capture_output=True, text=True, env=_env(), timeout=JOIN_S
    )
    assert two.returncode == 0, two.stderr[-3000:]
    assert "mesh=(2, 1) ('data', 'model')" in two.stdout
    assert two.stdout.count("done") == 1  # rank 0 alone prints
    a, b = _losses(one.stdout), _losses(two.stdout)
    assert len(a) == len(b) == 3
    for x, y in zip(b, a):
        assert abs(x - y) / abs(y) < BF16_TOL, (b, a)


# ---------------------------------------------------------------------------
# the dry run's collective and memory fields
# ---------------------------------------------------------------------------


def _spec_with_layers(n: int):
    import repro_torch.configs as PC

    spec = PC.get(ARCH)
    return dataclasses.replace(spec, smoke=dataclasses.replace(spec.smoke, n_layers=n))


def test_partition_on_one_device_has_no_collectives():
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_lowerable

    mesh = make_host_mesh(device="meta")
    low = build_lowerable(_spec_with_layers(2), "train_4k", mesh, reduced=True)
    part = low.partition()
    assert part.collectives == {} and part.collective_bytes == 0
    assert part.temp_bytes > 0


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_partition_all_gathers_scale_with_layers(cell):
    """On a (data=2, model=2) meta mesh in a fake group: the all-gathers
    grow by the same count with every layer added (the stacked leaves are
    gathered over "data" a layer at a time, twice in a train step: forward
    and remat; a decode step also gathers each layer's new q, k and v over
    "model"), a train step reduce-scatters as many as it gathers in its
    forward, the all-reduces of the tensor-parallel layers (over "model")
    grow by the same count with every layer added too, and the rank's temp
    bytes are positive."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import build_lowerable

    mesh = _mesh((2, 2), ("data", "model"), "meta")
    parts = [
        build_lowerable(_spec_with_layers(n), cell, mesh, reduced=True).partition()
        for n in (2, 4, 6)
    ]
    gathers = [p.collectives["all-gather"][0] for p in parts]
    assert gathers[2] - gathers[1] == gathers[1] - gathers[0] > 0, gathers
    reduces = [p.collectives["all-reduce"][0] for p in parts]
    assert reduces[2] - reduces[1] == reduces[1] - reduces[0] > 0, reduces
    for p in parts:
        assert p.temp_bytes > 0
        assert p.collective_bytes == sum(b for _, b in p.collectives.values())
    if cell == "train_4k":  # gathered in the forward and the remat forward
        rs = [p.collectives["reduce-scatter"][0] for p in parts]
        assert gathers[1] - gathers[0] == 2 * (rs[1] - rs[0]) > 0


def test_dryrun_fills_the_collective_and_memory_fields(tmp_path):
    """A production-mesh record: collectives under XLA's names with their
    total, temp bytes, and the four compiler-only fields ``null``."""
    from repro_torch.launch import dryrun

    out = tmp_path / "r.json"
    argv = ["--arch", "mamba2-780m", "--cell", "decode_32k", "--mesh", "single"]
    assert dryrun.main(argv + ["--out", str(out), "--quiet"]) == 0
    rec = json.loads(out.read_text())["mamba2-780m|decode_32k|16x16"]
    assert dryrun.XLA_ONLY == (
        "bytes_per_device", "flops_xla_raw", "bytes_xla_raw", "transcendentals",
    )
    assert all(rec[k] is None for k in dryrun.XLA_ONLY)
    assert set(rec["collectives"]) <= {"all-gather", "reduce-scatter", "all-reduce"}
    assert rec["collectives"]["all-gather"][0] > 0
    assert rec["collective_bytes"] == sum(b for _, b in rec["collectives"].values())
    assert rec["temp_bytes"] > 0


# ---------------------------------------------------------------------------
# the children
# ---------------------------------------------------------------------------


def _slices(idx, shape) -> list[list[int]]:
    return [
        [s.start or 0, dim if s.stop is None else s.stop] for s, dim in zip(idx, shape)
    ]


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def _jax_placement(jax, mesh, arch) -> dict:
    """{leaf key: [slices of device r] for r in mesh order} of the smoke
    config's params, batch and cache."""
    import jax.numpy as jnp

    import repro.configs as JC
    from repro.distributed import sharding as JS
    from repro.models import model as JM

    cfg = JC.get(arch).smoke
    devs = list(mesh.devices.flat)
    p = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.key(0)))
    batch = _batch_shapes(cfg)
    batch = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in batch.items()}
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, BATCH, SEQ))
    out = {}
    for kind, tree, shs in (
        ("params", p, JS.params_shardings(p, mesh)),
        ("batch", batch, JS.batch_shardings(batch, mesh)),
        ("cache", cache, JS.cache_shardings(cache, mesh)),
    ):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        for (path, leaf), sh in zip(flat, jax.tree.leaves(shs)):
            m = sh.devices_indices_map(leaf.shape)
            out[f"{kind}:{_key(path)}"] = [_slices(m[d], leaf.shape) for d in devs]
    return out


def _batch_shapes(cfg) -> dict:
    shapes = {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ)}
    if cfg.frontend == "audio":
        shapes["frames"] = (BATCH, cfg.enc_seq, cfg.d_model)
    elif cfg.frontend == "vision":
        shapes["patches"] = (BATCH, cfg.n_patches, cfg.d_model)
    return shapes


def _red_grads(r: int, s: int) -> dict:
    rng = np.random.default_rng(1000 * s + r)
    return {k: rng.standard_normal(v).astype(np.float32) for k, v in RED_SHAPES.items()}


def _red_cfg(pkg, kind):
    return pkg.CompressionConfig(kind=kind, block=64, topk_frac=0.05)


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _jax_state_leaves(params, opt) -> dict:
    """{"<tree>/<path>": (leaf as f32, its dtype's name)}."""
    import jax

    out = {}
    for name, tree in (("params", params), ("opt", opt)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[f"{name}/{_key(path)}"] = (_f32(leaf), np.asarray(leaf).dtype.name)
    return out


def jax_child(part: str, d: str) -> None:
    """One part of the references the cases read ("steps": placement and
    the unsharded train steps; "dp:<layout>": the DP steps and the
    reduction on that layout's DP mesh), in a process with four devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P

    import repro.configs as JC
    from repro.distributed import compression as JCmp
    from repro.distributed.sharding import batch_axes
    from repro.models import model as JM
    from repro.training import checkpoint as JCk
    from repro.training import data as JD
    from repro.training import optimizer as JO
    from repro.training import train_loop as JT

    assert jax.device_count() == 4
    devs = np.array(jax.devices())
    copy = lambda t: jax.tree.map(lambda x: jnp.array(x, copy=True), t)  # noqa: E731

    def start(arch):
        p = JM.init_params(JC.get(arch).smoke, jax.random.key(0))
        like = {"params": p, "opt": JO.init_opt_state(p)}
        return copy(JCk.restore(os.path.join(d, arch), 0, like))

    with open(os.path.join(d, "unequal.pkl"), "rb") as f:
        unequal = pickle.load(f)

    def batches(case, vocab):
        if case == "unequal":
            return [{k: jnp.asarray(v) for k, v in unequal.items()}] * STEPS
        dcfg = JD.DataConfig(vocab=vocab, batch=BATCH, seq=SEQ)
        return [JD.make_batch(dcfg, i) for i in range(STEPS)]

    def run(step, st, bs, err=None):
        p, o = st["params"], st["opt"]
        rec = {"loss": [], "grad_norm": []}
        for b in bs:
            if err is None:
                p, o, m = step(p, o, b)
            else:  # the DP step donates its arguments
                p, o, err, m = step(copy(p), copy(o), copy(err), b)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
        rec["state"] = _jax_state_leaves(p, o)
        return rec

    refs: dict = {}
    if part == "steps":
        refs["placement"] = {}
        for name, (shape, axes) in LAYOUTS.items():
            mesh = JMesh(devs.reshape(shape), axes)
            refs["placement"][name] = {
                a: _jax_placement(jax, mesh, a) for a in _archs()
            }
        train = JT.TrainConfig(opt=JO.OptConfig())
        refs["step"], jitted = {}, {}
        for case in STEP_CASES:
            arch = _step_cfg(case)
            cfg = JC.get(arch).smoke
            if arch not in jitted:
                one = JMesh(devs[:1], ("data",))
                jitted[arch] = jax.jit(JT.make_train_step(cfg, one, train)[0])
            bs = batches(case, cfg.vocab)
            refs["step"][case] = run(jitted[arch], start(arch), bs)
    else:
        name = part.split(":")[1]
        shape, axes = DP_MESH[name]
        mesh = JMesh(devs.reshape(shape), axes)
        cfg = JC.get(ARCH).smoke
        refs["dp"] = {name: {}}
        for kind in KINDS:
            tc = JT.TrainConfig(compression=JCmp.CompressionConfig(kind=kind))
            step = JT.make_dp_train_step(cfg, mesh, tc)
            st = start(ARCH)
            err = JT.init_dp_error_state(st["params"])
            refs["dp"][name][kind] = run(step, st, batches("llama", cfg.vocab), err)

        # the reduction alone, on per-rank gradients of a seed
        ax = batch_axes(mesh)
        spec = P(ax)
        refs["reduce"] = {name: {}}
        for kind in KINDS:
            cfg_c = _red_cfg(JCmp, kind)

            def inner(g, e, cfg_c=cfg_c, ax=ax):
                g = jax.tree.map(lambda x: x[0], g)
                e = jax.tree.map(lambda x: x[0], e)
                for a in reversed(ax):
                    g, e = JCmp.compressed_mean(g, e, a, cfg_c)
                return jax.tree.map(lambda x: x[None], (g, e))

            fn = jax.jit(
                jax.shard_map(
                    inner,
                    mesh=mesh,
                    in_specs=(spec, spec),
                    out_specs=(spec, spec),
                    check_vma=False,
                )
            )
            err = {k: jnp.zeros((4,) + v) for k, v in RED_SHAPES.items()}
            steps = []
            for s in range(RED_STEPS):
                g = {
                    k: jnp.stack([_red_grads(r, s)[k] for r in range(4)])
                    for k in RED_SHAPES
                }
                mean, err = fn(g, err)
                steps.append(
                    {
                        "mean": {k: np.asarray(v) for k, v in mean.items()},
                        "err": {k: np.asarray(v) for k, v in err.items()},
                    }
                )
            refs["reduce"][name][kind] = steps
    with open(os.path.join(d, f"jax_{part.replace(':', '_')}.pkl"), "wb") as f:
        pickle.dump(refs, f)


def _port_placement(mesh, arch, coord) -> dict:
    """{leaf key: this rank's slices} from real placements of arange
    tensors, each checked against ``shard_shape`` and ``local_slices``."""
    import repro_torch.configs as PC
    from repro_torch._tree import leaves, leaves_with_path
    from repro_torch.distributed import sharding as TS
    from repro_torch.models import model as TM

    cfg = PC.get(arch).smoke
    p = TM.init_params(cfg, device="meta")
    batch = {k: torch.empty(s, device="meta") for k, s in _batch_shapes(cfg).items()}
    cache = TM.init_cache(cfg, BATCH, SEQ, device="meta")
    out = {}
    for kind, tree, shs in (
        ("params", p, TS.params_shardings(p, mesh)),
        ("batch", batch, TS.batch_shardings(batch, mesh)),
        ("cache", cache, TS.cache_shardings(cache, mesh)),
    ):
        for (path, leaf), sh in zip(leaves_with_path(tree), leaves(shs)):
            shape = tuple(leaf.shape)
            whole = torch.arange(leaf.numel(), dtype=torch.float64).reshape(shape)
            local = sh.place(whole).to_local()
            start = np.unravel_index(int(local.reshape(-1)[0]), shape)
            slices = [[int(a), int(a) + n] for a, n in zip(start, local.shape)]
            idx = tuple(slice(a, b) for a, b in slices)
            assert torch.equal(local, whole[idx]), (arch, path)
            assert tuple(local.shape) == sh.shard_shape(shape)
            assert sh.local_slices(shape, coord) == idx
            out[f"{kind}:{'/'.join(map(str, path))}"] = slices
    return out


def _port_state_leaves(params, opt) -> dict:
    from repro_torch._tree import leaves_with_path

    out = {}
    for name, tree in (("params", params), ("opt", opt)):
        for path, t in leaves_with_path(tree):
            full = t.full_tensor() if hasattr(t, "full_tensor") else t
            out[f"{name}/{'/'.join(map(str, path))}"] = full.float().numpy()
    return out


def _state_bits(tree) -> dict:
    from repro_torch._tree import leaves_with_path

    out = {}
    for path, t in leaves_with_path(tree):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).numpy().view(np.uint16)
        else:
            a = t.numpy()
        out["/".join(map(str, path))] = a
    return out


def port_child(name: str, rank: int, port: str, d: str) -> None:
    """One gloo rank of a layout: every port number the cases read."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import repro_torch.configs as PC
    from repro_torch._tree import leaves, tree_map
    from repro_torch.distributed import compression as TCmp
    from repro_torch.distributed import sharding as TS
    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as TCk
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT
    from repro_torch.training.data import DataConfig, make_batch

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4
    )
    shape, axes = LAYOUTS[name]
    mesh = make_mesh(shape, axes, device="cpu")
    coord = tuple(mesh.device_mesh.get_coordinate())
    out: dict = {"coord": coord}
    out["placement"] = {a: _port_placement(mesh, a, coord) for a in _archs()}

    def like(arch):
        shapes = init_params(PC.get(arch).smoke, device="meta")
        return {"params": shapes, "opt": TO.init_opt_state(shapes)}

    def shardings(arch, m):
        shapes = like(arch)["params"]
        return {
            "params": TS.params_shardings(shapes, m),
            "opt": TT.opt_shardings(shapes, m),
        }

    with open(os.path.join(d, "unequal.pkl"), "rb") as f:
        unequal = pickle.load(f)

    def batches(case, vocab, m):
        if case == "unequal":  # whole: the step keeps this rank's rows
            return [{k: torch.from_numpy(v) for k, v in unequal.items()}] * STEPS
        dcfg = DataConfig(vocab, BATCH, SEQ)
        return [make_batch(dcfg, i, m) for i in range(STEPS)]

    train = TT.TrainConfig(opt=TO.OptConfig())
    out["step"] = {}
    for case in STEP_CASES:
        arch = _step_cfg(case)
        cfg = PC.get(arch).smoke
        st = TCk.restore(os.path.join(d, arch), 0, like(arch), shardings(arch, mesh))
        p, o = st["params"], st["opt"]
        step, jitted = TT.make_train_step(cfg, mesh, train)
        rec = {"loss": [], "grad_norm": []}
        with count_collectives() as log:
            for b in batches(case, cfg.vocab, mesh):
                if case != "unequal":  # a whole batch is not placed
                    assert jitted(p, o, b) is step
                p, o, m = step(p, o, b)
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
        rec["axes"] = sorted(log.by_axis(mesh))
        rec["state"] = _port_state_leaves(p, o)
        out["step"][case] = rec
        if case == "llama":
            sh = shardings(arch, mesh)
            state_leaves = leaves({"params": p, "opt": o})
            placed = all(isinstance(t, DTensor) for t in state_leaves)
            sizes = mesh.axis_sizes
            expected = 0
            for t, s in zip(state_leaves, leaves(sh)):
                names = [a for e in s.spec for a in TS.spec_axes(e)]
                split = int(np.prod([sizes[a] for a in names]))
                expected += t.numel() // split
                assert tuple(t.to_local().shape) == s.shard_shape(t.shape)
            out["held"] = {
                "placed": placed,
                "local_elems": sum(t.to_local().numel() for t in state_leaves),
                "global_elems": sum(t.numel() for t in state_leaves),
                "expected_local_elems": expected,
            }
            if name == "data2_model2":  # the elastic checkpoint
                state = {"params": p, "opt": o}
                TCk.save(os.path.join(d, "ckpt22"), STEPS, state)
                saved = _state_bits(state)
                m41 = make_mesh((4, 1), ("data", "model"), device="cpu")
                r41 = TCk.restore(
                    os.path.join(d, "ckpt22"), STEPS, like(arch), shardings(arch, m41)
                )
                assert all(isinstance(t, DTensor) for t in leaves(r41))
                one = TCk.restore(os.path.join(d, "ckpt22"), STEPS, like(arch))
                assert not any(isinstance(t, DTensor) for t in leaves(one))
                out["ckpt"] = {
                    "saved": saved,
                    "mesh4x1": _state_bits(r41),
                    "one_device": _state_bits(one),
                }
                if rank == 0:
                    import jax

                    from repro.models import model as JM
                    from repro.training import optimizer as JO

                    jp = jax.eval_shape(
                        lambda: JM.init_params(
                            __import__("repro.configs").configs.get(arch).smoke,
                            jax.random.key(0),
                        )
                    )
                    jlike = {"params": jp, "opt": jax.eval_shape(JO.init_opt_state, jp)}
                    out["ckpt"]["like"] = pickle.dumps(jlike)

    cfg = PC.get(ARCH).smoke
    b = make_batch(DataConfig(cfg.vocab, BATCH, SEQ), 1, mesh)
    local = {k: v.to_local().numpy() for k, v in b.items()}
    bsh = TS.batch_shardings(b, mesh)["tokens"]
    sl = bsh.local_slices(b["tokens"].shape, coord)[0]
    out["batch"] = {"rows": (sl.start, sl.stop), **local}

    dshape, daxes = DP_MESH[name]
    dmesh = make_mesh(dshape, daxes, device="cpu")
    out["dp"] = {}
    for kind in KINDS:
        tc = TT.TrainConfig(compression=TCmp.CompressionConfig(kind=kind))
        dp = TT.make_dp_train_step(cfg, dmesh, tc)
        st = TCk.restore(os.path.join(d, ARCH), 0, like(ARCH))  # replicated
        p, o = st["params"], st["opt"]
        err = TT.init_dp_error_state(p)
        rec = {"loss": [], "grad_norm": []}
        for bt in batches("llama", cfg.vocab, dmesh):
            p, o, err, m = dp(p, o, err, bt)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
        rec["state"] = _port_state_leaves(p, o)
        out["dp"][kind] = rec

    out["reduce"] = {}
    r = int(np.ravel_multi_index(tuple(dmesh.device_mesh.get_coordinate()), dshape))
    for kind in KINDS:
        err = {k: torch.zeros(v) for k, v in RED_SHAPES.items()}
        steps = []
        for s in range(RED_STEPS):
            g = {k: torch.from_numpy(v) for k, v in _red_grads(r, s).items()}
            mean, err = TT.dp_mean(g, err, dmesh, _red_cfg(TCmp, kind))
            steps.append(
                {
                    "mean": {k: v.numpy().copy() for k, v in mean.items()},
                    "err": {k: v.numpy().copy() for k, v in err.items()},
                }
            )
        out["reduce"][kind] = steps
    with open(os.path.join(d, f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if sys.argv[1] == "--jax":
        jax_child(sys.argv[2], sys.argv[3])
    else:
        port_child(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
