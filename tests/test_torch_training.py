"""The port's training path — optimizer, sharding specs, data, checkpoints,
gradient compression, the train step and ``python -m
repro_torch.launch.train`` — against the JAX package's.

Inputs come from a NumPy seed; the JAX parameters and optimizer state go
across through NumPy (``params_from_jax``), so both packages start from
the same numbers.

Tolerances, each stated where it is used:

* f32 optimizer arithmetic: 1e-6 relative (max |Δ| / max |ref| per leaf),
  since ``pow`` and ``cos`` may differ by an ulp between the libraries;
* gradients and losses of the bf16 model: 3e-2, the JAX package's own bf16
  tolerance (tests/test_kernels.py ``TOL``), per leaf as max |Δ| / max |ref|;
* specs, tokens, checkpoints, int8 codes: ``==``, bit for bit.

AdamW's first steps move each weight by about ``lr · sign(g)``, so a bf16
rounding difference in a near-zero gradient flips a whole step: the
optimizer is held on the JAX package's own gradients, the gradients on
their own, and a trajectory of steps on the loss only.  No test here asks
for more than the reference's own tests reach (its loss-decrease check and
its multi-device compression check fail in the reference itself).
"""

import functools
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

import repro.configs as JC
from repro.distributed import compression as JCmp
from repro.distributed import sharding as JS
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import model as JM
from repro.training import checkpoint as JCk
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training import train_loop as JT
import repro_torch.configs as PC
from repro_torch._tree import leaves, leaves_with_path, tree_map
from repro_torch.distributed import compression as TCmp
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint as TCk
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 3e-2
F32_TOL = 1e-6
ARCHS = JC.list_archs()
ARCH = "llama3.2-3b"
CFG, JCFG = PC.get(ARCH).smoke, JC.get(ARCH).smoke
JMESH = jax_host_mesh()
MESH = make_host_mesh(device="cpu")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(mine, ref) -> float:
    a, b = _np(mine), _np(ref)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _bits(a) -> np.ndarray:
    """The raw bits of a leaf of either package, for ``==``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().reshape(-1)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.uint8)
    a = np.asarray(a).reshape(-1)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


def _jax_leaves(tree) -> dict:
    """{path of keys: leaf} of a JAX tree."""
    return {
        tuple(k.key for k in p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)
    }


def _to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _jax_params(arch: str = ARCH, seed: int = 0, cfg=None):
    cfg = cfg or JC.get(arch).smoke
    p = JM.init_params(cfg, jax.random.key(seed))
    return p, _to_port(p)


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """The llama smoke params and their gradient on a batch, by the JAX
    package."""
    jp, _ = _jax_params()
    jb, _ = _batches(JCFG.vocab, 4, 16)
    return jp, JT.loss_and_grads(JCFG, jp, jb)[1]


def _batches(vocab: int, batch: int, seq: int, step: int = 0, extras=None):
    dcfg = JD.DataConfig(vocab=vocab, batch=batch, seq=seq, seed=1)
    tcfg = TD.DataConfig(vocab=vocab, batch=batch, seq=seq, seed=1)
    jb = JD.make_batch(dcfg, step)
    tb = TD.make_batch(tcfg, step, extras=extras, device="cpu")
    if extras:  # the same stub values on both sides (see test_make_batch_extras)
        stubs = {k: jnp.asarray(_np(tb[k])).astype(jnp.bfloat16) for k in extras}
        jb = dict(jb, **stubs)
    return jb, tb


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_cosine_lr_matches_jax():
    oc = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg, tcfg = JO.OptConfig(**oc), TO.OptConfig(**oc)
    for s in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150):
        mine = TO.cosine_lr(tcfg, torch.tensor(s, dtype=torch.int32))
        ref = float(JO.cosine_lr(jcfg, jnp.asarray(s, jnp.int32)))
        assert mine.dtype == torch.float32
        assert abs(mine.item() - ref) <= F32_TOL * max(abs(ref), 1e-30), s
    assert TO.cosine_lr(tcfg, torch.tensor(0)).item() == 0.0


def test_global_norm_matches_jax():
    rng = np.random.default_rng(40)
    tree = {
        "b": {"w": rng.standard_normal((64, 32)).astype(np.float32)},
        "a": rng.standard_normal(7).astype(np.float32) * 100,
        "c": rng.standard_normal((3, 5, 9)).astype(np.float32) * 1e-3,
    }
    jt = jax.tree.map(jnp.asarray, tree)
    jt["b"]["w"] = jt["b"]["w"].astype(jnp.bfloat16)
    tt = _to_port(jt)
    assert tt["b"]["w"].dtype == torch.bfloat16
    mine, ref = TO.global_norm(tt).item(), float(JO.global_norm(jt))
    assert abs(mine - ref) <= F32_TOL * ref


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_jax(arch):
    jp = JC.params_spec(JC.get(arch).model)
    for path, _ in jax.tree_util.tree_leaves_with_path(jp):
        names = tuple(k.key for k in path)
        assert TO._decay_mask(names) == JO._decay_mask(path), names


def test_init_opt_state():
    _, tp = _jax_params()
    st = TO.init_opt_state(tp)
    assert st["step"].dtype == torch.int32 and st["step"].item() == 0
    trees = (tp, st["master"], st["m"], st["v"])
    for p, mst, m, v in zip(*(leaves(t) for t in trees)):
        assert mst.dtype == m.dtype == v.dtype == torch.float32
        assert torch.equal(mst, p.float()) and not m.any() and not v.any()
        assert mst.data_ptr() != p.data_ptr()  # a copy even of an f32 param


@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_jax_on_its_gradients(clip):
    """Three updates from the JAX package's own gradients (weight decay on
    the matrices, none on the norms), state carried across by
    ``params_from_jax``: masters, m and v within 1e-6 of the reference's;
    the bf16 params are the masters rounded.  With clipping active (the
    smoke gradient norm is above 1) every update is scaled by 1/norm, and
    the two packages sum the norm's 10^5 squares in different orders: the
    norms' own relative gap is added to the bound (twice for v, which
    scales with the square of the clip factor)."""
    jp, jg = _jax_grads()
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0 if clip else 100.0)
    jcfg, tcfg = JO.OptConfig(**oc), TO.OptConfig(**oc)
    jst = JO.init_opt_state(jp)
    tp, tst, tg = _to_port(jp), _to_port(jst), _to_port(jg)
    assert tst["step"].dtype == torch.int32 and tst["step"].shape == ()
    jnorm = float(JO.global_norm(jg))
    gap = abs(TO.global_norm(tg).item() / jnorm - 1)
    assert gap < 2e-6 and (jnorm > tcfg.grad_clip) == clip
    powers = {"master": 1, "m": 1, "v": 2}
    tol = {name: F32_TOL + (k * gap if clip else 0.0) for name, k in powers.items()}
    for _ in range(3):
        jp, jst = JO.adamw_update(jcfg, jp, jg, jst)
        tp, tst = TO.adamw_update(tcfg, tp, tg, tst)
        assert tst["step"].item() == int(jst["step"])
        for name in ("master", "m", "v"):
            ref = _jax_leaves(jst[name])
            for path, t in leaves_with_path(tst[name]):
                assert _rel(t, ref[path]) < tol[name], (name, path)
        for (path, p), mst in zip(leaves_with_path(tp), leaves(tst["master"])):
            assert torch.equal(p, mst.to(p.dtype)), path
    assert torch.equal(tg["embed"], _to_port(jg)["embed"])  # grads not written


# ---------------------------------------------------------------------------
# mesh and sharding specs
# ---------------------------------------------------------------------------


def _meshes():
    """(JAX-readable, port) mesh pairs of several shapes: ``param_pspec``
    reads only the axis names and the device grid's shape."""
    out = []
    for shape, axes in (
        ((1, 1), ("data", "model")),
        ((16, 16), ("data", "model")),
        ((32, 8), ("data", "model")),
        ((2, 16, 16), ("pod", "data", "model")),
    ):
        grid = np.empty(shape, dtype=object)
        jax_side = types.SimpleNamespace(axis_names=axes, devices=grid)
        out.append((jax_side, Mesh(grid, axes)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """Every leaf of the published config, under FSDP_TP, TP_ONLY and
    REPLICATED, on four mesh shapes: the port's spec == the JAX spec."""
    jspec = JC.params_spec(JC.get(arch).model)
    tspec = PC.params_spec(PC.get(arch).model)
    names = ("FSDP_TP", "TP_ONLY", "REPLICATED")
    rules = [(getattr(JS, r), getattr(TS, r)) for r in names]
    for jm, tm in _meshes():
        for jrules, trules in rules:
            ref = {
                tuple(k.key for k in p): tuple(JS.param_pspec(p, x, jm, jrules))
                for p, x in jax.tree_util.tree_leaves_with_path(jspec)
            }
            mine = {
                p: TS.param_pspec(p, x, tm, trules) for p, x in leaves_with_path(tspec)
            }
            assert mine == ref


@pytest.mark.parametrize("n_chips", [1, 4, 8, 12, 256, 512])
def test_choose_mesh_shape_matches_jax(n_chips):
    for arch in ARCHS:
        for which in ("model", "smoke"):
            jcfg, tcfg = getattr(JC.get(arch), which), getattr(PC.get(arch), which)
            ref = JS.choose_mesh_shape(jcfg, n_chips)
            assert TS.choose_mesh_shape(tcfg, n_chips) == ref


@pytest.mark.parametrize("family", ["llama3.2-3b", "mamba2-780m", "recurrentgemma-2b",
                                    "whisper-small"])
def test_batch_and_cache_specs_match_jax(family):
    jc = JM.init_cache(JC.get(family).smoke, 4, 32)
    tc = TM.init_cache(PC.get(family).smoke, 4, 32, device="meta")
    batch = {"tokens": np.zeros((4, 8), np.int32), "odd": np.zeros((3, 2), np.float32),
             "scalar": np.zeros((), np.float32)}
    for jm, tm in _meshes():
        assert TS.batch_axes(tm) == JS.batch_axes(jm)
        assert TS.batch_pspec(tm) == tuple(JS.batch_pspec(jm))
        refc = {tuple(k.key for k in p): tuple(JS.cache_pspec(p, x, jm))
                for p, x in jax.tree_util.tree_leaves_with_path(jc)}
        minec = {p: TS.cache_pspec(p, x, tm) for p, x in leaves_with_path(tc)}
        assert minec == refc
    ref = {k: tuple(s.spec) for k, s in JS.batch_shardings(batch, JMESH).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert {k: s.spec for k, s in TS.batch_shardings(tbatch, MESH).items()} == ref


def test_one_card_placement_and_meshes():
    assert MESH.axis_names == ("data", "model") and MESH.devices.shape == (1, 1)
    assert MESH.size == 1
    sh = TS.params_shardings({"w": torch.zeros(4, 4, dtype=torch.bfloat16)}, MESH)
    assert sh["w"].place(torch.ones(2)).device.type == "cpu"
    wide = TS.NamedSharding(_meshes()[1][1], ("data", None))
    with pytest.raises(NotImplementedError):
        wide.place(torch.ones(2))
    with pytest.raises(RuntimeError, match="needs 256"):
        make_production_mesh(device="cpu")
    with pytest.raises(Exception):
        make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3, 11])
def test_make_batch_tokens_match_jax(step):
    dcfg = dict(vocab=CFG.vocab, batch=4, seq=33, seed=7)
    jb = JD.make_batch(JD.DataConfig(**dcfg), step)
    tb = TD.make_batch(TD.DataConfig(**dcfg), step, MESH)
    for k in ("tokens", "labels"):
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    it = TD.batch_iterator(TD.DataConfig(**dcfg), start_step=step, device="cpu")
    for s in (step, step + 1):
        got_step, b = next(it)
        assert got_step == s
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(
            JD.make_batch(JD.DataConfig(**dcfg), s)["tokens"]))


def test_make_batch_extras():
    """Same shape, dtype and scale as the JAX package's stubs; a pure
    function of (seed, step, name), in any process (a stable name hash)."""
    dcfg = TD.DataConfig(vocab=CFG.vocab, batch=3, seq=8, seed=2)
    extras = {"frames": (3, 40, 64), "patches": (3, 6, 64)}
    tb = TD.make_batch(dcfg, 5, extras=extras, device="cpu")
    jcfg = JD.DataConfig(vocab=CFG.vocab, batch=3, seq=8, seed=2)
    jb = JD.make_batch(jcfg, 5, extras=extras)
    for name, shape in extras.items():
        assert tuple(tb[name].shape) == jb[name].shape == shape
        assert tb[name].dtype == torch.bfloat16 and str(jb[name].dtype) == "bfloat16"
        assert abs(tb[name].float().std().item() / 0.02 - 1) < 0.1
    again = TD.make_batch(dcfg, 5, extras=extras, device="cpu")
    assert torch.equal(tb["frames"], again["frames"])
    later = TD.make_batch(dcfg, 6, extras=extras, device="cpu")
    assert not torch.equal(tb["frames"], later["frames"])
    assert not torch.equal(tb["frames"][:, :6], tb["patches"])
    code = (
        "import torch\nfrom repro_torch.training.data import DataConfig, make_batch\n"
        "b = make_batch(DataConfig(512, 3, 8, 2), 5, extras={'frames': (3, 40, 64)},"
        " device='cpu')\n"
        "print(float(b['frames'].float().sum()))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONHASHSEED="123")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == float(tb["frames"].float().sum())


# ---------------------------------------------------------------------------
# checkpoints, across the two packages
# ---------------------------------------------------------------------------


def _small_tree():
    return {
        "a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 7,
        "b": {
            "c": jnp.linspace(-1, 1, 4, dtype=jnp.float32),
            "d": jnp.asarray(3, jnp.int32),
        },
    }


def _assert_same_bits(port_tree, jax_tree):
    ref = _jax_leaves(jax_tree)
    got = dict(leaves_with_path(port_tree))
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        assert _bits(got[path]).shape == _bits(leaf).shape, path
        np.testing.assert_array_equal(_bits(got[path]), _bits(leaf), err_msg=str(path))


@pytest.mark.parametrize("which", ["small", "train_state"])
def test_checkpoints_cross_packages_bit_for_bit(tmp_path, which):
    """A checkpoint of either package restores in the other, every leaf bit
    for bit (bf16 included); both write the same signature and dtypes."""
    if which == "small":
        jtree = _small_tree()
    else:
        jp, _ = _jax_params()
        jtree = {"params": jp, "opt": JO.init_opt_state(jp)}
        jtree["opt"]["m"] = jax.tree.map(lambda x: x + 0.25, jtree["opt"]["m"])
    ttree = _to_port(jtree)
    JCk.save(str(tmp_path / "jax"), 4, jtree)
    TCk.save(str(tmp_path / "port"), 4, ttree, extra={"note": "x"})
    mj, mt = (_manifest(tmp_path / d, 4) for d in ("jax", "port"))
    assert mt["signature"] == mj["signature"] and mt["dtypes"] == mj["dtypes"]
    assert mt["n_leaves"] == mj["n_leaves"] and mt["extra"] == {"note": "x"}
    _assert_same_bits(TCk.restore(str(tmp_path / "jax"), 4, ttree), jtree)
    _assert_same_bits(ttree, JCk.restore(str(tmp_path / "port"), 4, jtree))
    # restored from the shapes alone (meta tensors), placed by shardings
    meta = tree_map(lambda t: t.to("meta"), ttree)
    sh = tree_map(lambda _: TS.NamedSharding(MESH, ()), meta)
    step, got = TCk.restore_latest(str(tmp_path / "jax"), meta, sh)
    assert step == 4
    _assert_same_bits(got, jtree)


def _manifest(ckpt_dir, step: int) -> dict:
    with open(ckpt_dir / f"step_{step:08d}" / "manifest.json") as f:
        return json.load(f)


def test_checkpoint_latest_ignores_tmp(tmp_path):
    TCk.save(str(tmp_path), 1, {"a": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert TCk.latest_step(str(tmp_path)) == 1
    assert TCk.latest_step(str(tmp_path / "none")) is None
    assert TCk.restore_latest(str(tmp_path / "none"), {"a": torch.ones(2)}) is None


def test_checkpoint_structure_mismatch_detected(tmp_path):
    TCk.save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch"):
        TCk.restore(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        TCk.restore(str(tmp_path), 1, {"a": torch.ones(2, dtype=torch.bfloat16)})


def test_checkpoint_atomic_commit_overwrites(tmp_path):
    TCk.save(str(tmp_path), 1, {"a": torch.ones(2)})
    TCk.save(str(tmp_path), 1, {"a": torch.zeros(2)})  # re-commit the same step
    out = TCk.restore(str(tmp_path), 1, {"a": torch.ones(2)})
    assert torch.equal(out["a"], torch.zeros(2))
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_and_grads_match_jax(microbatches):
    """Loss within 3e-2; every gradient leaf within 3e-2 (max |Δ| / max
    |ref|); with 2 microbatches the gradients accumulate in f32, as in the
    reference."""
    jp, tp = _jax_params()
    jb, tb = _batches(CFG.vocab, 4, 16)
    jl, jg = JT.loss_and_grads(JCFG, jp, jb, microbatches)
    tl, tg = TT.loss_and_grads(CFG, tp, tb, microbatches)
    assert abs(tl.item() - float(jl)) < BF16_TOL * abs(float(jl))
    ref = _jax_leaves(jg)
    for path, g in leaves_with_path(tg):
        assert str(g.dtype).removeprefix("torch.") == str(ref[path].dtype), path
        assert _rel(g, ref[path]) < BF16_TOL, path
    for p in leaves(tp):
        assert not p.requires_grad


def test_indivisible_batch_rejected():
    _, tp = _jax_params()
    _, tb = _batches(CFG.vocab, 6, 8)
    with pytest.raises(ValueError, match="divisible"):
        TT.loss_and_grads(CFG, tp, tb, microbatches=4)


@pytest.mark.parametrize(
    "arch", ["llama3.2-3b", "phi3.5-moe-42b-a6.6b", "whisper-small"]
)
def test_train_steps_match_jax(arch):
    """Three steps of ``make_train_step`` from the same params: each step's
    loss within 3e-2 of the reference's.  The JAX step is ``jax.jit``ted
    without shardings: its own ``jitted`` form (shardings on the host mesh)
    fails to trace the embedding gather on this JAX version, which is why
    the reference's tests/test_training.py::test_loss_decreases_end_to_end
    fails."""
    jcfg, cfg = JC.get(arch).smoke, PC.get(arch).smoke
    jp, tp = _jax_params(arch)
    oc = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jtrain = JT.TrainConfig(opt=JO.OptConfig(**oc))
    ttrain = TT.TrainConfig(opt=TO.OptConfig(**oc))
    jstep = jax.jit(JT.make_train_step(jcfg, JMESH, jtrain)[0])
    step, tjit = TT.make_train_step(cfg, MESH, ttrain)
    jst, tst = JO.init_opt_state(jp), TO.init_opt_state(tp)
    extras = None
    if cfg.frontend == "audio":
        extras = {"frames": (2, cfg.enc_seq, cfg.d_model)}
    for i in range(3):
        jb, tb = _batches(cfg.vocab, 2, 16, step=i, extras=extras)
        assert tjit(tp, tst, tb) is step
        jp, jst, jm = jstep(jp, jst, jb)
        tp, tst, tm = step(tp, tst, tb)
        assert tm["step"].item() == int(jm["step"]) == i + 1
        ref = float(jm["loss"])
        assert abs(tm["loss"].item() - ref) < BF16_TOL * ref, i
        assert abs(tm["grad_norm"].item() / float(jm["grad_norm"]) - 1) < BF16_TOL, i


def test_jitted_checks_the_trees_lie_on_the_mesh():
    _, tp = _jax_params()
    _, jitted = TT.make_train_step(CFG, MESH)
    with pytest.raises(ValueError, match="meta"):
        jitted(tree_map(lambda t: t.to("meta"), tp), {}, {})


def test_init_sharded_on_the_cpu_mesh():
    params, opt = TT.init_sharded(CFG, MESH, seed=3)
    ref = TM.init_params(CFG, 3, device="cpu")
    for p, r in zip(leaves(params), leaves(ref)):
        assert torch.equal(p, r)
    assert opt["step"].item() == 0 and set(opt) == {"master", "m", "v", "step"}


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def _jax_one_replica(fn):
    """``fn`` inside ``shard_map`` over the host mesh's one-device "data"
    axis, as the reference's DP step runs its collectives, op by op (under
    ``jax.jit`` XLA may fuse a product into a following sum, which rounds
    once where the reference's operations, and the port's, round twice)."""
    return jax.shard_map(fn, mesh=JMESH, in_specs=P(), out_specs=P(), check_vma=False)


@pytest.mark.parametrize("size,block", [(777, 64), (1024, 256), (5, 8)])
def test_int8_quantization_is_bit_exact(size, block):
    g = np.random.default_rng(size).standard_normal(size).astype(np.float32) * 3
    g[: size // 3] *= 1e-4  # blocks of very different scales
    jq, js = JCmp.quantize_int8(jnp.asarray(g), block)
    tq, ts = TCmp.quantize_int8(torch.from_numpy(g), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = TCmp.dequantize_int8(tq, ts, (size,), size)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JCmp.dequantize_int8(jq, js, (size,), size)))
    zq, zs = TCmp.quantize_int8(torch.zeros(100), 64)
    assert not TCmp.dequantize_int8(zq, zs, (100,), 100).any()


def test_one_replica_means_match_jax():
    g = np.random.default_rng(41).standard_normal((3, 300)).astype(np.float32)
    g[0, :7] = 2.5  # ties for the top-k, taken in index order
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    ref = _jax_one_replica(lambda x: JCmp.int8_psum_mean(x, "data", 64))(jg)
    mine = TCmp.int8_psum_mean(tg, None, 64)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    ref = _jax_one_replica(lambda x: JCmp.topk_psum_mean(x, "data", 0.01))(jg)
    mine = TCmp.topk_psum_mean(tg, None, 0.01)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
def test_compressed_mean_with_error_feedback_matches_jax(kind):
    """Eight steps of error feedback over one replica: the reduced gradients
    and the carried residuals equal the reference's.  The reference's axis
    is bound by ``jax.vmap`` over a leading axis of one (its collectives are
    those of the one-device mesh of test_one_replica_means_match_jax, which
    runs them op by op ten times slower)."""
    jcfg = JCmp.CompressionConfig(kind=kind, block=64, topk_frac=0.05)
    tcfg = TCmp.CompressionConfig(kind=kind, block=64, topk_frac=0.05)
    shapes = {"w": (8, 33), "b": (40,)}
    je = {k: jnp.zeros((1,) + s) for k, s in shapes.items()}
    te = TCmp.init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    rng = np.random.default_rng(42)
    jfn = jax.vmap(
        lambda a, b: JCmp.compressed_mean(a, b, "data", jcfg), axis_name="data"
    )
    for _ in range(8):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jr, je = jfn({k: jnp.asarray(v)[None] for k, v in g.items()}, je)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tr, te = TCmp.compressed_mean(tg, te, None, tcfg)
        for k in shapes:
            for mine, ref in ((tr[k], jr[k][0]), (te[k], je[k][0])):
                np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=k)


def test_dp_step_with_one_replica():
    """With one replica and no compression, the DP step is the train step
    bit for bit; with int8 compression it keeps a residual and trains."""
    _, tp = _jax_params()
    _, tb = _batches(CFG.vocab, 4, 16)
    step, _ = TT.make_train_step(CFG, MESH)
    p1, s1, m1 = step(tree_map(torch.clone, tp), TO.init_opt_state(tp), tb)
    dp = TT.make_dp_train_step(CFG, MESH)
    err = TT.init_dp_error_state(tp)
    p2, s2, err, m2 = dp(tree_map(torch.clone, tp), TO.init_opt_state(tp), err, tb)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b)
    train = TT.TrainConfig(compression=TCmp.CompressionConfig(kind="int8", block=64))
    dp8 = TT.make_dp_train_step(CFG, MESH, train)
    err = TT.init_dp_error_state(tp)
    _, _, err, m3 = dp8(tree_map(torch.clone, tp), TO.init_opt_state(tp), err, tb)
    assert torch.isfinite(m3["loss"]) and any(e.any() for e in leaves(err))


GLOO = r"""
import os, sys, torch, torch.distributed as dist
from repro_torch.distributed import compression as C
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
g = torch.randn((5, 77), generator=torch.Generator().manual_seed(rank))
out = {"int8": C.int8_psum_mean(g, dist.group.WORLD, 64),
       "topk": C.topk_psum_mean(g, dist.group.WORLD, 0.1),
       "mean": C.pmean(g, dist.group.WORLD)}
torch.save(out, sys.argv[4] + f"/rank{rank}.pt")
dist.destroy_process_group()
"""


def _serial_int8_mean(gs, block):
    """The int8 mean over replicas, one process: each replica quantizes its
    R chunks, replica r averages the chunk r of all, requantizes, and every
    replica gathers the R averaged chunks."""
    R = len(gs)
    size = gs[0].numel()
    chunks = []
    for g in gs:
        flat, _ = TCmp._pad_to(g, block * R)
        q, s = TCmp.quantize_int8(flat.reshape(R, -1), block)
        chunks.append((q.float() * s).reshape(R, -1))
    out = []
    for r in range(R):
        local = torch.stack([c[r] for c in chunks]).mean(0).reshape(-1, block)
        q2, s2 = TCmp.quantize_int8(local, block)
        out.append((q2.float() * s2).reshape(-1))
    return torch.cat(out)[:size].reshape(gs[0].shape)


def test_collectives_over_two_gloo_processes(tmp_path):
    """The compressed means over a real two-process group on the CPU agree
    with the same arithmetic done serially."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", GLOO, str(r), "2", str(port), str(tmp_path)],
            env=env,
            stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    gs = [
        torch.randn((5, 77), generator=torch.Generator().manual_seed(r))
        for r in range(2)
    ]
    expect = {
        "int8": _serial_int8_mean(gs, 64),
        "topk": sum(TCmp.topk_psum_mean(g, None, 0.1) for g in gs) / 2,
        "mean": (gs[0] + gs[1]) / 2,
    }
    for name, ref in expect.items():
        for r in range(2):
            torch.testing.assert_close(outs[r][name], ref, rtol=0, atol=1e-7, msg=name)


# ---------------------------------------------------------------------------
# the launcher: killed and resumed
# ---------------------------------------------------------------------------


def _train_cli(ckpt_dir, stop_after=None):
    """Run the launcher on the CPU; with ``stop_after``, kill it (SIGKILL) as
    soon as it reports that checkpoint.  Returns {step: loss line}."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke"]
    cmd += ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "16"]
    cmd += ["--log-every", "1", "--ckpt-every", "3", "--ckpt-dir", str(ckpt_dir)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    lines = []
    mark = f"step_{stop_after:08d}" if stop_after else None
    try:
        for line in proc.stdout:
            lines.append(line)
            if mark and line.startswith("checkpointed") and mark in line:
                proc.kill()
                break
        proc.wait(timeout=120)
    finally:
        proc.kill()
    if not stop_after:
        assert proc.returncode == 0, proc.stderr.read()
    losses = {
        int(ln.split()[1]): ln.split()[3] for ln in lines if ln.startswith("step ")
    }
    return losses, "".join(lines)


def test_train_cli_killed_and_resumed(tmp_path):
    full, out = _train_cli(tmp_path / "a")
    assert sorted(full) == [1, 2, 3, 4, 5, 6] and out.rstrip().endswith("done")
    assert "resumed" not in out
    first, _ = _train_cli(tmp_path / "b", stop_after=3)
    assert TCk.latest_step(str(tmp_path / "b")) == 3
    second, out = _train_cli(tmp_path / "b")
    assert "resumed from step 3" in out and sorted(second) == [4, 5, 6]
    assert {**first, **second} == full


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """mamba2-780m's smoke config with a decay fast enough that, above the
    chunk's diagonal, exp(cum_i - cum_j) overflows f32 (as the published
    width reaches with random weights: its first gradient is NaN in the
    JAX package).  The reference exponentiates before it masks, so its
    gradient is NaN (0 · inf); the port masks first: the same loss within
    3e-2, every gradient finite."""
    arch = "mamba2-780m"
    jp, _ = _jax_params(arch)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, 4.0)
        if path[-1].key in ("A_log", "dt_bias") else x,
        jp,
    )
    tp = _to_port(jp)
    cfg, jcfg = PC.get(arch).smoke, JC.get(arch).smoke
    jb, tb = _batches(cfg.vocab, 2, 64)
    jloss, jgrads = JT.loss_and_grads(jcfg, jp, jb)
    tloss, tgrads = TT.loss_and_grads(cfg, tp, tb)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jgrads))
    assert all(bool(torch.isfinite(g).all()) for g in leaves(tgrads))
    assert _rel(tloss, jloss) < BF16_TOL
