"""The port's launch layer — ``hlo_analysis``, ``steps``, ``dryrun``,
``serve`` and the meta-device meshes — against the JAX package's.

* ``hlo_analysis`` reads HLO text: on the same text (synthetic, and the
  compiled CPU HLO of reduced JAX lowerables) every result is ``==``.
* ``build_lowerable`` builds every (arch × cell) on the reduced configs;
  its arguments and its meta run's outputs equal the JAX package's
  ``ShapeDtypeStruct``s and ``jax.eval_shape`` leaf for leaf, in shape and
  dtype.
* On the production meshes (16×16 and 2×16×16), the specs and the shard
  each device holds equal those of the JAX package's own
  ``params_shardings``, ``batch_shardings`` and ``cache_shardings``, built
  in a child interpreter with 512 placeholder CPU devices.
* ``launch.serve`` prints the queued lines, round count and width history
  that ``python -m repro.launch.serve`` prints with the same flags.
* The dry run traces every cell of one arch on both meshes, on meta.

The FLOP counts and the steps' numbers are held in
``tests/test_torch_steps.py``.
"""

import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax

import repro.configs as JC
from repro.launch import hlo_analysis as JH
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.steps import build_lowerable as jax_lowerable
import repro_torch.configs as PC
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch import dryrun, serve
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch.mesh import _mesh, make_host_mesh, make_production_mesh
from repro_torch.launch.steps import build_lowerable, device_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = JC.list_archs()
JMESH = jax_host_mesh()
MESH = make_host_mesh(device="meta")


# ---------------------------------------------------------------------------
# hlo_analysis: the same text gives the same numbers
# ---------------------------------------------------------------------------

# tests/test_launch.py's synthetic modules
COLLECTIVES_HLO = """
HloModule m

%cond (p: (s32[])) -> pred[] {
  %p = (s32[]) parameter(0)
  %c = s32[] constant(7)
  %gte = s32[] get-tuple-element(%p), index=0
  ROOT %lt = pred[] compare(%gte, %c), direction=LT
}

%body (p: (s32[])) -> (s32[]) {
  %p = (s32[]) parameter(0)
  %ar = f32[128]{0} all-reduce(%x), to_apply=%add
  ROOT %t = (s32[]) tuple(%gte)
}

ENTRY %main (a: f32[128]) -> f32[128] {
  %ag = f32[256]{0} all-gather(%a), dimensions={0}
  %w = (s32[]) while(%init), condition=%cond, body=%body
  ROOT %r = f32[128]{0} copy(%a)
}
"""

DOT_HLO = """
HloModule m

%cond (p: (s32[])) -> pred[] {
  %p = (s32[]) parameter(0)
  %c = s32[] constant(5)
  %gte = s32[] get-tuple-element(%p), index=0
  ROOT %lt = pred[] compare(%gte, %c), direction=LT
}

%body (p: (s32[])) -> (s32[]) {
  %p = (s32[]) parameter(0)
  %a = f32[8,16]{1,0} parameter(1)
  %b = f32[16,4]{1,0} parameter(2)
  %d = f32[8,4]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %t = (s32[]) tuple(%gte)
}

ENTRY %main (x: f32[8,16]) -> f32[8,4] {
  %x = f32[8,16]{1,0} parameter(0)
  %w = (s32[]) while(%init), condition=%cond, body=%body
  ROOT %r = f32[8,4]{1,0} copy(%d0)
}
"""

FUSION_HLO = """
HloModule m

%fused (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  %big = f32[1000]{0} copy(%p2)
  ROOT %r = f32[4]{0} add(%p, %p)
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  ROOT %f = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused
}
"""

SYNTHETIC = {
    "collectives": COLLECTIVES_HLO,
    "dot_in_loop": DOT_HLO,
    "fusion": FUSION_HLO,
}
COMPILED = ("llama3.2-3b/train_4k", "llama3.2-3b/decode_32k")
_compiled_text: dict[str, str] = {}


def _hlo_text(which: str) -> str:
    if which in SYNTHETIC:
        return SYNTHETIC[which]
    if which not in _compiled_text:
        arch, cell = which.split("/")
        low = jax_lowerable(JC.get(arch), cell, JMESH, reduced=True)
        _compiled_text[which] = low.lower().compile().as_text()
    return _compiled_text[which]


def test_type_bytes():
    for s in ("f32[8,4]", "bf16[2,2]{1,0}", "(f32[4], s32[2])", "pred[]", "u4[3]"):
        assert TH._type_bytes(s) == JH._type_bytes(s)
    assert TH._type_bytes("(f32[4], s32[2])") == 24


@pytest.mark.parametrize("which", list(SYNTHETIC) + list(COMPILED))
def test_hlo_analysis_equals_jax(which):
    text = _hlo_text(which)
    mine, ref = TH.collective_stats(text), JH.collective_stats(text)
    assert mine.bytes_by_kind == ref.bytes_by_kind
    assert mine.count_by_kind == ref.count_by_kind
    assert mine.total_bytes == ref.total_bytes and mine.summary() == ref.summary()
    assert TH.while_trip_counts(text) == JH.while_trip_counts(text)
    mc, rc = TH.loop_aware_cost(text), JH.loop_aware_cost(text)
    assert (mc.flops, mc.bytes_hbm) == (rc.flops, rc.bytes_hbm)
    if which in COMPILED:  # a real module: a layer scan and dots in it
        assert TH.while_trip_counts(text) and mc.flops > 0 and mc.bytes_hbm > 0


def test_synthetic_values():
    st = TH.collective_stats(COLLECTIVES_HLO)
    assert st.count_by_kind == {"all-gather": 1, "all-reduce": 7}
    assert st.bytes_by_kind["all-reduce"] == 7 * 2 * 128 * 4
    assert TH.loop_aware_cost(DOT_HLO).flops == 5 * 2 * 8 * 4 * 16
    assert TH.loop_aware_cost(FUSION_HLO).bytes_hbm < 100


# ---------------------------------------------------------------------------
# steps: arguments and outputs leaf for leaf
# ---------------------------------------------------------------------------


def _flat(tree, path="") -> list:
    """[(path, shape, dtype)] of a tree of tuples and dicts, in JAX's leaf
    order and ``jax.tree_util.keystr`` path form."""
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree) for x in _flat(t, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}['{k}']")]
    return [(path, tuple(tree.shape), str(tree.dtype).removeprefix("torch."))]


def _jax_flat(tree) -> list:
    return [
        (jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]


@pytest.mark.parametrize("arch", ARCHS)
def test_lowerable_matches_jax_for_every_cell(arch):
    """Every cell of the reduced config: the same kind, the same argument
    leaves, and the meta run's outputs those of ``jax.eval_shape``."""
    for cell in JC.get(arch).shapes():
        ref = jax_lowerable(JC.get(arch), cell.name, JMESH, reduced=True)
        low = build_lowerable(PC.get(arch), cell.name, MESH, reduced=True)
        assert low.kind == ref.kind and low.kind in ("train", "prefill", "decode")
        assert (low.arch_id, low.cell_name) == (arch, cell.name)
        assert _flat(low.args) == _jax_flat(ref.args), cell.name
        lowered = low.lower()
        out = jax.eval_shape(ref.jitted, *ref.args)
        assert _flat(lowered.outputs) == _jax_flat(out), cell.name
        assert lowered.flops > 0
        assert lowered.flops == sum(lowered.flops_by_op.values())
        # one device: it holds every argument and output whole
        assert lowered.arg_bytes == device_bytes(low.args, None)
        assert lowered.out_bytes == device_bytes(lowered.outputs, None)


def test_device_bytes_divides_by_the_mesh_axes():
    mesh = make_production_mesh(multi_pod=True, device="meta")
    t = torch.empty((64, 32, 6), dtype=torch.bfloat16, device="meta")
    cases = {
        (): 64 * 32 * 6 * 2,
        ("data",): 4 * 32 * 6 * 2,
        (("pod", "data"), "model"): 2 * 2 * 6 * 2,
        (None, ("data", "model")): 0,  # 32 does not split 256 ways
    }
    for spec, want in cases.items():
        sh = NamedSharding(mesh, spec)
        if want:
            assert device_bytes({"w": t}, {"w": sh}) == want
        else:
            with pytest.raises(ValueError, match="does not split"):
                sh.shard_shape(t.shape)
    assert device_bytes((t, {"a": t}), None) == 2 * 64 * 32 * 6 * 2


# ---------------------------------------------------------------------------
# meshes of placeholder devices, and the specs on the production meshes
# ---------------------------------------------------------------------------


def test_meta_meshes():
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert single.devices.shape == (16, 16) and single.axis_names == ("data", "model")
    assert multi.size == 512 and multi.axis_names == ("pod", "data", "model")
    assert all(d.type == "meta" for d in multi.devices.flat)
    tuned = _mesh((32, 8), ("data", "model"), "meta")
    assert tuned.devices.shape == (32, 8)
    with pytest.raises(NotImplementedError):  # placement across cards: not built
        NamedSharding(single, ()).place(torch.ones(2))
    with pytest.raises(RuntimeError, match="needs 256"):
        make_production_mesh(device="cpu")


SHARDED_CELLS = [
    (arch, cell, multi)
    for arch, cell in (
        ("llama3.2-3b", "train_4k"),
        ("llama3.2-3b", "decode_32k"),
        ("phi3.5-moe-42b-a6.6b", "train_4k"),
        ("phi3.5-moe-42b-a6.6b", "decode_32k"),
        ("mamba2-780m", "long_500k"),
    )
    for multi in (False, True)
]

# The JAX side of every cell above, in a child interpreter: the device count
# is fixed when JAX starts, and this process has started it with one.  For
# each in-sharding of the cell as ``repro.launch.steps`` builds it: the
# argument index, the leaf's path, its spec and its per-device shard shape.
_JAX_SHARDINGS = r"""
import json, sys
import jax
from repro.configs import get, input_specs, params_spec
from repro.distributed.sharding import (FSDP_TP, batch_shardings,
                                        cache_shardings, params_shardings)
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import _opt_shardings
from repro.training.optimizer import init_opt_state

def entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else list(e)
    return e

out = {}
for arch, cell_name, multi in json.loads(sys.argv[1]):
    mesh = make_production_mesh(multi_pod=multi)
    spec = get(arch)
    cfg, cell = spec.model, spec.cell(cell_name)
    specs = input_specs(cfg, cell)
    p_sds = params_spec(cfg)
    p_sh = params_shardings(p_sds, mesh, FSDP_TP)
    if cell.kind == "train":
        o_sds = jax.eval_shape(init_opt_state, p_sds)
        args = (p_sds, o_sds, specs)
        shs = (p_sh, _opt_shardings(o_sds, mesh, FSDP_TP),
               batch_shardings(specs, mesh))
    else:
        tok = batch_shardings({"token": specs["token"],
                               "cache_len": specs["cache_len"]}, mesh)
        args = (p_sds, specs["cache"], specs["token"], specs["cache_len"])
        shs = (p_sh, cache_shardings(specs["cache"], mesh), tok["token"],
               tok["cache_len"])
    rows = []
    for i, (a, s) in enumerate(zip(args, shs)):
        for (path, x), sh in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                 jax.tree_util.tree_leaves(s)):
            rows.append([i, jax.tree_util.keystr(path),
                         [entry(e) for e in sh.spec],
                         list(sh.shard_shape(x.shape))])
    out[f"{arch}|{cell_name}|{multi}"] = rows
print(json.dumps(out))
"""
_jax_shardings: dict = {}


def _jax_sharding_rows(key: str) -> list:
    if not _jax_shardings:
        env = dict(
            os.environ,
            PYTHONPATH=os.path.join(ROOT, "src"),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=512",
        )
        arg = json.dumps(SHARDED_CELLS)
        done = subprocess.run(
            [sys.executable, "-c", _JAX_SHARDINGS, arg],
            capture_output=True,
            text=True,
            env=env,
            timeout=600,
        )
        assert done.returncode == 0, done.stderr[-3000:]
        _jax_shardings.update(json.loads(done.stdout.strip().splitlines()[-1]))
    return _jax_shardings[key]


def _spec_list(spec: tuple, ndim: int) -> list:
    """A spec as the child prints one: one entry per dim, tuples as lists."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return [list(e) if isinstance(e, tuple) else e for e in entries]


def _port_rows(low) -> list:
    rows = []
    for i, (a, s) in enumerate(zip(low.args, low.in_shardings)):
        for (path, shape, _), sh in zip(_flat(a), _sharding_leaves(s)):
            spec = _spec_list(sh.spec, len(shape))
            rows.append([i, path, spec, list(sh.shard_shape(shape))])
    return rows


def _sharding_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sharding_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize(
    "arch,cell,multi",
    SHARDED_CELLS,
    ids=[f"{a}-{c}-{'2x16x16' if m else '16x16'}" for a, c, m in SHARDED_CELLS],
)
def test_production_mesh_shardings_match_jax(arch, cell, multi):
    """Every in-sharding of the cell at its full global shapes: the spec
    and the shard one device holds, leaf for leaf."""
    ref = _jax_sharding_rows(f"{arch}|{cell}|{multi}")
    for row in ref:  # JAX's specs leave trailing dims out; pad as the port's
        row[2] = row[2] + [None] * (len(row[3]) - len(row[2]))
    mesh = make_production_mesh(multi_pod=multi, device="meta")
    low = build_lowerable(PC.get(arch), cell, mesh)
    assert _port_rows(low) == ref
    assert any(any(e is not None for e in row[2]) for row in ref)  # something splits


# ---------------------------------------------------------------------------
# launch.serve against python -m repro.launch.serve
# ---------------------------------------------------------------------------

_DRAINED = re.compile(r"^drained in (\d+) rounds, [\d.]+s$")


def _serve_summary(text: str) -> tuple:
    """(queued lines, round count, width history lines) of a serve run."""
    lines = [ln.rstrip() for ln in text.splitlines()]
    queued = [ln for ln in lines if ln.startswith("tenant ")]
    rounds = [int(m.group(1)) for m in map(_DRAINED.match, lines) if m]
    i = lines.index("partition width history (round, tenant, cols):")
    return queued, rounds, lines[i + 1 :]


@pytest.mark.parametrize(
    "flags",
    [
        [],
        ["--tenants", "whisper-small,llama3.2-3b", "--requests", "3", "--max-new", "5"],
    ],
    ids=["defaults", "two-tenants"],
)
def test_serve_matches_jax_launcher(flags, capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *flags],
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert serve.main([*flags, "--device", "cpu"]) == 0
    mine = _serve_summary(capsys.readouterr().out)
    assert mine == _serve_summary(ref.stdout)
    queued, rounds, history = mine
    assert len(queued) == (2 if flags else 3) and rounds[0] > 0 and history


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dryrun_traces_every_cell_of_one_arch_on_both_meshes(tmp_path, monkeypatch):
    """recurrentgemma-2b has all four cells; two microbatches keep the train
    cell's accumulation in the run.  The default output lands in build/."""
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "recurrentgemma-2b", "--microbatches", "2", "--quiet"]
    assert dryrun.main(argv) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["build"]
    with open(tmp_path / "build" / "dryrun_torch.json") as f:
        recs = json.load(f)
    cells = [c.name for c in PC.get("recurrentgemma-2b").shapes()]
    assert sorted(recs) == sorted(
        f"recurrentgemma-2b|{c}|{m}" for c in cells for m in ("16x16", "2x16x16")
    )
    jax_keys = {  # the JAX package's record keys (repro/launch/dryrun.py)
        "arch", "cell", "mesh", "chips", "ok", "compile_s", "flops_per_device",
        "bytes_per_device", "flops_xla_raw", "bytes_xla_raw", "transcendentals",
        "arg_bytes", "out_bytes", "temp_bytes", "collective_bytes", "collectives",
    }
    for key, rec in recs.items():
        assert rec["ok"] and set(rec) == jax_keys, key
        assert rec["chips"] == (512 if rec["mesh"] == "2x16x16" else 256)
        assert rec["flops_per_device"] > 0 and rec["arg_bytes"] > 0
        assert all(rec[k] is None for k in dryrun.XLA_ONLY)
    # a step's FLOPs do not depend on the mesh; per device they halve
    for c in cells:
        one, two = (recs[f"recurrentgemma-2b|{c}|{m}"] for m in ("16x16", "2x16x16"))
        assert two["flops_per_device"] * 2 == pytest.approx(one["flops_per_device"])
        assert two["arg_bytes"] <= one["arg_bytes"]


def test_dryrun_records_a_failing_cell(tmp_path, capsys):
    out = tmp_path / "r.json"
    argv = ["--arch", "mamba2-780m", "--cell", "no_such_cell", "--out", str(out)]
    assert dryrun.main(argv + ["--mesh", "single", "--quiet"]) == 1
    rec = json.loads(out.read_text())["mamba2-780m|no_such_cell|16x16"]
    assert rec["ok"] is False and "KeyError" in rec["error"]
    assert "dry-run: 0 ok, 1 failed" in capsys.readouterr().out
