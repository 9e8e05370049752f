"""The port's moe, ssm, hybrid and encdec decode paths, and every registered
configuration, against the JAX package's.

The JAX parameters go across through NumPy (``params_from_jax``), so both
packages compute the same function on the same inputs.  Inputs come from a
NumPy seed.

Tolerances: bf16 results are held to 3e-2 (rtol = atol), the JAX package's
own bf16 tolerance (tests/test_kernels.py ``TOL``); f32 results to 1e-4,
its f32 tolerance.  GELU and SiLU are evaluated the way ``jax.nn``
evaluates them on bf16, bit for bit.  The RG-LRU's sequence path is a loop
over time where the JAX package runs an associative scan: the same f32
recurrence summed in another order, well inside 1e-4.

The decode step is held against the JAX ``decode_step`` evaluated op by op
(``jax.disable_jit()``), where every ``jnp`` operation rounds where it is
written, as every PyTorch operation does.  Compiled, XLA fuses a layer's
operations and rounds some of them elsewhere (the JAX package's own
compiled and op-by-op recurrentgemma-2b smoke logits differ by up to 1.5
times the bf16 band); the compiled path is what ``DecodeSession`` runs,
and the session tests below compare with it by the margin rule.

Greedy tokens follow tests/test_torch_serving.py's margin rule: where the
JAX top-2 logit margin at a step is within twice the bf16 band, rounding
alone can flip the argmax, and the comparison of that request stops there.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
from repro.distributed.tenancy import TenantMeshManager as JaxManager
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.serving.engine import MultiTenantEngine as JaxEngine
from repro.serving.kv_cache import DecodeSession as JaxSession
from repro.serving.kv_cache import Request as JaxRequest
import repro_torch.configs as PC
from repro_torch.distributed.tenancy import TenantMeshManager, device_grid
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import MultiTenantEngine
from repro_torch.serving.kv_cache import DecodeSession, Request

RTOL = ATOL = 3e-2
BF16 = dict(rtol=RTOL, atol=ATOL)
F32 = dict(rtol=1e-4, atol=1e-4)

ARCHS = JC.list_archs()
NEW_FAMILIES = {  # one smoke config per family this slice ports, and dbrx
    "moe": "phi3.5-moe-42b-a6.6b",
    "moe-ln-top4": "dbrx-132b",
    "ssm": "mamba2-780m",
    "hybrid": "recurrentgemma-2b",
    "encdec": "whisper-small",
}
DENSE = ["deepseek-coder-33b", "internvl2-26b", "mistral-nemo-12b", "nemotron-4-15b"]
CELLS = [(a, c.name) for a in ARCHS for c in JC.get(a).shapes()]


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(a: np.ndarray, bf16: bool = True):
    """The same values as a JAX array and a tensor (bf16 or f32)."""
    if bf16:
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _params(arch: str, seed: int = 0, f32: bool = False):
    """The JAX smoke parameters and their copy in the port."""
    tree = JM.init_params(JC.get(arch).smoke, jax.random.key(seed))
    cast = (lambda a: np.asarray(a).astype(np.float32)) if f32 else np.asarray
    leaves = jax.tree.map(cast, tree)
    return jax.tree.map(jnp.asarray, leaves), params_from_jax(leaves, device="cpu")



def _paths(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _dtype(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# the registry: every configuration, spec and shape
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    assert PC.list_archs() == JC.list_archs()
    assert PC.__all__ == JC.__all__
    assert PC.TUNED_PROFILES == JC.TUNED_PROFILES
    with pytest.raises(KeyError, match="known"):
        PC.get("nonesuch")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_jax(arch):
    spec, jspec = PC.get(arch), JC.get(arch)
    assert spec.arch_id == jspec.arch_id
    assert spec.model.__dict__ == jspec.model.__dict__
    assert spec.smoke.__dict__ == jspec.smoke.__dict__
    assert spec.skip_shapes == jspec.skip_shapes
    assert spec.skip_reasons == jspec.skip_reasons
    assert [s.name for s in spec.shapes()] == [s.name for s in jspec.shapes()]
    assert spec.model.sub_quadratic == jspec.model.sub_quadratic
    for prop in ("attn_cfg", "local_attn_cfg", "ssm_cfg", "rglru_cfg"):
        mine, theirs = getattr(spec.model, prop), getattr(jspec.model, prop)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), prop


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    spec, jspec = PC.get(arch), JC.get(arch)
    assert spec.model.param_count() == jspec.model.param_count()
    assert spec.smoke.param_count() == jspec.smoke.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_spec_matches_jax_without_allocating(arch):
    mine = _paths(PC.params_spec(PC.get(arch).model))
    theirs = {
        tuple(k.key for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(
            JC.params_spec(JC.get(arch).model)
        )
    }
    assert set(mine) == set(theirs)
    for path, leaf in theirs.items():
        assert mine[path].is_meta, path
        assert tuple(mine[path].shape) == leaf.shape, path
        assert _dtype(mine[path]) == str(leaf.dtype), path


@pytest.mark.parametrize("arch,cell", CELLS)
def test_input_specs_match_jax(arch, cell):
    cfg, jcfg = PC.get(arch).model, JC.get(arch).model
    mine = _paths(PC.input_specs(cfg, PC.get(arch).cell(cell)))
    theirs = {
        tuple(k.key for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(
            JC.input_specs(jcfg, JC.get(arch).cell(cell))
        )
    }
    assert set(mine) == set(theirs)
    for path, leaf in theirs.items():
        assert mine[path].is_meta, path
        assert tuple(mine[path].shape) == leaf.shape, path
        assert _dtype(mine[path]) == str(leaf.dtype), path


def test_input_specs_batch_and_seq_overrides():
    spec = PC.get("recurrentgemma-2b")
    cell = spec.cell("long_500k")
    mine = PC.input_specs(spec.model, cell, batch=2, seq=64)
    theirs = JC.input_specs(JC.get("recurrentgemma-2b").model, cell, batch=2, seq=64)
    assert tuple(mine["cache"]["attn_k"].shape) == theirs["cache"]["attn_k"].shape
    assert mine["cache"]["attn_k"].shape[2] == 64  # the window, cut to seq
    with pytest.raises(ValueError, match="skips long_500k"):
        PC.get("llama3.2-3b").cell("long_500k")


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_jax(arch):
    cfg = PC.get(arch).smoke
    mine = _paths(TM.init_params(cfg, 0, device="cpu"))
    _, ported = _params(arch)
    theirs = _paths(ported)
    assert set(mine) == set(theirs)
    for path, t in theirs.items():
        assert tuple(mine[path].shape) == tuple(t.shape), path
        assert mine[path].dtype == t.dtype, path
        assert mine[path].device.type == "cpu"


def test_init_scales():
    """The draws the JAX package makes: experts N(0, 1/d_model), the down
    projection included; conv N(0, 1/width); the position tables
    N(0, 0.02²)."""
    moe = dataclasses.replace(PC.get("phi3.5-moe-42b-a6.6b").smoke, d_ff=512)
    p = TM.init_params(moe, 1, device="cpu")["blocks"]["moe"]
    for name in ("gate", "up", "down"):
        assert abs(p[name].float().std().item() * moe.d_model**0.5 - 1) < 0.05, name
    assert p["router"].dtype == torch.float32
    hyb = PC.get("recurrentgemma-2b").smoke
    rec = TM.init_params(hyb, 2, device="cpu")["blocks"]["sub0"]["rglru"]
    assert abs(rec["conv"]["w"].float().std().item() * 2.0 - 1) < 0.1
    enc = TM.init_params(PC.get("whisper-small").smoke, 3, device="cpu")
    assert abs(enc["dec_pos"].float().std().item() / 0.02 - 1) < 0.1


def test_stacked_draw_keeps_a_small_temporary(monkeypatch):
    """A stacked weight is drawn a block of rows at a time: no f32 draw is
    larger than the block, whatever the leading axes."""
    monkeypatch.setattr(TL, "_DRAW_ELEMS", 1024)
    sizes = []
    randn = torch.randn

    def spy(shape, **kw):
        sizes.append(math.prod(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    gen = torch.Generator().manual_seed(0)
    w = TL.normal(gen, (3, 4, 64, 40), 0.5)
    assert max(sizes) <= 1024 and sum(sizes) == w.numel()
    assert w.dtype == torch.bfloat16 and abs(w.float().std().item() / 0.5 - 1) < 0.05


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
def test_init_cache_matches_jax_with_separate_layers(family):
    arch = NEW_FAMILIES[family]
    cfg, jcfg = PC.get(arch).smoke, JC.get(arch).smoke
    mine = _paths(TM.init_cache(cfg, 3, 24, device="cpu"))
    theirs = _paths(JM.init_cache(jcfg, 3, 24))
    assert set(mine) == set(theirs)
    for path, leaf in theirs.items():
        t = mine[path]
        assert tuple(t.shape) == leaf.shape and _dtype(t) == str(leaf.dtype), path
        assert not t.any()
        # its own memory per layer: writing layer 0 leaves layer 1 as it was
        assert 0 not in t.stride(), path
        if t.shape[0] > 1:
            t[0].fill_(1)
            assert not t[1].any(), path


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [True, False])
def test_layernorm(bf16):
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((4, 1, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.standard_normal((2, 64)).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    jx, tx = _pair(x, bf16)
    tol = BF16 if bf16 else dict(rtol=1e-5, atol=1e-5)
    out = TL.layernorm(tp, tx)
    np.testing.assert_allclose(_np(out), _np(JL.layernorm(jp, jx)), **tol)


def test_gelu_and_silu_are_jax_nn_bit_for_bit():
    x = _normal(11, 20000) * 4
    jx, tx = _pair(x)
    np.testing.assert_array_equal(_np(TL.gelu(tx)), _np(jax.nn.gelu(jx)))
    np.testing.assert_array_equal(_np(TL.silu(tx)), _np(jax.nn.silu(jx)))
    jx, tx = _pair(x, bf16=False)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(TL.gelu(tx)), _np(jax.nn.gelu(jx)), **tol)
    np.testing.assert_allclose(_np(TL.silu(tx)), _np(jax.nn.silu(jx)), **tol)


def _conv_params(seed, dim=24, width=4):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((width, dim)) / 2).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    jp = {"w": jw, "b": jnp.asarray(b)}
    tp = {"w": torch.from_numpy(w).bfloat16(), "b": torch.from_numpy(b)}
    return jp, tp


@pytest.mark.parametrize("bf16", [True, False])
def test_causal_conv1d(bf16):
    jp, tp = _conv_params(12)
    x = _normal(13, (2, 9, 24))
    jx, tx = _pair(x, bf16)
    tol = BF16 if bf16 else F32
    out = TL.causal_conv1d(tp, tx)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(JL.causal_conv1d(jp, jx)), **tol)


@pytest.mark.parametrize("bf16", [True, False])
def test_conv1d_step_matches_jax_and_the_sequence_conv(bf16):
    jp, tp = _conv_params(14)
    x = _normal(15, (2, 6, 24))
    jx, tx = _pair(x, bf16)
    tol = BF16 if bf16 else F32
    jwin = jnp.zeros((2, 3, 24), jx.dtype)
    twin = torch.zeros((2, 3, 24), dtype=tx.dtype)
    steps = []
    for t in range(6):
        jy, jwin = JL.conv1d_step(jp, jwin, jx[:, t])
        ty, twin = TL.conv1d_step(tp, twin, tx[:, t])
        np.testing.assert_allclose(_np(ty), _np(jy), **tol)
        np.testing.assert_array_equal(_np(twin), _np(jwin))
        steps.append(ty)
    seq = TL.causal_conv1d(tp, tx)
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(seq), **tol)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

MOE = PC.get("phi3.5-moe-42b-a6.6b").smoke


def _moe_params(seed, kind="swiglu", f32=False, d=MOE.d_model, ff=MOE.d_ff, E=4):
    p = JMoE.init_moe(jax.random.key(seed), d, ff, E, kind)
    cast = (lambda a: np.asarray(a).astype(np.float32)) if f32 else np.asarray
    leaves = jax.tree.map(cast, p)
    return jax.tree.map(jnp.asarray, leaves), params_from_jax(leaves, device="cpu")


def _selection(p, x: np.ndarray, k: int):
    """The JAX router's top-k experts per token and the gap between the
    k-th and the (k+1)-th gate."""
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ p["router"])
    probs = np.asarray(probs)
    order = np.argsort(-probs, axis=-1, kind="stable")
    srt = np.take_along_axis(probs, order, -1)
    gap = srt[:, k - 1] - srt[:, k] if k < probs.shape[1] else np.full(len(srt), 1.0)
    return order[:, :k], gap


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
def test_moe_ffn_matches_jax(kind, capacity_factor):
    """Routing, capacity drops (at 0.5 a quarter of the assignments and more
    are dropped), the expert FFNs and the combine; in f32 to 1e-4, in bf16
    to 3e-2."""
    x = _normal(16, (3, 8, MOE.d_model))
    for f32 in (True, False):
        jp, tp = _moe_params(17, kind, f32)
        jx, tx = _pair(x, bf16=not f32)
        out = TMoE.moe_ffn(tp, tx, 2, kind, capacity_factor)
        ref = JMoE.moe_ffn(jp, jx, 2, kind, capacity_factor)
        assert out.dtype == tx.dtype and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(_np(out), _np(ref), **(F32 if f32 else BF16))
    # the selection itself, where no near-tie could flip it
    ids, gap = _selection(jp, np.asarray(jx.astype(jnp.float32)), 2)
    probs = torch.softmax(tx.float().reshape(-1, MOE.d_model) @ tp["router"], -1)
    mine = TMoE._top_k(probs, 2)[1].numpy()
    clear = gap > 1e-5
    assert clear.sum() > 0.9 * len(gap)
    np.testing.assert_array_equal(mine[clear], ids[clear])
    T, E = 3 * 8, 4
    cap = math.ceil(T * 2 / E * capacity_factor)
    assert (E * cap < T * 2) == (capacity_factor < 1)  # drops, by pigeonhole


def test_moe_capacity_drops_follow_token_order():
    """With capacity 1 per expert and every token routed to the same two
    experts, only the first token keeps them: the rank within an expert is
    the token order (a stable sort), as in the JAX package."""
    d, E = 8, 4
    jp, tp = _moe_params(18, d=d, ff=16, E=E, f32=True)
    router = np.zeros((d, E), np.float32)
    router[0] = [4.0, 3.0, 0.0, -1.0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.zeros((1, 4, d), np.float32)
    x[..., 0] = 1.0
    x[..., 1:] = np.random.default_rng(19).standard_normal((1, 4, d - 1))
    cf = E / (4 * 2)  # capacity ceil(4·2/4 · cf) = 1
    out = TMoE.moe_ffn(tp, torch.from_numpy(x), 2, capacity_factor=cf)
    ref = JMoE.moe_ffn(jp, jnp.asarray(x), 2, capacity_factor=cf)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)
    assert np.abs(_np(out)[0, 0]).sum() > 0
    np.testing.assert_array_equal(_np(out)[0, 1:], 0.0)


def test_top_k_ties_go_to_the_lower_expert_id():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, ids = TMoE._top_k(probs, 2)
    jvals, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_aux_load_balance_loss(top_k):
    jp, tp = _moe_params(20, f32=True)
    x = _normal(21, (2, 7, MOE.d_model))
    mine = TMoE.aux_load_balance_loss(tp, torch.from_numpy(x), top_k)
    theirs = JMoE.aux_load_balance_loss(jp, jnp.asarray(x), top_k)
    np.testing.assert_allclose(mine.item(), float(theirs), rtol=1e-5)


# ---------------------------------------------------------------------------
# ssm (Mamba-2 SSD)
# ---------------------------------------------------------------------------

SSM = dataclasses.replace(PC.get("mamba2-780m").smoke.ssm_cfg, chunk=8)


def _ssd_params(seed, f32):
    p = JS.init_ssd(jax.random.key(seed), SSM)
    # a non-trivial decay and skip (the init has A_log = 0, D = 1, bias 0)
    rng = np.random.default_rng(seed)
    p = dict(p, A_log=jnp.asarray(rng.uniform(-1, 1, SSM.n_heads).astype(np.float32)))
    p["D"] = jnp.asarray(rng.uniform(0.5, 1.5, SSM.n_heads).astype(np.float32))
    p["dt_bias"] = jnp.asarray(rng.uniform(-1, 0, SSM.n_heads).astype(np.float32))
    cast = (lambda a: np.asarray(a).astype(np.float32)) if f32 else np.asarray
    leaves = jax.tree.map(cast, p)
    return jax.tree.map(jnp.asarray, leaves), params_from_jax(leaves, device="cpu")


@pytest.mark.parametrize("S", [8, 20])
@pytest.mark.parametrize("bf16", [True, False])
def test_ssd_forward(S, bf16):
    """One chunk, and several with a padded last one."""
    jp, tp = _ssd_params(22, f32=not bf16)
    u = _normal(23, (2, S, SSM.d_model))
    ju, tu = _pair(u, bf16)
    out = TS.ssd_forward(tp, SSM, tu)
    ref = JS.ssd_forward(jp, SSM, ju)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **(BF16 if bf16 else F32))


@pytest.mark.parametrize("bf16", [True, False])
def test_ssd_step_matches_jax_and_the_sequence_path(bf16):
    jp, tp = _ssd_params(24, f32=not bf16)
    u = _normal(25, (2, 12, SSM.d_model))
    ju, tu = _pair(u, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    jc = JS.ssd_init_cache(SSM, 2, jnp.bfloat16 if bf16 else jnp.float32)
    tc = TS.ssd_init_cache(SSM, 2, dt, device="cpu")
    tol = BF16 if bf16 else F32
    outs = []
    for t in range(12):
        jy, jc = JS.ssd_step(jp, SSM, jc, ju[:, t])
        ty, tc = TS.ssd_step(tp, SSM, tc, tu[:, t])
        np.testing.assert_allclose(_np(ty), _np(jy), **tol)
        outs.append(ty)
    np.testing.assert_allclose(_np(tc["state"]), _np(jc["state"]), **tol)
    assert tc["state"].dtype == torch.float32 and tc["conv"].dtype == dt
    if not bf16:  # the O(1) decode step is the chunked scan, one token at a time
        seq = TS.ssd_forward(tp, SSM, tu)
        np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(seq), **F32)


# ---------------------------------------------------------------------------
# hybrid (RG-LRU)
# ---------------------------------------------------------------------------

LRU = PC.get("recurrentgemma-2b").smoke.rglru_cfg


def _lru_params(seed, f32):
    p = JR.init_rglru(jax.random.key(seed), LRU)
    rng = np.random.default_rng(seed)
    p = dict(p, ba=jnp.asarray(rng.standard_normal(LRU.lru_width).astype(np.float32)))
    cast = (lambda a: np.asarray(a).astype(np.float32)) if f32 else np.asarray
    leaves = jax.tree.map(cast, p)
    return jax.tree.map(jnp.asarray, leaves), params_from_jax(leaves, device="cpu")


@pytest.mark.parametrize("bf16", [True, False])
def test_rglru_forward(bf16):
    jp, tp = _lru_params(26, f32=not bf16)
    u = _normal(27, (2, 19, LRU.d_model))
    ju, tu = _pair(u, bf16)
    out = TR.rglru_forward(tp, LRU, tu)
    ref = JR.rglru_forward(jp, LRU, ju)
    np.testing.assert_allclose(_np(out), _np(ref), **(BF16 if bf16 else F32))


@pytest.mark.parametrize("bf16", [True, False])
def test_rglru_step_matches_jax_and_the_sequence_path(bf16):
    jp, tp = _lru_params(28, f32=not bf16)
    u = _normal(29, (3, 10, LRU.d_model))
    ju, tu = _pair(u, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    jc = JR.rglru_init_cache(LRU, 3, jnp.bfloat16 if bf16 else jnp.float32)
    tc = TR.rglru_init_cache(LRU, 3, dt, device="cpu")
    tol = BF16 if bf16 else F32
    outs = []
    for t in range(10):
        jy, jc = JR.rglru_step(jp, LRU, jc, ju[:, t])
        ty, tc = TR.rglru_step(tp, LRU, tc, tu[:, t])
        np.testing.assert_allclose(_np(ty), _np(jy), **tol)
        outs.append(ty)
    np.testing.assert_allclose(_np(tc["state"]), _np(jc["state"]), **tol)
    if not bf16:
        seq = TR.rglru_forward(tp, LRU, tu)
        np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(seq), **F32)


def test_rglru_lambda_matches_the_jax_formula():
    gen = torch.Generator().manual_seed(4)
    p = TR.init_rglru(gen, LRU)
    u = torch.exp(-2.0 * 8.0 * torch.nn.functional.softplus(p["lambda"]))
    assert bool(((u > 0.9**2 - 1e-5) & (u < 0.999**2 + 1e-5)).all())
    assert p["lambda"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the decode step, every family
# ---------------------------------------------------------------------------


def _merge(new, old, live):
    """The JAX DecodeSession's masked merge of a new cache (batch on axis 1)."""
    m = jnp.asarray(live)
    return jax.tree.map(
        lambda n, o: jnp.where(m.reshape((1, -1) + (1,) * (n.ndim - 2)), n, o), new, old
    )


def _ragged(arch, steps, seed, max_seq=32, cross=None):
    """``steps`` decode steps of 4 rows at ragged lengths, each step with a
    random set of live rows, through both packages: every row's logits at
    every step, then every cache leaf, agree."""
    cfg, jcfg = PC.get(arch).smoke, JC.get(arch).smoke
    jp, tp = _params(arch, seed)
    B = 4
    jc = JM.init_cache(jcfg, B, max_seq)
    tc = TM.init_cache(cfg, B, max_seq, device="cpu")
    if cross is not None:
        jc, tc = cross(jcfg, jp, jc, tc)
    lens = np.array([0, 3, 6, 1], np.int32)
    rng = np.random.default_rng(seed + 100)
    for step in range(steps):
        live = rng.random(B) < 0.7
        live[step % B] = True
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        with jax.disable_jit():
            jl, jn = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(lens))
        jc = _merge(jn, jc, live)
        tl, tc2 = TM.decode_step(
            cfg,
            tp,
            tc,
            torch.from_numpy(tok).long(),
            torch.from_numpy(lens),
            torch.from_numpy(live),
        )
        assert tc2 is tc and tuple(tl.shape) == jl.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), **BF16, err_msg=f"step {step}")
        lens = lens + live
    for path, leaf in _paths(jc).items():
        mine = _paths(tc)[path]
        np.testing.assert_allclose(_np(mine), _np(leaf), **BF16, err_msg=str(path))
    return lens


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
def test_decode_step_over_ragged_steps_matches_jax(family):
    """20 steps: rows reach 16-22 tokens, so the hybrid's window of 16 wraps
    its ring cache; the moe configs route 4 tokens over 4 experts at
    capacity ceil(4·k/4 · 1.25), so assignments are dropped."""
    lens = _ragged(NEW_FAMILIES[family], 20, seed=5)
    assert lens.max() > PC.get("recurrentgemma-2b").smoke.window


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_decode_like_jax(arch):
    """The dense family's other configs (LayerNorm, squared ReLU, the vision
    backbone's decode) over 5 steps, as tests/test_torch_models.py runs
    llama3.2-3b."""
    _ragged(arch, 5, seed=6)


def _fill_cross(jcfg, jp, jc, tc):
    """The encoder's KV in both caches (tests/test_models.py
    ``_fill_cross_cache``): the JAX encoder over random frames, projected
    by each decoder layer's cross-attention weights."""
    B = jc["cross_k"].shape[1]
    frames = np.random.default_rng(7).standard_normal((B, jcfg.enc_seq, jcfg.d_model))
    mem = JM._encode(jcfg, jp, jnp.asarray(frames.astype(np.float32)) * 0.5)

    def fill(bp):
        shape = (B, jcfg.enc_seq, jcfg.n_kv_heads, jcfg.head_dim)
        kk = (mem @ bp["cross"]["wk"]).reshape(shape)
        vv = (mem @ bp["cross"]["wv"]).reshape(shape)
        kk = kk + bp["cross"]["bk"].astype(kk.dtype).reshape(shape[2:])
        vv = vv + bp["cross"]["bv"].astype(vv.dtype).reshape(shape[2:])
        return kk, vv

    ks, vs = jax.vmap(fill)(jp["dec_blocks"])
    jc = dict(jc, cross_k=ks.astype(jnp.bfloat16), cross_v=vs.astype(jnp.bfloat16))
    for name in ("cross_k", "cross_v"):
        tc[name].copy_(params_from_jax({"a": np.asarray(jc[name])}, device="cpu")["a"])
    return jc, tc


def test_encdec_cross_attention_over_the_encoders_kv():
    _ragged("whisper-small", 6, seed=8, cross=_fill_cross)


def test_hybrid_ring_window_is_cut_to_max_seq():
    cfg = PC.get("recurrentgemma-2b").smoke  # window 16
    for max_seq, win in ((8, 8), (40, 16)):
        cache = TM.init_cache(cfg, 2, max_seq, device="cpu")
        assert cache["attn_k"].shape[2] == win
    lens = _ragged("recurrentgemma-2b", 12, seed=9, max_seq=8)  # wraps at 8
    assert lens.max() > 8


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
def test_dead_rows_keep_their_cache_bit_for_bit(family):
    """A row that is not live keeps every cache leaf (recurrent state, conv
    window, ring and KV caches) as it was; the live rows' leaves move."""
    arch = NEW_FAMILIES[family]
    cfg = PC.get(arch).smoke
    _, tp = _params(arch)
    cache = TM.init_cache(cfg, 3, 24, device="cpu")
    for leaf in _paths(cache).values():
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(1)))
    before = {k: v.clone() for k, v in _paths(cache).items()}
    live = torch.tensor([True, False, True])
    tok = torch.tensor([[5], [6], [7]])
    lens = torch.tensor([2, 17, 9], dtype=torch.int32)
    TM.decode_step(cfg, tp, cache, tok, lens, live)
    moved = 0
    for path, leaf in _paths(cache).items():
        assert torch.equal(leaf[:, 1], before[path][:, 1]), path
        moved += not torch.equal(leaf, before[path])
    frozen = {("cross_k",), ("cross_v",)}
    assert moved == len(before) - len(frozen & set(before))


# ---------------------------------------------------------------------------
# serving: DecodeSession and the engine over the new families
# ---------------------------------------------------------------------------


def _record(session, rows: dict, is_jax: bool):
    """Keep, per request id, the logits row each of its tokens came from."""
    if is_jax:
        decode = session._decode

        def stash(*args):
            out = decode(*args)
            session.recorded_logits = out[0]
            return out

        session._decode = stash
    step = session.step

    def recorded():
        slots = {slot: req.rid for slot, req in session.live.items()}
        emitted = step()
        if is_jax:
            logits = _np(session.recorded_logits[:, 0])
        else:
            logits = session.last_logits[:, 0].float().numpy()
        for slot, rid in slots.items():
            rows.setdefault(rid, []).append(logits[slot])
        return emitted

    session.step = recorded
    return session


def _assert_same_tokens(jreqs, treqs, jax_rows) -> bool:
    """The margin rule over every request; True if every token agreed."""
    checked = total = 0
    for jr, tr in zip(jreqs, treqs, strict=True):
        assert len(jr.out) == len(tr.out) == jr.max_new
        total += jr.max_new
        for i, (a, b) in enumerate(zip(jr.out, tr.out)):
            if a != b:
                top = np.sort(jax_rows[jr.rid][i])[-2:]
                margin = top[1] - top[0]
                assert margin <= 2 * (ATOL + RTOL * abs(top[1])), (jr.rid, i, margin)
                break
            checked += 1
    assert checked
    return checked == total


def _sessions(arch, seed=0, slots=2, max_seq=40, rows=None):
    cfg, jcfg = PC.get(arch).smoke, JC.get(arch).smoke
    jp, tp = _params(arch, seed)
    js = JaxSession(jcfg, jp, batch_slots=slots, max_seq=max_seq)
    ts = DecodeSession(cfg, tp, batch_slots=slots, max_seq=max_seq, device="cpu")
    return _record(js, rows.setdefault("jax", {}), True), _record(
        ts, rows.setdefault("torch", {}), False
    )


@pytest.mark.parametrize("family", list(NEW_FAMILIES))
def test_decode_session_with_a_reused_slot_matches_jax(family):
    """Three requests over two slots, the third in a released slot: its
    recurrent state and conv window carry over from the request before
    (the JAX package resets only the length), in both packages."""
    rows = {}
    js, ts = _sessions(NEW_FAMILIES[family], rows=rows)
    prompts = [([1, 2, 3], 6), ([7, 8], 14), ([300, 4, 4, 9], 9)]
    jreqs = [JaxRequest(i, p, n) for i, (p, n) in enumerate(prompts)]
    treqs = [Request(i, p, n) for i, (p, n) in enumerate(prompts)]
    for s, reqs in ((js, jreqs), (ts, treqs)):
        s.admit(reqs[0])
        s.admit(reqs[1])
        while reqs[0].slot != -1:
            s.step()
        s.admit(reqs[2])  # the slot request 0 left
        while s.live:
            s.step()
    assert treqs[2].slot == jreqs[2].slot == -1
    if not _assert_same_tokens(jreqs, treqs, rows["jax"]):
        return  # a flipped token: the caches hold different sequences since
    for path, leaf in _paths(js.cache).items():
        np.testing.assert_allclose(
            _np(_paths(ts.cache)[path]), _np(leaf), **BF16, err_msg=str(path)
        )


def test_mixed_family_engine_matches_jax():
    """tests/test_serving.py's two-tenant script, llama3.2-3b beside
    mamba2-780m, through both engines: rounds, widths and tokens agree."""
    rows = {}
    jeng = JaxEngine(JaxManager(make_host_mesh(model=1), "model"))
    teng = MultiTenantEngine(TenantMeshManager(device_grid("cpu", 1)))
    reqs = {"jax": [], "torch": []}
    for i, arch in enumerate(["llama3.2-3b", "mamba2-780m", "recurrentgemma-2b"]):
        js, ts = _sessions(arch, seed=i, slots=2, max_seq=32, rows=rows)
        jeng.add_tenant(arch, js, flops_per_token=float(i + 1))
        teng.add_tenant(arch, ts, flops_per_token=float(i + 1))
        for eng, key in ((jeng, "jax"), (teng, "torch")):
            for _ in range(2):
                reqs[key].append(eng.submit(arch, prompt=[1, 2], max_new=3))
    rounds = [e.run_until_drained(max_rounds=100) for e in (jeng, teng)]
    assert rounds[0] == rounds[1] > 0
    assert not teng.tenants and teng.width_history == jeng.width_history
    _assert_same_tokens(reqs["jax"], reqs["torch"], rows["jax"])
