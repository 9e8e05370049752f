"""The port's dense decode path against the JAX package's, llama3.2-3b smoke.

The JAX parameters go across through NumPy (``params_from_jax``), so both
packages compute the same function on the same inputs.

Tolerance: activations are bf16 in both packages (``decode_step`` casts the
embedding to bf16), so every projection and residual add rounds to 8
mantissa bits, and the two frameworks round at slightly different places
(XLA's CPU dot may keep a bf16 product chain in f32 where PyTorch rounds
after each matmul).  One bf16 rounding is a relative error of 2^-8 ≈ 4e-3;
a few of them compound over the two smoke layers, hence 3e-2 — the JAX
package's own bf16 tolerance (tests/test_kernels.py ``TOL``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.configs import get as jax_get
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

BF16 = dict(rtol=3e-2, atol=3e-2)
F32 = dict(rtol=1e-5, atol=1e-5)

JCFG = jax_get("llama3.2-3b").smoke
CFG = get("llama3.2-3b").smoke
NP_PARAMS = jax.tree.map(np.asarray, JM.init_params(JCFG, jax.random.key(0)))
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
PARAMS = params_from_jax(NP_PARAMS, device="cpu")


def _bf16_pair(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_configs_match_jax():
    spec, jspec = get("llama3.2-3b"), jax_get("llama3.2-3b")
    assert spec.model.__dict__ == jspec.model.__dict__
    assert spec.smoke.__dict__ == jspec.smoke.__dict__
    assert spec.skip_shapes == jspec.skip_shapes
    assert [s.name for s in spec.shapes()] == [s.name for s in jspec.shapes()]
    assert CFG.param_count() == JCFG.param_count()


def test_params_from_jax_keeps_layout_and_bits():
    flat = jax.tree_util.tree_leaves_with_path(NP_PARAMS)
    for path, leaf in flat:
        t = PARAMS
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        if leaf.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            bits = t.view(torch.int16).numpy()
            np.testing.assert_array_equal(bits, leaf.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf)
    # a checkpoint's uint16 view of a bf16 leaf carries the same bits
    emb = NP_PARAMS["embed"]
    via_u16 = params_from_jax({"embed": emb.view(np.uint16)}, device="cpu")["embed"]
    assert torch.equal(via_u16, PARAMS["embed"])


def test_rmsnorm():
    x = np.random.default_rng(0).standard_normal((3, 1, CFG.d_model), np.float32)
    jx, tx = _bf16_pair(x * 3)
    p = _layer(JPARAMS["blocks"]["attn_norm"], 1)
    tp = {"scale": PARAMS["blocks"]["attn_norm"]["scale"][1]}
    np.testing.assert_allclose(_np(TL.rmsnorm(tp, tx)), _np(JL.rmsnorm(p, jx)), **BF16)


def test_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16), np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    jx, tx = _bf16_pair(x)
    out = TL.rope(tx, torch.from_numpy(pos), 500000.0)
    ref = JL.rope(jx, jnp.asarray(pos), 500000.0)
    np.testing.assert_allclose(_np(out), _np(ref), **BF16)
    # in f32 the two formulas agree to f32 rounding
    out32 = TL.rope(torch.from_numpy(x), torch.from_numpy(pos))
    ref32 = JL.rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(_np(out32), _np(ref32), **F32)


def test_project_qkv():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, CFG.d_model), np.float32)
    pos = np.array([[0], [4], [9]], np.int32)
    jx, tx = _bf16_pair(x)
    jp = _layer(JPARAMS["blocks"]["attn"], 0)
    tp = {k: v[0] for k, v in PARAMS["blocks"]["attn"].items()}
    mine = TL._project_qkv(tp, CFG.attn_cfg, tx, torch.from_numpy(pos))
    theirs = JL._project_qkv(jp, JCFG.attn_cfg, jx, jnp.asarray(pos))
    for a, b in zip(mine, theirs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **BF16)


def test_mlp():
    x = np.random.default_rng(3).standard_normal((3, 1, CFG.d_model), np.float32)
    jx, tx = _bf16_pair(x)
    jp = _layer(JPARAMS["blocks"]["mlp"], 1)
    tp = {k: v[1] for k, v in PARAMS["blocks"]["mlp"].items()}
    out = TL.mlp(tp, tx, "swiglu")
    np.testing.assert_allclose(_np(out), _np(JL.mlp(jp, jx, "swiglu")), **BF16)


def _random_cache(seed, batch=3, max_seq=16):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, batch, max_seq, CFG.n_kv_heads, CFG.head_dim)
    k, v = (rng.standard_normal(shape, np.float32) for _ in range(2))
    jk, tk = _bf16_pair(k)
    jv, tv = _bf16_pair(v)
    return {"k": jk, "v": jv}, {"k": tk, "v": tv}


def test_decode_attn_and_cache_write():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, CFG.d_model), np.float32)
    jx, tx = _bf16_pair(x)
    jcache, tcache = _random_cache(5)
    lens = np.array([0, 7, 15], np.int32)
    jp = _layer(JPARAMS["blocks"]["attn"], 1)
    tp = {k: v[1] for k, v in PARAMS["blocks"]["attn"].items()}
    kc, vc = tcache["k"][1].clone(), tcache["v"][1].clone()
    out = TM._decode_attn(tp, CFG.attn_cfg, tx, kc, vc, torch.from_numpy(lens))
    ref, jk, jv = JM._decode_attn(
        jp, JCFG.attn_cfg, jx, jcache["k"][1], jcache["v"][1], jnp.asarray(lens)
    )
    np.testing.assert_allclose(_np(out), _np(ref), **BF16)
    np.testing.assert_allclose(_np(kc), _np(jk), **BF16)
    np.testing.assert_allclose(_np(vc), _np(jv), **BF16)
    # rows other than the written slots are untouched, bit for bit
    untouched = np.ones((3, 16), bool)
    untouched[np.arange(3), lens] = False
    np.testing.assert_array_equal(_np(kc)[untouched], _np(tcache["k"][1])[untouched])


def test_decode_attn_live_rows_only():
    x = np.random.default_rng(6).standard_normal((3, 1, CFG.d_model), np.float32)
    _, tx = _bf16_pair(x)
    _, tcache = _random_cache(7)
    kc, vc = tcache["k"][0].clone(), tcache["v"][0].clone()
    tp = {k: v[0] for k, v in PARAMS["blocks"]["attn"].items()}
    lens = torch.tensor([2, 3, 4])
    live = torch.tensor([True, False, True])
    TM._decode_attn(tp, CFG.attn_cfg, tx, kc, vc, lens, live)
    assert torch.equal(kc[1], tcache["k"][0][1])
    assert torch.equal(vc[1], tcache["v"][0][1])
    assert not torch.equal(kc[0], tcache["k"][0][0])


def test_decode_step_logits_over_ragged_steps():
    """Several decode steps from an empty cache with ragged lengths: the
    logits agree at every step, and so do the caches they build."""
    jcache = JM.init_cache(JCFG, 3, 16)
    tcache = TM.init_cache(CFG, 3, 16, device="cpu")
    lens = np.array([0, 3, 6], np.int32)
    rng = np.random.default_rng(8)
    for _ in range(5):
        tok = rng.integers(0, CFG.vocab, (3, 1)).astype(np.int32)
        jlog, jcache = JM.decode_step(
            JCFG, JPARAMS, jcache, jnp.asarray(tok), jnp.asarray(lens)
        )
        tlog, tcache = TM.decode_step(
            CFG, PARAMS, tcache, torch.from_numpy(tok).long(), torch.from_numpy(lens)
        )
        assert tuple(tlog.shape) == jlog.shape == (3, 1, CFG.vocab)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **BF16)
        lens = lens + 1
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), **BF16)
    np.testing.assert_allclose(_np(tcache["v"]), _np(jcache["v"]), **BF16)


def test_init_params_layout_matches_jax():
    mine = TM.init_params(CFG, 0, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(NP_PARAMS):
        t = mine
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
    w = mine["blocks"]["mlp"]["down"].float()
    # N(0, 1/d_ff) initialisation, as dense_init draws it
    assert abs(w.std().item() * CFG.d_ff**0.5 - 1.0) < 0.05


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "encdec"])
def test_unported_families_raise(family):
    cfg = dataclasses.replace(CFG, family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TM.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TM.init_cache(cfg, 1, 8, device="cpu")
