"""The port's full-sequence paths — chunked attention, ``forward`` (every
family, the audio and vision frontends), ``prefill``, ``loss_fn`` — against
the JAX package's, and the decode-vs-forward property in the port.

The JAX parameters go across through NumPy (``params_from_jax``), so both
packages compute the same function on the same inputs, drawn from a NumPy
seed.

Tolerance: bf16 results are held to 3e-2 as max |Δ| / max |ref|, the JAX
package's own bf16 tolerance (tests/test_kernels.py ``TOL``); the
decode-vs-forward property keeps the reference's own bound, 2e-2
(tests/test_models.py).  The reference is the JAX function as the JAX
package runs it (its ``lax.scan`` bodies compiled by XLA), except for the
MoE configs: there it is evaluated op by op (``jax.disable_jit()``),
because XLA's fused rounding flips near-tied router choices under the
capacity limit — the JAX package's own compiled and op-by-op
phi3.5-moe smoke logits differ by 0.097 of their largest value, three
times the band.  Op by op, the port reproduces the JAX forward of every
smoke config to within an ulp.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
from repro.models import layers as JL
from repro.models import model as JM
import repro_torch.configs as PC
from repro_torch._tree import leaves, tree_map
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

TOL = 3e-2  # bf16, max |Δ| / max |ref|
DECODE_TOL = 2e-2  # tests/test_models.py::test_decode_matches_forward
ARCHS = JC.list_archs()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(mine, ref) -> float:
    a, b = _np(mine), _np(ref)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _pair(a: np.ndarray, bf16: bool = True):
    if bf16:
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def _params(arch: str, seed: int = 0):
    """The JAX smoke parameters and their copy in the port."""
    tree = JM.init_params(JC.get(arch).smoke, jax.random.key(seed))
    arrays = jax.tree.map(np.asarray, tree)
    return jax.tree.map(jnp.asarray, arrays), params_from_jax(arrays, device="cpu")


def _inputs(cfg, seed: int, B: int = 2, S: int = 12):
    """Tokens and the frontend stub of ``cfg``, as JAX and torch kwargs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jkw, tkw = {}, {}
    stub = {"audio": ("frames", cfg.enc_seq), "vision": ("patches", cfg.n_patches)}
    if cfg.frontend in stub:
        name, n = stub[cfg.frontend]
        x = (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(np.float32)
        jkw[name], tkw[name] = jnp.asarray(x), torch.from_numpy(x)
    return (jnp.asarray(toks), jkw), (torch.from_numpy(toks), tkw)


def _reference(fn):
    """``fn()`` as the reference evaluates it (see the module docstring)."""

    def run(arch):
        if JC.get(arch).smoke.family == "moe":
            with jax.disable_jit():
                return fn()
        return fn()

    return run


@functools.lru_cache(maxsize=None)
def _jax_forward(arch: str):
    """The JAX forward's normed hidden states, and its logits (the hidden
    states through ``lm_head``, the forward's last operation)."""
    jp, _ = _params(arch)
    (toks, kw), _ = _inputs(JC.get(arch).smoke, 1)
    hidden = _reference(
        lambda: JM.forward(JC.get(arch).smoke, jp, toks, return_hidden=True, **kw)
    )(arch)
    return hidden, hidden @ jp["lm_head"]


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

# (causal, window, Sk): S = 24 over chunks of 8; Sk = 21 pads the last chunk
ATTN_CASES = {
    "causal": (True, None, 24),
    "window": (True, 10, 24),
    "bidirectional": (False, None, 24),
    "padded_causal": (True, None, 21),
    "padded_window": (True, 6, 21),
    "padded_bidirectional": (False, None, 21),
}


@pytest.mark.parametrize(
    "q_chunks,bf16", [(1, True), (3, True), (4, True), (1, False)], ids=str
)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_jax(case, q_chunks, bf16):
    """Every mask over 3 KV chunks of 8, with q_chunks 3 (Q blocks on chunk
    boundaries) and 4 (blocks of 6 across them), so the static ranges skip
    the chunks past a block's end, before its window, and the mask below
    its diagonal; f32 inputs too (the PV product still runs in bf16)."""
    causal, window, S = ATTN_CASES[case]
    rng = np.random.default_rng(30)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, S, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, bf16) for a in (q, k, v))
    args = (causal, window, 8, q_chunks)
    ref = JL._chunked_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), *args)
    tpos = torch.from_numpy(pos.copy())
    out = TL._chunked_attention(tq, tk, tv, tpos, tpos, *args)
    assert out.dtype == tq.dtype
    assert _rel(out, ref) < TOL
    one = TL._chunked_attention(tq, tk, tv, tpos, tpos, causal, window, 8, 1)
    np.testing.assert_allclose(_np(out), _np(one), rtol=1e-6, atol=1e-6)


def _attn_params(seed: int, cfg: TL.AttnConfig):
    p = JL.init_attention(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    if cfg.qkv_bias:  # non-zero biases (the init has zeros)
        for name in ("bq", "bk", "bv"):
            p[name] = jnp.asarray(rng.standard_normal(p[name].shape).astype(np.float32))
    leaves = jax.tree.map(np.asarray, p)
    return jax.tree.map(jnp.asarray, leaves), params_from_jax(leaves, device="cpu")


def _attn_cfgs(**kw):
    cfg = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, chunk=8, **kw)
    return JL.AttnConfig(**cfg), TL.AttnConfig(**cfg)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"window": 5, "q_chunks": 2},
        {"qkv_bias": True, "use_rope": False},
        {"causal": False},
    ],
    ids=["rope", "window_qchunks", "bias_norope", "bidirectional"],
)
def test_attention_matches_jax(kw):
    jcfg, tcfg = _attn_cfgs(**kw)
    jp, tp = _attn_params(31, jcfg)
    x = np.random.default_rng(32).standard_normal((2, 20, 64)).astype(np.float32)
    jx, tx = _pair(x)
    out = TL.attention(tp, tcfg, tx)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 20, 64)
    assert _rel(out, JL.attention(jp, jcfg, jx)) < TOL


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_cross_attention_matches_jax(qkv_bias):
    jcfg, tcfg = _attn_cfgs(qkv_bias=qkv_bias, use_rope=False)
    jp, tp = _attn_params(33, jcfg)
    rng = np.random.default_rng(34)
    jx, tx = _pair(rng.standard_normal((2, 9, 64)).astype(np.float32))
    jm, tm = _pair(rng.standard_normal((2, 19, 64)).astype(np.float32))
    ref = JL.cross_attention(jp, jcfg, jx, jm)
    assert _rel(TL.cross_attention(tp, tcfg, tx, tm), ref) < TOL


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_matches_jax_and_leaves_the_cache(window):
    jcfg, tcfg = _attn_cfgs(window=window)
    jp, tp = _attn_params(35, jcfg)
    rng = np.random.default_rng(36)
    jx, tx = _pair(rng.standard_normal((3, 1, 64)).astype(np.float32))
    kc, vc = rng.standard_normal((2, 3, 12, 2, 16)).astype(np.float32)
    (jk, tk), (jv, tv) = _pair(kc), _pair(vc)
    lens = np.array([0, 5, 11], np.int32)
    before = tk.clone()
    out, nk, nv = TL.decode_attention(tp, tcfg, tx, tk, tv, torch.from_numpy(lens))
    ref, rk, rv = JL.decode_attention(jp, jcfg, jx, jk, jv, jnp.asarray(lens))
    assert _rel(out, ref) < TOL
    assert _rel(nk, rk) < TOL and _rel(nv, rv) < TOL
    assert torch.equal(tk, before)  # the caches passed in are not written
    rows, idx = torch.arange(3), torch.from_numpy(lens).long()
    expect = tk.clone()
    expect[rows, idx] = nk[rows, idx]
    assert torch.equal(nk, expect)  # the new caches differ at the new slot only
    with pytest.raises(ValueError, match="single new token"):
        two = tx.expand(3, 2, 64)
        TL.decode_attention(tp, tcfg, two, tk, tv, torch.from_numpy(lens))


# ---------------------------------------------------------------------------
# forward, prefill and loss_fn, every smoke config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, remat):
    """Logits and the normed hidden states, with autograd recording so that
    ``remat`` really rematerialises each layer and each attention chunk;
    remat on and off give the same logits and the same gradients."""
    cfg = dataclasses.replace(PC.get(arch).smoke, remat=remat)
    _, tp = _params(arch)
    _, (toks, kw) = _inputs(cfg, 1)
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    logits = TM.forward(cfg, live, toks, **kw)
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 12, cfg.vocab)
    ref_hidden, ref_logits = _jax_forward(arch)
    assert _rel(logits, ref_logits) < TOL
    with torch.no_grad():
        hidden = TM.forward(cfg, tp, toks, return_hidden=True, **kw)
    assert hidden.shape == (2, 12, cfg.d_model)
    assert _rel(hidden, ref_hidden) < TOL
    grads = torch.autograd.grad(logits.float().square().mean(), leaves(live))
    other = dataclasses.replace(cfg, remat=not remat)
    live2 = tree_map(lambda t: t.detach().requires_grad_(), tp)
    logits2 = TM.forward(other, live2, toks, **kw)
    assert torch.equal(logits, logits2)
    grads2 = torch.autograd.grad(logits2.float().square().mean(), leaves(live2))
    for g, g2 in zip(grads, grads2, strict=True):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-26b", "whisper-small"])
def test_prefill_matches_jax(arch):
    cfg = PC.get(arch).smoke
    jp, tp = _params(arch)
    (jt, jkw), (tt, tkw) = _inputs(cfg, 2)
    with torch.no_grad():
        out = TM.prefill(cfg, tp, tt, **tkw)
    assert out.shape == (2, 1, cfg.vocab)
    assert _rel(out, JM.prefill(JC.get(arch).smoke, jp, jt, **jkw)) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    cfg, jcfg = PC.get(arch).smoke, JC.get(arch).smoke
    jp, tp = _params(arch)
    (jt, jkw), (tt, tkw) = _inputs(cfg, 3)
    labels = np.random.default_rng(4).integers(0, cfg.vocab, tt.shape).astype(np.int32)
    jbatch = {"tokens": jt, "labels": jnp.asarray(labels), **jkw}
    ref = _reference(lambda: JM.loss_fn(jcfg, jp, jbatch))(arch)
    with torch.no_grad():
        tbatch = {"tokens": tt, "labels": torch.from_numpy(labels), **tkw}
        loss = TM.loss_fn(cfg, tp, tbatch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - float(ref)) < TOL * abs(float(ref))


def test_forward_needs_its_frontend_input():
    for arch, name in (("internvl2-26b", "patches"), ("whisper-small", "frames")):
        _, tp = _params(arch)
        with pytest.raises(ValueError, match=name):
            TM.forward(PC.get(arch).smoke, tp, torch.zeros((1, 4), dtype=torch.long))


def test_encoder_matches_jax():
    cfg = PC.get("whisper-small").smoke
    jp, tp = _params("whisper-small")
    f = np.random.default_rng(5).standard_normal((2, cfg.enc_seq, cfg.d_model)) * 0.5
    jf, tf = _pair(f.astype(np.float32), bf16=False)
    with torch.no_grad():
        mem = TM._encode(cfg, tp, tf)
    assert _rel(mem, JM._encode(JC.get("whisper-small").smoke, jp, jf)) < TOL


# ---------------------------------------------------------------------------
# decode reproduces forward, in the port (tests/test_models.py's property)
# ---------------------------------------------------------------------------


def _fill_cross_cache(cfg, params, cache, frames):
    """The encoder's output projected by each decoder layer's cross
    attention into the cache (tests/test_models.py ``_fill_cross_cache``;
    ``DecodeSession`` leaves the cross KV zero in both packages)."""
    B = frames.shape[0]
    mem = TM._encode(cfg, params, frames)
    shape = (B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    for i, bp in enumerate(TM._unstack(params["dec_blocks"], cfg.n_layers)):
        kk = (mem @ bp["cross"]["wk"]).reshape(shape)
        vv = (mem @ bp["cross"]["wv"]).reshape(shape)
        if cfg.qkv_bias:
            kk = kk + bp["cross"]["bk"].to(kk.dtype).reshape(shape[2:])
            vv = vv + bp["cross"]["bv"].to(vv.dtype).reshape(shape[2:])
        cache["cross_k"][i] = kk.to(cache["cross_k"].dtype)
        cache["cross_v"][i] = vv.to(cache["cross_v"].dtype)
    return cache


@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full-sequence forward logits
    (ring buffer, SSM state, RoPE positions, cross-attention freezing).
    MoE runs at capacity factor 8, so no token is dropped; the vision
    backbone runs without its patch prefix, which decode does not take."""
    cfg = PC.get(arch).smoke
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if cfg.frontend == "vision":
        cfg = dataclasses.replace(cfg, frontend="none")
    params = TM.init_params(cfg, 42, device="cpu")
    _, (toks, kw) = _inputs(cfg, 6, S=12)
    full = TM.forward(cfg, params, toks, **kw)
    cache = TM.init_cache(cfg, 2, 16, device="cpu")
    if cfg.family == "encdec":
        cache = _fill_cross_cache(cfg, params, cache, kw["frames"])
    clen = torch.zeros(2, dtype=torch.int32)
    outs = []
    for i in range(12):
        lg, cache = TM.decode_step(cfg, params, cache, toks[:, i : i + 1], clen)
        clen = clen + 1
        outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1), full) < DECODE_TOL, arch
