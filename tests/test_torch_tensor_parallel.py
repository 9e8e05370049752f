"""Tensor-parallel compute over "model" in the port — the heads, ff
columns, vocab, experts and lru channels split over "model"
(``distributed.sharding.lend_params``, ``models.*``), the decode cache
split over its sequence, and the params drawn and placed leaf by leaf
(``training.train_loop.init_params_sharded``) — against the JAX package.

The multi-rank parts run over gloo in four child processes per mesh
layout, (data=2, model=2) and (data=1, model=4); one module fixture per
layout starts them, and its cases read what they wrote.  The JAX
references run in one child beside them, unsharded: the reference's
GSPMD step does not trace on this JAX version (its ``jitted`` form raises
``ShardingTypeError`` at the embedding gather), so each tensor-parallel
result is held against the JAX function on the global inputs — the
train step and ``loss_and_grads`` under ``jax.jit``, ``decode_step`` op
by op (``jax.disable_jit()``, as tests/test_torch_families.py holds the
decode step), ``prefill`` under ``jax.jit``.  Every child is joined with
a time limit.

The five smoke configs exercise each split: llama3.2-3b (4 heads, 2 kv
heads: at model=4 the heads split and the kv projection is whole, each
rank reading the kv head of its query head), phi3.5-moe (4 experts over
"model", the router whole), recurrentgemma-2b (lru channels split, MQA
local attention over a ring window that wraps), whisper-small (encoder,
self and cross attention, qkv biases) and mamba2-780m (8 SSD heads, a
run of them a rank: in_proj and the conv read in parts, out_proj split);
and a sixth, llama3.2-3b's smoke config with 6 heads and 2 kv heads
(``H6``, built by ``dataclasses.replace`` in both packages): at model=4
that is 1.5 heads and half a kv head a rank, so the full-sequence paths
give each rank its run of whole heads (1 or 2) read from the gathered
weights, and the decode step projects on the placed columns.

A group of one rank issues nothing: at (1, 1) on a one-process gloo
group the sharded step and decode are the one-device ones bit for bit,
and in the dry run's fake group no collective runs over an axis of one.

Tolerances, each stated where it is used:

* losses, gradient norms, logits and caches: 3e-2 (the JAX package's
  bf16 ``TOL``, tests/test_kernels.py) as max |Δ| / max |ref|;
* the train step leaf by leaf — every gradient leaf of the first step,
  AdamW's moments after two steps — at 3e-2 (``_state_tol`` of
  tests/test_torch_placement.py for the moments: 6e-2 for the second),
  twice: against the port's one-device step from the same state and
  batch, which leaves only what the split changes, for every config; and
  against the reference where its jitted gradients and the port's
  one-device ones agree leaf by leaf within 3e-2 (``LEAF_REF``: XLA fuses
  bf16 chains and rounds their intermediates otherwise, by up to 5.3 % on
  recurrentgemma-2b's gate biases and 4.1 % on whisper-small's query
  biases).  The one-device comparison is made in each leaf's norm,
  ‖Δ‖ / ‖ref‖, and raised for a leaf to how far rounding alone moves it
  where that is further (the leaf's ``band``: the most three random
  one-ulp changes of the embedding table move its one-device gradient,
  twice that for the second moment).  recurrentgemma-2b's gradients are
  ill-conditioned in bf16 at this size: one such change moves its RG-LRU
  gate biases, which sum many cancelling terms, by up to 4 % in that norm
  and 9.6 % in the max norm, as far as the split does;
* the params and f32 masters after two steps: each element within the
  larger of ``_state_tol`` of its leaf's largest and
  ``_sign_step_bound``.  AdamW moves an element by about ``lr · sign(g)``
  whatever the gradient's size (tests/test_torch_training.py), so where
  a leaf's values are within a few ``lr`` of zero (the biases, ``A_log``,
  ``dt_bias``, the position tables) they are the signs of its gradient,
  and the rounding of either run flips those of its small elements;
* the key biases' gradient is zero in exact arithmetic (a bias on every
  key shifts all of a query's scores alike, which the softmax ignores):
  it is held below 3e-2 of its layer's gradients in both runs, its
  values as above, and its moments, rounding alone, not at all;
* init leaf by leaf: ``==``.

Routing (phi3.5-moe): top-k routing is discontinuous, and a token whose
k-th and (k+1)-th router probabilities lie within the bf16 band of each
other is routed by rounding alone — the tensor-parallel sums round
otherwise than one device's, so such a token may go to another expert,
which moves its layer's gradients by far more than 3e-2 (on this batch at
(1, 4) one token of 128 does, and moves them by up to 30 %).  The margin
rule of tests/test_torch_families.py, applied to routing: the reference's
jitted train functions report their routing as they run
(``jax.debug.callback``), and the port's train runs take the reference's
routing, token for token, so the two compute the same function; the
tokens the port would route otherwise
on its own are counted, and each must lie within the band of a tie
(``ROUTE_BAND``).
"""

import contextlib
import dataclasses
import math
import os
import pickle
import socket
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
BF16_TOL = 3e-2
JOIN_S = 120  # each child's time limit
H6 = "llama3.2-3b-h6"  # llama3.2-3b's smoke config with 6 heads (see above)
ARCHS = (
    "llama3.2-3b",
    "phi3.5-moe-42b-a6.6b",
    "recurrentgemma-2b",
    "whisper-small",
    "mamba2-780m",
    H6,
)
LAYOUTS = {"data2_model2": (2, 2), "data1_model4": (1, 4)}
PRODUCTION_ARCHS = (  # every config of the package, at full width
    *ARCHS[:5],
    "dbrx-132b",
    "deepseek-coder-33b",
    "internvl2-26b",
    "mistral-nemo-12b",
    "nemotron-4-15b",
)
BATCH, SEQ, STEPS = 8, 16, 2  # train
DB, MAX_SEQ, DSTEPS = 4, 16, 4  # decode: rows, cache length, steps
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20)
MOE = "phi3.5-moe-42b-a6.6b"
# a token routes by rounding alone where its k-th and (k+1)-th router
# probabilities differ by less than this, relative: their logits differ
# by about as much, and a bf16 ulp of the router's input (2^-8, reached
# through several roundings in either run) moves each logit by up to
# 2^-8 of the sum of its products' magnitudes
ROUTE_BAND = 2.0**-6
# the configs whose bf16 gradients the port's one-device step and the
# reference's jitted step agree on leaf by leaf within 3e-2 (see above)
LEAF_REF = ("llama3.2-3b", MOE, "mamba2-780m", H6)


def _spec(configs, arch: str):
    """The ``ArchSpec`` of ``arch`` in a package's ``configs``; ``H6``'s is
    llama3.2-3b's with 6 heads in its smoke config."""
    if arch != H6:
        return configs.get(arch)
    spec = configs.get("llama3.2-3b")
    smoke = dataclasses.replace(spec.smoke, n_heads=6, n_kv_heads=2, head_dim=16)
    return dataclasses.replace(spec, smoke=smoke)


def _smoke(configs, arch: str):
    return _spec(configs, arch).smoke


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
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _state_tol(key: str, dtype: str) -> float:
    """tests/test_torch_placement.py's bound of one trained state leaf."""
    if dtype == "bfloat16" or key.startswith("opt/m/"):
        return BF16_TOL
    return 2 * BF16_TOL


def _sign_step_bound() -> float:
    """The most one f32 master element can differ between two runs after
    ``STEPS`` AdamW steps whose gradients share nothing but their scale:
    twice the sum over the steps of ``lr_t`` times the largest
    ``|m̂_t| / sqrt(v̂_t)`` (by Cauchy-Schwarz ``sqrt(Σ_i a_i² / c_i)``, with
    ``a_i`` and ``c_i`` the moments' weights of gradient ``i``)."""
    from repro_torch.training.optimizer import OptConfig, cosine_lr

    cfg = OptConfig(**OPT)
    total = 0.0
    for t in range(1, STEPS + 1):
        steps = range(1, t + 1)
        a = [(1 - cfg.b1) * cfg.b1 ** (t - i) / (1 - cfg.b1**t) for i in steps]
        c = [(1 - cfg.b2) * cfg.b2 ** (t - i) / (1 - cfg.b2**t) for i in steps]
        ratio = math.sqrt(sum(x * x / y for x, y in zip(a, c)))
        total += float(cosine_lr(cfg, torch.tensor(t))) * ratio
    return 2 * total


def _is_key_bias(key: str) -> bool:
    return key.endswith("/bk")


# ---------------------------------------------------------------------------
# the inputs: params written by the JAX package, batches, caches, tokens
# ---------------------------------------------------------------------------


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """``a`` (f32) rounded to the nearest bf16, ties to even, back in f32."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32)


def _data(cfg, shapes: dict) -> dict:
    """The numpy inputs of one config: a train batch, a prefill batch,
    the decode cache's initial values (bf16 leaves rounded), its lengths
    and tokens."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, SEQ + 1), dtype=np.int32)
    train = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    pre = {"tokens": rng.integers(0, cfg.vocab, (DB, SEQ), dtype=np.int32)}
    if cfg.frontend == "audio":
        frames = rng.standard_normal((BATCH, cfg.enc_seq, cfg.d_model))
        train["frames"] = frames.astype(np.float32)
        pre["frames"] = train["frames"][:DB].copy()
    cache = {}
    for key, (shape, dtype) in shapes.items():
        a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        cache[key] = (_bf16_round(a) if dtype == "bfloat16" else a, dtype)
    lens = [10, 15, 20, 3] if cfg.family == "hybrid" else [0, 3, 9, 5]
    return {
        "train": train,
        "prefill": pre,
        "cache": cache,
        "lens": np.array(lens, np.int32),
        "tokens": rng.integers(0, cfg.vocab, (DSTEPS, DB, 1), dtype=np.int32),
    }


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """JAX checkpoints of the six smoke configs' params and AdamW state
    (the port restores them) and each config's numpy inputs."""
    import jax

    import repro.configs as JC
    import repro_torch.configs as PC
    from repro.models import model as JM
    from repro.training import checkpoint as JCk
    from repro.training import optimizer as JO
    from repro_torch._tree import leaves_with_path
    from repro_torch.models import model as TM

    d = tmp_path_factory.mktemp("tensor_parallel")
    data = {}
    for arch in ARCHS:
        p = JM.init_params(_smoke(JC, arch), jax.random.key(0))
        JCk.save(str(d / arch), 0, {"params": p, "opt": JO.init_opt_state(p)})
        cfg = _smoke(PC, arch)
        meta = TM.init_cache(cfg, DB, MAX_SEQ, device="meta")
        shapes = {
            "/".join(path): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in leaves_with_path(meta)
        }
        data[arch] = _data(cfg, shapes)
    with open(d / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    return d


def _start(args, env) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, HERE, *args],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


# the reference's children, side by side
JAX_PARTS = (
    (MOE,),
    ("llama3.2-3b", "whisper-small"),
    ("recurrentgemma-2b", "mamba2-780m"),
    (H6,),
)


@pytest.fixture(scope="module")
def runs(inputs):
    """Every child — the reference's and both layouts' ranks — started at
    once; ``.jax()`` and ``.layout(name)`` wait for their results."""
    jax_env = _env(JAX_PLATFORMS="cpu")
    parts = range(len(JAX_PARTS))
    procs = {"jax": [_start(["--jax", str(i), str(inputs)], jax_env) for i in parts]}
    for name in LAYOUTS:
        port = str(_free_port())
        args = lambda r: ["--port", name, str(r), port, str(inputs)]  # noqa: E731
        procs[name] = [_start(args(r), _env()) for r in range(4)]
    done: dict = {}  # the results read so far

    def read(key, files) -> list:
        if key not in done:
            _join(procs[key])
            done[key] = []
            for f in files:
                with open(inputs / f, "rb") as fh:
                    done[key].append(pickle.load(fh))
        return done[key]

    class Runs:
        def jax(self) -> dict:
            merged = {}
            for part in read("jax", [f"jax{i}.pkl" for i in range(len(JAX_PARTS))]):
                merged.update(part)
            return merged

        def layout(self, name) -> list:
            return read(name, [f"{name}_rank{r}.pkl" for r in range(4)])

    yield Runs()
    for ps in procs.values():
        for p in ps:
            p.kill()


@pytest.fixture(scope="module")
def jax_refs(runs):
    return runs.jax()


@pytest.fixture(scope="module")
def data2_model2(runs):
    return runs.layout("data2_model2")


@pytest.fixture(scope="module")
def data1_model4(runs):
    return runs.layout("data1_model4")


@pytest.fixture
def layout(request):
    return request.getfixturevalue(request.param)


def _rows(rank: dict, n: int) -> slice:
    """The batch rows of a rank: its place along "data" of ``n`` rows."""
    data, _ = rank["coord"]
    per = n // rank["data_size"]
    return slice(data * per, (data + 1) * per)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _rms_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _check_leaves(got: dict, ref: dict, rel, what, band=None) -> None:
    """Every gradient leaf of the first step and every state leaf after
    ``STEPS`` steps of ``got`` against ``ref``, the gradients and moments
    in the norm ``rel`` (each bound raised to a leaf's ``band`` where that
    is wider, twice it for the second moment); the params and masters
    each element within the larger of ``_state_tol`` of the leaf's
    largest and ``_sign_step_bound`` (see the module's docstring)."""
    band = band or {}
    for key, want in ref["grads"].items():
        if _is_key_bias(key):
            layer = key.rsplit("/", 1)[0]
            scale = max(
                np.abs(ref["grads"][f"{layer}/{w}"]).max() for w in ("wq", "wk")
            )
            for g in (got["grads"][key], want):
                assert np.abs(g).max() < BF16_TOL * scale, (what, key)
            continue
        tol = max(BF16_TOL, band.get(key, 0))
        assert rel(got["grads"][key], want) < tol, (what, key)
    bound = _sign_step_bound()
    assert sorted(got["state"]) == sorted(ref["state"])
    for key, (want, dtype) in ref["state"].items():
        mine = got["state"][key][0]
        if key.endswith("step"):
            assert np.array_equal(mine, want), key
        elif key.startswith(("params/", "opt/master/")):
            tol = max(_state_tol(key, dtype) * np.abs(want).max(), bound)
            assert np.abs(mine - want).max() <= tol, (what, key)
        elif not _is_key_bias(key):  # the key biases' moments: rounding alone
            path = key.split("/", 2)[2]
            spread = band.get(path, 0) * (2 if key.startswith("opt/v/") else 1)
            assert rel(mine, want) < max(_state_tol(key, dtype), spread), (what, key)


@pytest.fixture(scope="module")
def one_rank(runs):
    """Every config on a one-process gloo group and a (data=1, model=1)
    mesh over it, in this process while the children run (one mesh for
    all: DTensor caches the meshes of the specs it has propagated, so a
    mesh made anew in the same process would meet its predecessor), each
    against the one-device port: ``{arch: {what: bit-equal}}`` and the
    collectives counted."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one core, as each child has
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1
    )
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        return {arch: _one_rank_run(arch, mesh) for arch in ARCHS}
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def _one_rank_run(arch: str, mesh) -> dict:
    """Two sharded train steps and ``loss_and_grads`` lent by
    ``lend_params``, then two sharded decode steps, each beside the
    one-device port from the same draw, batch and cache."""
    import repro_torch.configs as PC
    from repro_torch._tree import leaves, tree_map
    from repro_torch.distributed import sharding as TS
    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import sharded_decode_fn
    from repro_torch.models import model as TM
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    cfg = _smoke(PC, arch)
    one = _mesh((1, 1), ("data", "model"), "cpu")
    train = TT.TrainConfig(opt=TO.OptConfig(**OPT))
    p1, o1 = TT.init_sharded(cfg, one, seed=2)
    p2, o2 = TT.init_sharded(cfg, mesh, seed=2)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (DB, SEQ + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn(DB, cfg.enc_seq, cfg.d_model, generator=gen)
    p_sh = TS.params_shardings(p1, mesh)
    out = {}
    with count_collectives() as log:
        _, g1 = TT.loss_and_grads(cfg, p1, batch)
        lend = lambda live: TS.lend_params(live, p_sh, cfg)  # noqa: E731
        _, g2 = TT.loss_and_grads(cfg, TS.locals_of(p2, p_sh), batch, lend=lend)
        out["grads"] = same(g1, g2)
        s1, _ = TT.make_train_step(cfg, one, train)
        s2, _ = TT.make_train_step(cfg, mesh, train)
        metrics = []
        for _ in range(STEPS):
            p1, o1, m1 = s1(p1, o1, batch)
            p2, o2, m2 = s2(p2, o2, batch)
            metrics += [torch.equal(m1[k], m2[k]) for k in ("loss", "grad_norm")]
        out["losses"] = all(metrics)
        o_sh = TT.opt_shardings(p1, mesh)
        local = TS.locals_of({"p": p2, "o": o2}, {"p": p_sh, "o": o_sh})
        out["state"] = same({"p": p1, "o": o1}, local)
        cache = TM.init_cache(cfg, DB, MAX_SEQ, device="cpu")
        for t in leaves(cache):
            t.normal_(generator=gen)
        c_sh = TS.cache_shardings(cache, mesh)
        local_c = tree_map(lambda t: t.clone(), TS.locals_of(cache, c_sh))
        fn = sharded_decode_fn(cfg, p_sh, c_sh)
        lens = torch.tensor([0, 3, 9, 5], dtype=torch.int32)
        logits = []
        with torch.no_grad():
            for _ in range(2):
                tok = torch.randint(0, cfg.vocab, (DB, 1), generator=gen)
                want, _ = TM.decode_step(cfg, p1, cache, tok, lens)
                got, local_c = fn(local["p"], local_c, tok, lens)
                logits.append(torch.equal(got, want))
                lens = lens + 1
        out["logits"] = all(logits)
        out["cache"] = same(local_c, cache)
    out["collectives"] = (dict(log), dict(log.groups))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_one_device_step_bit_for_bit(arch, one_rank):
    """On a group of one rank nothing is issued and nothing is lent split
    (``count_collectives`` stays empty), so the sharded paths are the
    one-device arithmetic: ``loss_and_grads`` lent by ``lend_params`` its
    gradients, two sharded train steps (``make_train_step`` on DTensor
    state) its losses, gradient norms, params and AdamW state, and two
    sharded decode steps on a cache placed by its specs its logits and
    cache, all bit for bit (``==``)."""
    got = one_rank[arch]
    assert got.pop("collectives") == ({}, {})
    assert all(got.values()), got


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(layout, arch, jax_refs, request):
    """Two tensor-parallel train steps on four ranks against the
    reference's step jitted without shardings on the global batch: the
    loss and gradient norm of each step; then every gradient leaf of the
    first step (the ranks' shards joined) and the params and AdamW state
    after the two: against the reference's where its gradients agree with
    the port's one-device step leaf by leaf (``LEAF_REF``), and against
    the port's one-device step from the same state and batch for every
    config, which leaves only what the split changes."""
    name = request.node.callspec.params["layout"]
    ref = jax_refs[arch]
    got = layout[0][arch]
    for rank in layout:  # tokens the port alone routes otherwise: near ties
        assert all(m < ROUTE_BAND for m in rank[arch]["flipped_margins"]), arch
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            assert _rel(got[key][i], ref[key][i]) < BF16_TOL, (name, key, i)
    for rank in layout[1:]:  # every rank reports the same numbers
        assert rank[arch]["loss"] == got["loss"]
    one = got["one_device"]
    _check_leaves(got, one, _rms_rel, (name, "one device"), one["band"])
    if arch in LEAF_REF:
        _check_leaves(got, ref, _rel, (name, "reference"))


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_sequence_split_cache_matches_jax(layout, arch, jax_refs):
    """``DSTEPS`` steps of ``sharded_decode_fn`` on a cache whose KV
    sequence is split over "model" (and its rows over "data"), from the
    same random cache and ragged lengths as the reference's ``decode_step``
    op by op: each rank's rows' whole-vocab logits at every step within
    3e-2, and the ranks' cache shards, joined by their specs, within 3e-2
    of the reference's cache.  The hybrid's rows start at 10-20 tokens,
    so its ring window of 16 wraps."""
    ref = jax_refs[arch]["decode"]
    joined = {k: np.full(v.shape, np.nan, np.float32) for k, v in ref["cache"].items()}
    for rank in layout:
        got = rank[arch]["decode"]
        rows = _rows(rank, DB)
        for i in range(DSTEPS):
            assert _rel(got["logits"][i], ref["logits"][i][rows]) < BF16_TOL, (arch, i)
        for key, (idx, part) in got["cache"].items():
            joined[key][idx] = part
    split = [rank[arch]["decode"]["split"] for rank in layout]
    assert all(split) == (arch != "mamba2-780m")  # a KV cache's sequence split
    for key, want in ref["cache"].items():
        assert not np.isnan(joined[key]).any(), key
        assert _rel(joined[key], want) < BF16_TOL, (arch, key)


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(layout, arch, jax_refs):
    """``sharded_prefill_fn``: each rank's rows' last-position logits,
    whole over the vocab, within 3e-2 of the reference's jitted
    ``prefill``."""
    ref = jax_refs[arch]["prefill"]
    for rank in layout:
        got = rank[arch]["prefill"]
        assert got.shape[-1] == ref.shape[-1]
        assert _rel(got, ref[_rows(rank, DB)]) < BF16_TOL, arch


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
def test_init_leaf_by_leaf_is_the_whole_draw(layout):
    """``init_sharded`` draws and places the params leaf by leaf: every
    rank's shard of every leaf of the six configs equals, bit for bit,
    its shard of the tree drawn whole and placed at once; the optimizer
    state is built from the placed shards."""
    for rank in layout:
        for arch in ARCHS:
            assert rank[arch]["init"] == "bit-equal", (arch, rank["coord"])


@pytest.mark.parametrize("layout", list(LAYOUTS), indirect=True)
def test_live_rows_on_a_split_cache_match_one_device(layout):
    """A decode step with dead rows on the sequence-split cache: logits and
    cache as the port's one-device ``decode_step`` with the same ``live``
    (the reference's ``decode_step`` has no ``live``), within 3e-2; the
    dead rows' cache slots bit for bit as they were."""
    for rank in layout:
        for arch in ARCHS:
            got = rank[arch]["live"]
            assert got["logits"] < BF16_TOL and got["cache"] < BF16_TOL, arch
            assert got["dead_rows_kept"], arch


# ---------------------------------------------------------------------------
# the division of the work, in the dry run's fake group (no children)
# ---------------------------------------------------------------------------


def _lowerable(arch: str, cell: str, shape, axes=("data", "model")):
    import repro_torch.configs as PC
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import build_lowerable

    mesh = _mesh(shape, axes, "meta")
    return build_lowerable(_spec(PC, arch), cell, mesh, reduced=True)


def _matmul_flops(fn, args) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def test_rank_does_half_the_matrix_products_at_model2():
    """The train steps of llama3.2-3b's, mamba2-780m's and ``H6``'s smoke
    configs at (data=1, model=2), each run as rank 0 of a fake group: its
    matrix-product FLOPs (forward, remat and backward;
    ``torch.utils.flop_counter``) are 0.5 ± 0.05 of the one-device step's.
    mamba2-780m's rank comes to 0.549: its SSD heads split, but the C·B
    product that every head shares (n_groups = 1) is computed whole on
    every rank, and at this size (8 heads of 16, d_state 16, one chunk of
    256) that is a tenth of the step."""
    from repro_torch.launch.steps import _fake_group

    for arch in ("llama3.2-3b", "mamba2-780m", H6):
        low = _lowerable(arch, "train_4k", (1, 2))
        whole = low.lower().flops
        with _fake_group(low.mesh) as mesh:
            fn, args, _ = low.sharded(mesh)
            rank = _matmul_flops(fn, args)
        assert abs(rank / whole - 0.5) <= 0.05, (arch, rank, whole)


@pytest.mark.parametrize(
    "arch, over_model",
    [
        ("llama3.2-3b", False),
        ("phi3.5-moe-42b-a6.6b", True),
        ("mamba2-780m", True),
        (H6, False),
    ],
)
def test_no_split_leaf_is_gathered_over_model(arch, over_model):
    """The train step at (data=1, model=2) in a fake group: llama's leaves
    (and ``H6``'s, whose 6 heads split 3 a rank) are all computed on their
    split, so nothing is all-gathered over "model"; phi3.5-moe gathers only
    its router and mamba2 only the SSD block's packed ``in_proj`` and its
    conv, which it reads in parts: checked leaf by leaf on the lent plans."""
    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.launch.steps import _fake_group

    low = _lowerable(arch, "train_4k", (1, 2))
    with _fake_group(low.mesh) as mesh:
        fn, args, _ = low.sharded(mesh)
        with count_collectives() as log, torch.no_grad():
            fn(*args)
        seen = log.by_axis(mesh, ("all-gather",))
        whole = _leaves_gathered_over_model(arch, mesh)
    assert ("model" in seen) == over_model and "data" not in seen, seen
    if arch == "phi3.5-moe-42b-a6.6b":
        assert whole == {"blocks/moe/router"}
    elif arch == "mamba2-780m":
        assert whole == {"blocks/ssd/in_proj", "blocks/ssd/conv/w", "blocks/ssd/conv/b"}
    else:
        assert not whole


def _leaves_gathered_over_model(arch, mesh) -> set:
    """The params whose plans gather over "model", by path."""
    import repro_torch.configs as PC
    from repro_torch._tree import leaves_with_path
    from repro_torch.distributed.sharding import ShardedStack, params_shardings
    from repro_torch.models.model import init_params

    cfg = _smoke(PC, arch)
    shapes = init_params(cfg, device="meta")
    sh = params_shardings(shapes, mesh)
    group = mesh.group("model")
    out = set()
    for k in ("blocks",):  # the stacked layers of these configs
        stack = ShardedStack(shapes[k], sh[k], cfg)
        for path, plan in leaves_with_path(stack.plans):
            if any(g is group for _, g in plan.gather):
                out.add("/".join((k,) + path))
    return out


AXIS_OF_ONE = {"data1_model4": ((1, 4), ("data", "model"), "data"),
               "pod2_data2": ((2, 2, 1), ("pod", "data", "model"), "model")}


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m", H6])
@pytest.mark.parametrize("mesh_name", list(AXIS_OF_ONE))
def test_nothing_runs_over_an_axis_of_one(mesh_name, arch, cell):
    """As GSPMD: rank 0 of a fake group issues no collective over an axis
    of one rank: none over "data" at (data=1, model=4) and none over
    "model" at (pod=2, data=2, model=1); a train step uses every other
    axis."""
    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.launch.steps import _fake_group

    shape, axes, one = AXIS_OF_ONE[mesh_name]
    low = _lowerable(arch, cell, shape, axes)
    with _fake_group(low.mesh) as mesh:
        fn, args, _ = low.sharded(mesh)
        with count_collectives() as log, torch.no_grad():
            fn(*args)
        seen = log.by_axis(mesh)
    assert one not in seen and "?" not in seen, seen
    if cell == "train_4k":  # the gradients reduce over every other axis
        assert all(a in seen for a, n in zip(axes, shape) if n > 1), seen


@pytest.mark.parametrize("arch", PRODUCTION_ARCHS)
def test_model_use_at_the_production_width(arch):
    """On the 16×16 production mesh every leaf split over "model" is
    computed on its split but the leaves read in parts (gathered over
    "model" and read by the rank's share of the work, ``model_use``
    "part"), each by the rule of ``distributed.sharding.model_use``: the
    router; the SSD block's packed ``in_proj`` and its conv (mamba2-780m's
    ``out_proj`` rows, 3 of its 48 heads a rank, are split); and in the
    full-sequence paths attention's weights where 16 does not divide the
    heads (llama3.2-3b's 24, recurrentgemma-2b's 10, whisper-small's 12,
    deepseek-coder-33b's 56) and its kv projection where the heads divide
    but the kv heads do not (the 8 kv heads of phi3.5-moe and the other
    32- and 48-head configs).  The decode step computes every attention
    weight on its placed columns but the kv projection of the latter."""
    import repro_torch.configs as PC
    from repro_torch._tree import leaves_with_path
    from repro_torch.configs.base import params_spec
    from repro_torch.distributed import sharding as TS
    from repro_torch.launch.mesh import make_production_mesh

    cfg = PC.get(arch).model
    mesh = make_production_mesh(device="meta")
    shs = TS.params_shardings(params_spec(cfg), mesh)
    heads_split = cfg.n_heads and cfg.n_heads % 16 == 0
    for decode in (False, True):
        for key, sh, plan in _production_plans(TS, shs, cfg, decode, leaves_with_path):
            if not any(TS._on_model(sh, d) for d in range(len(sh.spec))):
                continue
            over_model = len(plan.gather) > sum(
                1 for e in sh.spec for a in TS.spec_axes(e) if a != "model"
            )
            name = key.rsplit("/", 1)[-1]
            attn = "/attn/" in key or "/cross/" in key
            if name == "router" or ("/ssd/" in key and name != "out_proj"):
                expect = True
            elif attn and name in ("wk", "wv", "bk", "bv") and heads_split:
                expect = cfg.n_kv_heads % 16 != 0
            elif attn:
                expect = not heads_split and not decode
            else:
                expect = False
            assert over_model == expect, (arch, key, sh.spec, decode)


def _production_plans(TS, shs, cfg, decode, leaves_with_path):
    """(path, sharding, plan) of every leaf as ``lend_params`` plans it."""
    for k, v in shs.items():
        skip = 1 if k.startswith(TS._STACKED_PREFIXES) else 0
        tree, _ = TS._plans(v, cfg, skip, path=(k,), decode=decode)
        if not isinstance(tree, dict):
            tree = {"": tree}
        for path, sh in leaves_with_path(v if isinstance(v, dict) else {"": v}):
            yield "/".join((k,) + path).rstrip("/"), sh, _at(tree, path)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_dryrun_decode_reads_the_sequence_split_cache():
    """llama3.2-3b decode_32k on 16×16: rank 0's run reads a cache split
    over its sequence (S/16 positions) as ``arg_bytes`` counts it, holds
    fewer temp bytes than the FSDP run of the dry run before tensor
    parallelism (34.07 GB), and moves under 1.0 GB of collectives: its
    attention projects on the placed columns (1.5 of the 24 heads a rank)
    and gathers no weight over "model" (the run that gathered attention's
    matrices whole moved 1.87 GB)."""
    import repro_torch.configs as PC
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import _fake_group, build_lowerable

    mesh = make_production_mesh(device="meta")
    low = build_lowerable(PC.get("llama3.2-3b"), "decode_32k", mesh)
    with _fake_group(mesh) as m:
        _, args, _ = low.sharded(m)
    k = low.args[1]["k"]
    assert args[1]["k"].shape[2] * 16 == k.shape[2]
    assert args[1]["k"].shape[1] * 16 == k.shape[1]
    part = low.partition()
    assert part.collective_bytes < 1.0e9 and part.temp_bytes < 34.07e9, part


# ---------------------------------------------------------------------------
# the children
# ---------------------------------------------------------------------------


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def jax_child(part: int, d: str) -> None:
    """The references the cases read of the configs of ``JAX_PARTS[part]``,
    each config unsharded."""
    import jax
    import jax.numpy as jnp

    import repro.configs as JC
    from repro.models import model as JM
    from repro.training import checkpoint as JCk
    from repro.training import optimizer as JO
    from repro.training import train_loop as JT
    from jax.sharding import Mesh as JMesh

    with open(os.path.join(d, "data.pkl"), "rb") as f:
        data = pickle.load(f)
    copy = lambda t: jax.tree.map(lambda x: jnp.array(x, copy=True), t)  # noqa: E731
    one = JMesh(np.array(jax.devices()[:1]), ("data",))
    out = {}
    for arch in JAX_PARTS[part]:
        cfg = _smoke(JC, arch)
        p = JM.init_params(cfg, jax.random.key(0))
        like = {"params": p, "opt": JO.init_opt_state(p)}
        st = copy(JCk.restore(os.path.join(d, arch), 0, like))
        dat = data[arch]
        batch = {k: jnp.asarray(v) for k, v in dat["train"].items()}
        rec: dict = {"loss": [], "grad_norm": []}
        routing = {"grads": None, "steps": []}
        with _routing_spy(jax, cfg) as taken:
            _, grads = jax.jit(lambda p_, b_: JT.loss_and_grads(cfg, p_, b_))(
                st["params"], batch
            )
            routing["grads"] = taken()
            train = JT.TrainConfig(opt=JO.OptConfig(**OPT))
            step = jax.jit(JT.make_train_step(cfg, one, train)[0])
            params, opt = st["params"], st["opt"]
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                routing["steps"].append(taken())
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
        rec["grads"] = {
            _key(path): _f32(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)
        }
        if arch == MOE:  # for the port's children, which wait for it
            with open(os.path.join(d, "routing.tmp"), "wb") as f:
                pickle.dump(routing, f)
            os.replace(os.path.join(d, "routing.tmp"), os.path.join(d, "routing.pkl"))
        rec["state"] = {}
        for name, tree in (("params", params), ("opt", opt)):
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                rec["state"][f"{name}/{_key(path)}"] = (
                    _f32(leaf), np.asarray(leaf).dtype.name
                )
        pre = {k: jnp.asarray(v) for k, v in dat["prefill"].items()}
        rec["prefill"] = _f32(
            jax.jit(lambda p_, b_: JM.prefill(cfg, p_, b_["tokens"], b_.get("frames")))(
                st["params"], pre
            )
        )
        cache = {}
        for key, (a, dtype) in dat["cache"].items():
            node = cache
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)
        lens = jnp.asarray(dat["lens"])
        logits = []
        with jax.disable_jit():
            for i in range(DSTEPS):
                tok = jnp.asarray(dat["tokens"][i])
                lg, cache = JM.decode_step(cfg, st["params"], cache, tok, lens)
                logits.append(_f32(lg))
                lens = lens + 1
        rec["decode"] = {
            "logits": logits,
            "cache": {
                _key(path): _f32(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(cache)
            },
        }
        out[arch] = rec
    with open(os.path.join(d, f"jax{part}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _wait_for(path: str):
    """The pickle at ``path``, once the reference's child has written it."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < JOIN_S, f"{path} never came"
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


@contextlib.contextmanager
def _routing_spy(jax, cfg):
    """Inside the block every function the reference traces reports its
    MoE routing as it runs (a ``jax.debug.callback`` beside each
    ``top_k``): ``taken()`` gives the forward pass's [(probabilities,
    expert ids)] a layer of the last call (a remat recomputes them in the
    backward pass after these) and clears the record."""
    real, seen = jax.lax.top_k, []

    def spy(probs, k):
        vals, ids = real(probs, k)
        keep = lambda p, i: seen.append((np.asarray(p), np.asarray(i)))  # noqa: E731
        jax.debug.callback(keep, probs, ids, ordered=True)
        return vals, ids

    def taken():
        jax.effects_barrier()
        out = seen[: cfg.n_layers] if cfg.family == "moe" else []
        seen.clear()
        return out

    jax.lax.top_k = spy
    try:
        yield taken
    finally:
        jax.lax.top_k = real


@contextlib.contextmanager
def _pinned_routing(routing, rows: slice, flipped: list):
    """The port's MoE routes each call's tokens as the reference did (the
    layer whose probabilities it computes, this rank's ``rows`` of the
    batch); the margin of each token the port would route otherwise is
    appended to ``flipped``.  ``routing``: one step's, as ``_jax_routing``
    gives it."""
    from repro_torch.models import moe

    real = moe._top_k
    def mine_of(a):  # (tokens, n) -> this rank's rows' tokens
        return a.reshape(-1, SEQ, a.shape[-1])[rows].reshape(-1, a.shape[-1])

    mine = [(mine_of(p), mine_of(i)) for p, i in routing]

    def pinned(probs, k):
        got = probs.detach().float().numpy()
        ref_p, ref_i = min(mine, key=lambda r: np.abs(r[0] - got).max())
        _, own = real(probs, k)
        differs = (np.sort(own.numpy(), -1) != np.sort(ref_i, -1)).any(-1)
        srt = -np.sort(-ref_p, -1)
        for t in np.flatnonzero(differs):
            flipped.append(float((srt[t, k - 1] - srt[t, k]) / srt[t, k - 1]))
        ids = torch.from_numpy(ref_i.astype(np.int64))
        return torch.take_along_dim(probs, ids, -1), ids

    moe._top_k = pinned
    try:
        yield
    finally:
        moe._top_k = real


def port_child(name: str, rank: int, port: str, d: str) -> None:
    """One gloo rank of a layout: every port number the cases read."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import repro_torch.configs as PC
    from repro_torch._tree import leaves, leaves_with_path, tree_map
    from repro_torch.distributed import sharding as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import sharded_decode_fn, sharded_prefill_fn
    from repro_torch.models import model as TM
    from repro_torch.training import checkpoint as TCk
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4
    )
    mesh = make_mesh(LAYOUTS[name], ("data", "model"), device="cpu")
    dm = mesh.device_mesh
    coord = tuple(dm.get_coordinate())
    with open(os.path.join(d, "data.pkl"), "rb") as f:
        data = pickle.load(f)
    out: dict = {"coord": coord, "data_size": LAYOUTS[name][0]}
    per = BATCH // LAYOUTS[name][0]
    rows = slice(coord[0] * per, (coord[0] + 1) * per)

    def routed(arch, i, flipped, whole=False):
        """The reference's routing of step ``i`` where ``arch`` routes (for
        this rank's rows, or the whole batch's)."""
        if arch != MOE:
            return contextlib.nullcontext()
        routing = _wait_for(os.path.join(d, "routing.pkl"))
        routing = routing["grads"] if i is None else routing["steps"][i]
        return _pinned_routing(routing, slice(0, BATCH) if whole else rows, flipped)

    def whole(t, sh):
        """The whole tensor of this rank's shard ``t`` placed by ``sh``."""
        return DTensor.from_local(
            t, dm, sh.placements, run_check=False
        ).full_tensor()

    for arch in sorted(ARCHS, key=lambda a: a == MOE):  # the routing last
        cfg = _smoke(PC, arch)
        dat = data[arch]
        shapes = TM.init_params(cfg, device="meta")
        p_sh = TS.params_shardings(shapes, mesh)
        like = {"params": shapes, "opt": TO.init_opt_state(shapes)}
        shardings = {"params": p_sh, "opt": TT.opt_shardings(shapes, mesh)}
        rec: dict = {"loss": [], "grad_norm": []}

        # the params leaf by leaf == the whole draw placed at once
        drawn = TT.init_params_sharded(cfg, mesh, seed=5)
        at_once = TS.place(TM.init_params(cfg, 5, device="cpu"), p_sh)
        same = all(
            torch.equal(a.to_local(), b.to_local())
            for a, b in zip(leaves(drawn), leaves(at_once))
        )
        _, o = TT.init_sharded(cfg, mesh, seed=5)
        same = same and all(isinstance(t, DTensor) for t in leaves(o))
        rec["init"] = "bit-equal" if same else "differs"

        # the train step: first-step gradients, then two steps
        st = TCk.restore(os.path.join(d, arch), 0, like, shardings)
        batch = {k: torch.from_numpy(v) for k, v in dat["train"].items()}
        local_b = TS.locals_of(batch, TS.batch_shardings(batch, mesh))
        local_p = TS.locals_of(st["params"], p_sh)
        flipped: list = []
        with routed(arch, None, flipped):
            _, grads = TT.loss_and_grads(
                cfg, local_p, local_b, lend=lambda live: TS.lend_params(live, p_sh, cfg)
            )
        rec["grads"] = {
            "/".join(path): whole(g, sh).float().numpy()
            for (path, g), sh in zip(leaves_with_path(grads), leaves(p_sh))
        }
        step, _ = TT.make_train_step(cfg, mesh, TT.TrainConfig(opt=TO.OptConfig(**OPT)))
        params, opt = st["params"], st["opt"]
        for i in range(STEPS):
            with routed(arch, i, flipped):
                params, opt, m = step(params, opt, batch)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
        rec["flipped_margins"] = flipped
        rec["state"] = _state(params, opt)
        if rank == 0:  # the same steps on one device, from the same state
            rec["one_device"] = _one_device(
                cfg, arch, d, like, batch, lambda i, f: routed(arch, i, f, whole=True)
            )

        # prefill and decode from the restored (untrained) params
        fresh = TCk.restore(os.path.join(d, arch), 0, like, shardings)["params"]
        local_p = TS.locals_of(fresh, p_sh)
        pre = {k: torch.from_numpy(v) for k, v in dat["prefill"].items()}
        local_pre = TS.locals_of(pre, TS.batch_shardings(pre, mesh))
        with torch.no_grad():
            rec["prefill"] = sharded_prefill_fn(cfg, p_sh)(local_p, local_pre)
        rec["prefill"] = rec["prefill"].float().numpy()
        rec["decode"] = _port_decode(cfg, dat, mesh, p_sh, local_p, coord)
        rec["live"] = _port_live(cfg, dat, mesh, p_sh, local_p, fresh)
        out[arch] = rec
    with open(os.path.join(d, f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _state(params, opt) -> dict:
    """{"<tree>/<path>": (the whole leaf as f32, its dtype's name)}."""
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import leaves_with_path

    out = {}
    for name, tree in (("params", params), ("opt", opt)):
        for path, t in leaves_with_path(tree):
            full = t.full_tensor() if isinstance(t, DTensor) else t
            dtype = str(full.dtype).removeprefix("torch.")
            out[f"{name}/{'/'.join(path)}"] = (full.float().numpy(), dtype)
    return out


def _one_device(cfg, arch, d, like, batch, routed) -> dict:
    """The first step's gradients and ``STEPS`` steps of the port's plain
    one-device step, from the reference's checkpoint and the whole batch
    (``routed(i, flipped)``: the routing of step ``i``)."""
    from repro_torch._tree import leaves_with_path
    from repro_torch.launch.mesh import _mesh
    from repro_torch.training import checkpoint as TCk
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT

    st = TCk.restore(os.path.join(d, arch), 0, like)
    flipped: list = []
    with routed(None, flipped):
        _, grads = TT.loss_and_grads(cfg, st["params"], batch)
    rec = {
        "grads": {"/".join(p): g.float().numpy() for p, g in leaves_with_path(grads)}
    }
    # how far rounding alone moves each leaf: the same gradients with the
    # embedding table moved by one bf16 ulp at random, three draws
    rec["band"] = {}
    for seed in range(3):
        w = st["params"]["embed"]
        gen = torch.Generator().manual_seed(seed)
        ulp = torch.randint(-1, 2, w.shape, generator=gen)
        moved = dict(st["params"], embed=(w.float() * (1 + ulp * 2.0**-8)).to(w.dtype))
        with routed(None, []):
            _, other = TT.loss_and_grads(cfg, moved, batch)
        for p, g in leaves_with_path(other):
            key = "/".join(p)
            spread = _rms_rel(g.float().numpy(), rec["grads"][key])
            rec["band"][key] = max(rec["band"].get(key, 0.0), spread)
    mesh = _mesh((1, 1), ("data", "model"), "cpu")
    step, _ = TT.make_train_step(cfg, mesh, TT.TrainConfig(opt=TO.OptConfig(**OPT)))
    params, opt = st["params"], st["opt"]
    for i in range(STEPS):
        with routed(i, flipped):
            params, opt, _ = step(params, opt, batch)
    rec["state"] = _state(params, opt)
    return rec


def _port_cache(cfg, dat) -> dict:
    from repro_torch.models import model as TM
    from repro_torch._tree import leaves_with_path

    cache = TM.init_cache(cfg, DB, MAX_SEQ, device="cpu")
    for path, t in leaves_with_path(cache):
        a, _ = dat["cache"]["/".join(path)]
        t.copy_(torch.from_numpy(a))
    return cache


def _port_decode(cfg, dat, mesh, p_sh, local_p, coord) -> dict:
    """``DSTEPS`` steps of ``sharded_decode_fn`` on this rank's cache
    shard: its rows' logits, and its cache shards with their slices."""
    from repro_torch._tree import leaves, leaves_with_path
    from repro_torch.distributed import sharding as TS
    from repro_torch.launch.steps import sharded_decode_fn

    cache = _port_cache(cfg, dat)
    c_sh = TS.cache_shardings(cache, mesh)
    local_c = tree_map_clone(TS.locals_of(cache, c_sh))
    fn = sharded_decode_fn(cfg, p_sh, c_sh)
    lens = torch.from_numpy(dat["lens"])
    rows = TS.batch_shardings({"t": lens}, mesh)["t"]
    logits = []
    with torch.no_grad():
        for i in range(DSTEPS):
            tok = torch.from_numpy(dat["tokens"][i])
            lg, local_c = fn(local_p, local_c, rows.local(tok), rows.local(lens))
            logits.append(lg.float().numpy())
            lens = lens + 1
    shards = {}
    for (path, t), sh in zip(leaves_with_path(local_c), leaves(c_sh)):
        idx = sh.local_slices(cache_shape(cache, path), coord)
        shards["/".join(path)] = (idx, t.float().numpy())
    split = any(TS._on_model(sh, 2) for sh in leaves(c_sh) if len(sh.spec) == 5)
    return {"logits": logits, "cache": shards, "split": split}


def cache_shape(cache, path):
    t = cache
    for k in path:
        t = t[k]
    return tuple(t.shape)


def tree_map_clone(tree):
    from repro_torch._tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _port_live(cfg, dat, mesh, p_sh, local_p, params) -> dict:
    """One decode step with rows 1 and 3 dead, sharded and on one device
    (the whole params and cache on every rank)."""
    from repro_torch._tree import leaves, leaves_with_path, tree_map
    from repro_torch.distributed import sharding as TS
    from repro_torch.launch.steps import sharded_decode_fn
    from repro_torch.models import model as TM

    cache = _port_cache(cfg, dat)
    c_sh = TS.cache_shardings(cache, mesh)
    local_c = tree_map_clone(TS.locals_of(cache, c_sh))
    before = tree_map_clone(local_c)
    whole_p = tree_map(lambda t: t.full_tensor(), params)
    lens = torch.from_numpy(dat["lens"])
    tok = torch.from_numpy(dat["tokens"][0])
    live = torch.tensor([True, False, True, False])
    rows = TS.batch_shardings({"t": lens}, mesh)["t"]
    with torch.no_grad():
        ref, _ = TM.decode_step(cfg, whole_p, cache, tok, lens, live)
        fn = sharded_decode_fn(cfg, p_sh, c_sh)
        mine = [rows.local(t) for t in (tok, lens, live)]
        got, local_c = fn(local_p, local_c, *mine)
    worst = 0.0
    kept = True
    dead = ~rows.local(live)
    for (path, t), old, sh in zip(
        leaves_with_path(local_c), leaves(before), leaves(c_sh)
    ):
        want = sh.local(_at(cache, path))
        worst = max(worst, _rel(t.float().numpy(), want.float().numpy()))
        kept = kept and torch.equal(t[:, dead], old[:, dead])
    return {
        "logits": _rel(got.float().numpy(), rows.local(ref).float().numpy()),
        "cache": worst,
        "dead_rows_kept": kept,
    }


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if sys.argv[1] == "--jax":
        jax_child(int(sys.argv[2]), sys.argv[3])
    else:
        port_child(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
