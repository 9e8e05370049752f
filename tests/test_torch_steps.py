"""The port's dry-run steps (``repro_torch.launch.steps``) against the JAX
package's: the FLOPs each counts, and the numbers each step computes.

FLOPs.  The port counts the matrix products of a step's run on meta
tensors (``torch.utils.flop_counter``); the JAX package counts the dots
of the compiled HLO, each loop body times its trip count
(``repro.launch.hlo_analysis.loop_aware_cost``).  On the reduced cells of
one device:

* decode and prefill agree within 1 %, except mamba2-780m's prefill: the
  SSD's three-operand einsums (``ssd_forward``) are contracted pair by
  pair in another order by ``torch.einsum`` (its opt_einsum path) than by
  ``jnp.einsum``, which also lowers a pairwise step with nothing to sum to
  an elementwise multiply, not a dot.  Its bound is 5 %;
* train agrees within 2 %: the port counts more by one PV product
  (``p @ v``) per attention chunk and layer.  Under remat both packages
  recompute each chunk of the attention for its backward pass, but the
  backward needs only the chunk's scores, so XLA drops the recomputed PV
  product, while ``torch.utils.checkpoint`` reruns the whole chunk body.
  On the smoke configs that is 0.2–1.2 % of the step.  mamba2-780m's
  train step is held to the same 5 % as its prefill, for its einsums.

Numbers.  llama3.2-3b's reduced step of each kind on real CPU tensors
against the JAX package's jitted step on the same values (the parameters
carried across by ``params_from_jax``, everything else from a NumPy
seed), within the JAX package's bf16 tolerance 3e-2 (``TOL`` in
tests/test_kernels.py), per leaf as max |Δ| / max |ref|; integer leaves
and the optimizer's step count ``==``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
from repro.launch.hlo_analysis import loop_aware_cost
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.steps import build_lowerable as jax_lowerable
from repro.models import model as JM
from repro.training import optimizer as JO
import repro_torch.configs as PC
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_lowerable
from repro_torch.models.convert import params_from_jax

TOL = 3e-2
JMESH = jax_host_mesh()
META = make_host_mesh(device="meta")
CELLS = [(a, c.name) for a in JC.list_archs() for c in JC.get(a).shapes()]
EINSUM_ORDER = {"mamba2-780m"}  # contraction order of the SSD's einsums


@pytest.mark.parametrize("arch,cell", CELLS, ids=[f"{a}-{c}" for a, c in CELLS])
def test_flops_match_loop_aware_cost(arch, cell):
    ref_low = jax_lowerable(JC.get(arch), cell, JMESH, reduced=True)
    ref = loop_aware_cost(ref_low.lower().compile().as_text()).flops
    low = build_lowerable(PC.get(arch), cell, META, reduced=True)
    got = low.lower().flops
    if arch in EINSUM_ORDER:
        bound = 0.05
    else:
        bound = 0.02 if low.kind == "train" else 0.01
    assert abs(got / ref - 1.0) <= bound, (got, ref)
    if low.kind == "train" and arch not in EINSUM_ORDER:
        assert got >= ref  # the recomputed PV products, and nothing else


# ---------------------------------------------------------------------------
# the steps' numbers on real tensors
# ---------------------------------------------------------------------------

ARCH = "llama3.2-3b"


def _values(sds_tree, seed: int, cfg):
    """Real arrays for a tree of ``ShapeDtypeStruct``s, from a NumPy seed:
    integers below the vocab, standard normal floats."""
    rng = np.random.default_rng(seed)

    def real(sds):
        if jnp.issubdtype(sds.dtype, jnp.integer):
            return np.asarray(rng.integers(0, cfg.vocab, sds.shape), np.int32)
        vals = rng.standard_normal(sds.shape).astype(np.float32)
        return np.asarray(jnp.asarray(vals).astype(sds.dtype))

    return jax.tree.map(real, sds_tree)


def _pair_args(cell: str):
    """(JAX lowerable, JAX args, port lowerable, port args): the same
    values on both sides."""
    jlow = jax_lowerable(JC.get(ARCH), cell, JMESH, reduced=True)
    cpu = make_host_mesh(device="cpu")
    low = build_lowerable(PC.get(ARCH), cell, cpu, reduced=True)
    cfg = JC.get(ARCH).smoke
    params = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(7)))
    rest = _values(jlow.args[1:], seed=8, cfg=cfg)
    if jlow.kind == "train":  # the optimizer state of these params
        rest = (jax.tree.map(np.asarray, JO.init_opt_state(params)), rest[1])
    if jlow.kind == "decode":  # (cache, token, cache_len): rows part filled
        rest = (*rest[:2], rest[2] % 20)
    np_args = (params, *rest)
    port_args = tuple(params_from_jax(a, device="cpu") for a in np_args)
    jax_args = jax.tree.map(jnp.asarray, np_args)
    return jlow, jax_args, low, port_args


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}['{k}']")
    else:
        yield path, tree


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_step_numbers_match_jax(cell):
    jlow, jax_args, low, port_args = _pair_args(cell)
    ref = jlow.jitted(*jax_args)
    with torch.no_grad():
        out = low.step(*port_args)
    ref_leaves = [
        (jax.tree_util.keystr(p), x)
        for p, x in jax.tree_util.tree_leaves_with_path(ref)
    ]
    mine = list(_leaves(out))
    assert [p for p, _ in mine] == [p for p, _ in ref_leaves]
    for (path, m), (_, r) in zip(mine, ref_leaves):
        assert tuple(m.shape) == tuple(r.shape), path
        if not m.dtype.is_floating_point:
            assert np.array_equal(m.numpy(), np.asarray(r)), path
            continue
        a, b = _np(m), _np(r)
        rel = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))
        assert rel < TOL, (path, rel)
