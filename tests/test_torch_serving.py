"""The port's serving path against the JAX package's, llama3.2-3b smoke.

The same parameters (carried across by ``params_from_jax``), the same
prompts and the same engine scripts as ``tests/test_serving.py`` go through
both packages; the greedy tokens, the emission rounds and the engine's
``width_history`` must agree.

Greedy tokens and bf16: the two frameworks' logits agree within
rtol = atol = 3e-2 (see tests/test_torch_models.py).  Where the JAX top-2
logit margin at a step is within twice that band, rounding alone can flip
the argmax; there the test checks the margin instead of the token, and
stops comparing that request (its later tokens follow a different prefix).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get as jax_get
from repro.distributed.tenancy import TenantMeshManager as JaxManager
from repro.launch.mesh import make_host_mesh
from repro.models.model import init_params as jax_init_params
from repro.serving.engine import MultiTenantEngine as JaxEngine
from repro.serving.kv_cache import DecodeSession as JaxSession
from repro.serving.kv_cache import Request as JaxRequest
from repro_torch.configs import get
from repro_torch.distributed.tenancy import TenantMeshManager, device_grid
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import MultiTenantEngine
from repro_torch.serving.kv_cache import DecodeSession, Request

JCFG = jax_get("llama3.2-3b").smoke
CFG = get("llama3.2-3b").smoke
JPARAMS = [jax_init_params(JCFG, jax.random.key(i)) for i in range(2)]
PARAMS = [params_from_jax(jax.tree.map(np.asarray, p), device="cpu") for p in JPARAMS]
RTOL = ATOL = 3e-2


class _FakeMesh:
    """Multi-column stand-in for the JAX engine, as in tests/test_serving.py:
    the tenancy/fault path never builds a submesh on the CPU rig."""

    def __init__(self, model_cols: int):
        self.axis_names = ("data", "model")
        self.devices = np.empty((1, model_cols), dtype=object)


def _record(session, rows: dict, is_jax: bool):
    """Wrap ``session.step`` to keep, per request id, the logits row each
    of its tokens was picked from."""
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
            logits = np.asarray(session.recorded_logits[:, 0].astype(jnp.float32))
        else:
            logits = session.last_logits[:, 0].float().numpy()
        for slot, rid in slots.items():
            rows.setdefault(rid, []).append(logits[slot])
        return emitted

    session.step = recorded
    return session


def _sessions(i=0, slots=2, max_seq=32, rows=None):
    """A (JAX, port) session pair over tenant ``i``'s parameters."""
    rows = {} if rows is None else rows
    js = JaxSession(JCFG, JPARAMS[i], batch_slots=slots, max_seq=max_seq)
    ts = DecodeSession(CFG, PARAMS[i], batch_slots=slots, max_seq=max_seq, device="cpu")
    return _record(js, rows.setdefault("jax", {}), True), _record(
        ts, rows.setdefault("torch", {}), False
    )


def _assert_same_tokens(jreqs, treqs, jax_rows):
    checked = 0
    for jr, tr in zip(jreqs, treqs, strict=True):
        assert len(jr.out) == len(tr.out) == jr.max_new
        for i, (a, b) in enumerate(zip(jr.out, tr.out)):
            if a != b:
                top = np.sort(jax_rows[jr.rid][i])[-2:]
                margin = top[1] - top[0]
                assert margin <= 2 * (ATOL + RTOL * abs(top[1])), (jr.rid, i, margin)
                break
            checked += 1
    assert checked  # at least some tokens were compared as tokens


def _drive(session):
    while session.live:
        session.step()


class TestDecodeSession:
    def test_greedy_tokens_match_jax(self):
        rows = {}
        js, ts = _sessions(slots=2, rows=rows)
        prompts = [([1, 2, 3], 6), ([7, 8], 5), ([300, 4, 4, 9], 4)]
        jreqs = [JaxRequest(i, p, n) for i, (p, n) in enumerate(prompts)]
        treqs = [Request(i, p, n) for i, (p, n) in enumerate(prompts)]
        for s, reqs in ((js, jreqs), (ts, treqs)):
            s.admit(reqs[0])
            s.admit(reqs[1])
            s.step()
            _drive(s)
            s.admit(reqs[2])  # slot reuse after release
            _drive(s)
        _assert_same_tokens(jreqs, treqs, rows["jax"])
        assert [r.slot for r in treqs] == [r.slot for r in jreqs] == [-1] * 3

    def test_slot_isolation_matches_jax(self):
        """tests/test_serving.py's script: identical prompts give identical
        outputs whichever slot they occupy — in both packages."""
        outs = {}
        for name, Req, mk in (
            ("jax", JaxRequest, lambda rows: _sessions(rows=rows)[0]),
            ("torch", Request, lambda rows: _sessions(rows=rows)[1]),
        ):
            rows = {}
            s1 = mk(rows)
            a = Req(rid=0, prompt=[5, 6], max_new=3)
            s1.admit(a)
            _drive(s1)
            s2 = mk(rows)
            filler = Req(rid=1, prompt=[9, 9, 9], max_new=6)
            b = Req(rid=2, prompt=[5, 6], max_new=3)
            s2.admit(filler)
            s2.admit(b)
            _drive(s2)
            assert a.out == b.out, (name, a.out, b.out)
            outs[name] = ([a, filler, b], rows)
        jreqs, rows = outs["jax"]
        _assert_same_tokens(jreqs, outs["torch"][0], rows["jax"])

    def test_overfull_and_overlong_rejected(self):
        _, s = _sessions(slots=1, max_seq=8)
        with pytest.raises(ValueError):
            s.admit(Request(rid=0, prompt=[1, 2, 3], max_new=6))
        s.admit(Request(rid=1, prompt=[1], max_new=7))
        with pytest.raises(RuntimeError):
            s.admit(Request(rid=2, prompt=[2], max_new=1))


def _engine_pair(cols, policy, tenants, rows):
    """A JAX and a port engine over ``cols`` columns with the same tenants:
    ``tenants`` is a list of (name, params index, flops_per_token)."""
    jmesh = make_host_mesh(model=1) if cols == 1 else _FakeMesh(cols)
    jeng = JaxEngine(JaxManager(jmesh, "model"), policy=policy)
    teng = MultiTenantEngine(TenantMeshManager(device_grid("cpu", cols)), policy=policy)
    for name, i, fpt in tenants:
        js, ts = _sessions(i, rows=rows)
        jeng.add_tenant(name, js, flops_per_token=fpt)
        teng.add_tenant(name, ts, flops_per_token=fpt)
    return jeng, teng


def _strs(parts: dict) -> dict:
    return {k: str(v) for k, v in parts.items()}


def _placements(manager):
    return {t.name: t.partition and str(t.partition) for t in manager.tenants()}


def _run_script(jeng, teng, script, rows):
    """Apply ``script`` — ("submit", tenant, prompt, max_new), ("fail", col),
    ("heal", col), ("step",) or ("drain",) — to both engines, checking the
    placements after every action and the tokens at the end."""
    reqs = {"jax": [], "torch": []}
    for action in script:
        kind = action[0]
        for eng, key in ((jeng, "jax"), (teng, "torch")):
            if kind == "submit":
                reqs[key].append(eng.submit(*action[1:]))
            elif kind == "fail":
                reqs.setdefault(f"evicted_{key}", []).append(eng.fail_column(action[1]))
            elif kind == "heal":
                eng.heal_column(action[1])
            elif kind == "step":
                emitted = {n: sorted(e) for n, e in eng.step().items()}
                reqs.setdefault(f"emitted_{key}", []).append(emitted)
            else:
                rounds = []
                while eng.tenants:
                    rounds.append({n: sorted(e) for n, e in eng.step().items()})
                reqs.setdefault(f"rounds_{key}", []).append(rounds)
        assert _placements(teng.manager) == _placements(jeng.manager), action
    assert teng.width_history == jeng.width_history
    assert teng.round == jeng.round
    for key in ("evicted", "emitted", "rounds"):
        assert reqs.get(f"{key}_torch") == reqs.get(f"{key}_jax")
    _assert_same_tokens(reqs["jax"], reqs["torch"], rows["jax"])
    return teng


class TestEngine:
    def test_multi_tenant_drain_and_history(self):
        # a second llama3.2-3b smoke tenant takes the mamba2 tenant's place
        # in tests/test_serving.py's script: only the dense family is ported
        rows = {}
        tenants = [("llama-a", 0, 1.0), ("llama-b", 1, 2.0)]
        jeng, teng = _engine_pair(1, "equal", tenants, rows)
        script = [("submit", n, [1, 2], 3) for n, _, _ in tenants for _ in range(2)]
        teng = _run_script(jeng, teng, script + [("drain",)], rows)
        assert not teng.tenants and teng.width_history

    def test_served_counts(self):
        rows = {}
        jeng, teng = _engine_pair(1, "equal", [("llama", 0, 1.0)], rows)
        _run_script(jeng, teng, [("submit", "llama", [1], 5), ("drain",)], rows)

    def test_single_column_failure_evicts_and_replaces(self):
        rows = {}
        jeng, teng = _engine_pair(1, "equal", [("llama", 0, 1.0)], rows)
        script = [("submit", "llama", [1], 3), ("fail", 0), ("heal", 0), ("drain",)]
        _run_script(jeng, teng, script, rows)


@pytest.mark.parametrize("policy", ["equal", "proportional"])
class TestEngineFaultPath:
    """tests/test_serving.py's four-column fault and rebalance scripts."""

    TENANTS = [("A", 0, 1.0), ("B", 1, 2.0)]

    def test_fail_and_heal_each_column(self, policy):
        rows = {}
        jeng, teng = _engine_pair(4, policy, self.TENANTS, rows)
        script = [("fail", 0), ("heal", 0), ("fail", 2), ("heal", 2)]
        script += [("submit", "A", [1, 2], 2), ("submit", "B", [3], 2), ("drain",)]
        _run_script(jeng, teng, script, rows)

    def test_drains_after_fail_heal_cycle(self, policy):
        rows = {}
        jeng, teng = _engine_pair(4, policy, self.TENANTS, rows)
        script = [("submit", "A", [1, 2], 3), ("submit", "B", [3], 2)]
        script += [("fail", 1), ("heal", 1), ("drain",)]
        _run_script(jeng, teng, script, rows)

    def test_demand_shift_rebalances_on_submit(self, policy):
        rows = {}
        jeng, teng = _engine_pair(4, policy, self.TENANTS, rows)
        script = [("submit", "A", [1, 2, 3, 4], 6) for _ in range(4)]
        script += [("submit", "B", [1], 2), ("step",), ("drain",)]
        teng = _run_script(jeng, teng, script, rows)
        if policy == "proportional":
            # the round-1 split: nearly all outstanding work is A's
            first = {n: w for r, n, w in teng.width_history if r == 1}
            assert first == {"A": 3, "B": 1}


def test_unknown_policy_lists_the_ported_ones():
    with pytest.raises(ValueError, match="equal.*proportional"):
        TenantMeshManager(device_grid("cpu", 2), policy="moca").rebalance()


class TestTenancyParity:
    """Algorithm 1's state, the policies and the tenancy manager against
    the JAX package's on seeded random scripts (all host arithmetic, so the
    two must agree exactly)."""

    @pytest.mark.parametrize("seed", range(4))
    def test_partition_state_matches_jax(self, seed):
        from repro.core import partition as J
        from repro_torch.core import partition as P

        rng = np.random.default_rng(seed)
        cols = int(rng.integers(4, 40))
        for n in range(1, 7):
            mine = P.partition_calculation(P.ArrayShape(8, cols), n)
            theirs = J.partition_calculation(J.ArrayShape(8, cols), n)
            assert [str(p) for p in mine] == [str(p) for p in theirs]
        sets = (
            P.PartitionSet(P.ArrayShape(8, cols)),
            J.PartitionSet(J.ArrayShape(8, cols)),
        )
        held = []
        for step in range(40):
            if held and rng.random() < 0.4:
                name = held.pop(int(rng.integers(len(held))))
                assert str(sets[0].free(name)) == str(sets[1].free(name))
            else:
                name, width = f"t{step}", int(rng.integers(1, 7))
                got = []
                for ps in sets:
                    try:
                        got.append(str(ps.allocate(name, width)))
                    except ValueError:
                        got.append("no room")
                assert got[0] == got[1]
                held += [name] if got[0] != "no room" else []
            frees = [[str(p) for p in ps.free_partitions] for ps in sets]
            busy = [{k: str(v) for k, v in ps.busy_partitions.items()} for ps in sets]
            assert frees[0] == frees[1] and busy[0] == busy[1]
            assert sets[0].utilization == sets[1].utilization
            sets[0].check()

    @pytest.mark.parametrize("policy", ["equal", "proportional"])
    @pytest.mark.parametrize("seed", range(4))
    def test_policy_widths_and_order_match_jax(self, policy, seed):
        from repro.api import policy as J
        from repro_torch.api import policy as P

        rng = np.random.default_rng(seed)
        mine, theirs = P.get_policy(policy), J.get_policy(policy)
        for _ in range(20):
            n = int(rng.integers(1, 6))
            demand = rng.integers(0, 100, n) * (rng.random(n) < 0.8)
            specs = [
                (f"t{i}", float(demand[i]), int(rng.integers(1, 3))) for i in range(n)
            ]
            cols = int(rng.integers(1, 12))
            md = [P.TenantDemand(name=a, demand=d, min_cols=m) for a, d, m in specs]
            jd = [J.TenantDemand(name=a, demand=d, min_cols=m) for a, d, m in specs]
            assert mine.widths(cols, md) == theirs.widths(cols, jd)
            order = [t.name for t in mine.order(md)]
            assert order == [t.name for t in theirs.order(jd)]

    @pytest.mark.parametrize("policy", ["equal", "proportional"])
    @pytest.mark.parametrize("seed", range(3))
    def test_manager_scripts_match_jax(self, policy, seed):
        rng = np.random.default_rng(seed)
        cols = int(rng.integers(2, 7))
        mine = TenantMeshManager(device_grid("cpu", cols), policy=policy)
        theirs = JaxManager(_FakeMesh(cols), "model", policy=policy)
        names = []
        for step in range(40):
            op = rng.choice(["admit", "admit", "demand", "fail", "heal", "release"])
            if op == "admit" or not names:
                name, demand = f"t{step}", float(rng.integers(0, 50))
                names.append(name)
                for m in (mine, theirs):
                    m.admit(name, demand=demand, min_cols=int(rng.integers(1, 2)))
            elif op == "demand":
                name = names[int(rng.integers(len(names)))]
                demand = float(rng.integers(50))
                for m in (mine, theirs):
                    m.tenant(name).demand = demand
            elif op in ("fail", "heal"):
                col = int(rng.integers(cols))
                if op == "fail":
                    assert mine.mark_unhealthy(col) == theirs.mark_unhealthy(col)
                else:
                    mine.mark_healthy(col)
                    theirs.mark_healthy(col)
            else:
                name = names.pop(int(rng.integers(len(names))))
                mine.release(name)
                theirs.release(name)
                grown = mine.grow_into_free(), theirs.grow_into_free()
                assert _strs(grown[0]) == _strs(grown[1])
            grants = mine.rebalance(), theirs.rebalance()
            assert _strs(grants[0]) == _strs(grants[1])
            assert _placements(mine) == _placements(theirs)
            assert mine.utilization() == theirs.utilization()
        for name in names:
            if mine.tenant(name).partition is not None:
                sub = mine.submesh(name)
                assert sub.shape == (1, mine.tenant(name).partition.cols)
