"""Multi-tenant serving with dynamic partitioning + fault injection.

Three architectures (dense llama, SSM mamba2, hybrid recurrentgemma) share
one device mesh under Algorithm-1 tenancy, with the partition policy chosen
by name from the `repro_torch.api` registry (``proportional`` here —
MoCA-style demand-weighted slices; the llama tenant is pinned to SLA tier
0).  Mid-run, a device column fails: the affected tenant is evicted,
re-placed by the same policy that handles arrivals, and the run completes —
the paper's merge/re-assign logic IS the fault-tolerance story.

    PYTHONPATH=src python examples_torch/multi_tenant_serving.py [--device cpu]
    PYTHONPATH=src python examples_torch/multi_tenant_serving.py --full

The same program as ``examples/multi_tenant_serving.py`` on
``repro_torch``: the printed text (admissions, tokens emitted a round, the
evicted tenant, rounds to drain, the width history) depends on no weight,
so it is the reference's, on the card and on the CPU.  Tenant ``i``'s
weights are drawn from a generator seeded with ``i`` (the reference folds
``i`` into one key).  ``--device`` defaults to ``cuda`` and the run raises
where there is no card; ``--device cpu`` runs it on the CPU.  ``--full``
serves the three published configs in place of their smoke configs (8.0 G
parameters, 16 GB of bf16 weights: a card only).  ``main`` returns what it
printed, with each tenant's tokens and the seconds from the first round to
the drain.
"""

import argparse
import time

from repro_torch._tree import leaves
from repro_torch.configs import get
from repro_torch.distributed.tenancy import TenantMeshManager
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import init_params
from repro_torch.serving.engine import MultiTenantEngine
from repro_torch.serving.kv_cache import DecodeSession

TENANTS = ["llama3.2-3b", "mamba2-780m", "recurrentgemma-2b"]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="multi-tenant serving demo")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument(
        "--full",
        action="store_true",
        help="serve the published configs, not their smoke configs",
    )
    args = parser.parse_args(argv)

    mesh = make_host_mesh(model=1, device=args.device)
    mgr = TenantMeshManager(mesh, "model")
    eng = MultiTenantEngine(mgr, policy="proportional")

    services = {}
    for i, name in enumerate(TENANTS):
        cfg = get(name).model if args.full else get(name).smoke
        params = init_params(cfg, seed=i, device=args.device)
        sess = DecodeSession(cfg, params, batch_slots=2, max_seq=64, device=args.device)
        flops_tok = 2.0 * sum(t.numel() for t in leaves(params))
        services[name] = eng.add_tenant(name, sess, flops_per_token=flops_tok, tier=i)
        for r in range(3):
            eng.submit(name, prompt=[1 + r, 2, 3], max_new=6 + 2 * i)
        print(f"admitted {name} (family={cfg.family}, tier={i}), 3 requests")

    print("\n-- running 5 rounds --")
    t0 = time.perf_counter()
    emitted = []
    for _ in range(5):
        out = eng.step()
        emitted.append({k: len(v) for k, v in out.items()})
        print(f"round {eng.round}: emitted {emitted[-1]}")

    print("\n-- injecting device-column failure --")
    evicted = eng.fail_column(0)
    print(f"column 0 failed; evicted tenants: {evicted}")
    eng.heal_column(0)
    print("column 0 healed; tenants re-placed by Task_Assignment")

    rounds = eng.run_until_drained()
    decode_s = time.perf_counter() - t0
    print(f"\nall tenants drained after {rounds} total rounds")
    print("partition width history (round, tenant, cols):")
    for rec in eng.width_history:
        print(f"  {rec}")
    return {
        "emitted": emitted,
        "evicted": evicted,
        "rounds": rounds,
        "width_history": list(eng.width_history),
        "drained": not eng.tenants,
        "tokens": {name: svc.served for name, svc in services.items()},
        "decode_s": decode_s,
    }


if __name__ == "__main__":
    main()
