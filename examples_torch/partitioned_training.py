"""Partitioned training: two tenants fine-tune on disjoint mesh slices,
with checkpoint/restart.

The training-side version of the paper's claim: the SAME physical mesh
hosts two independent training jobs on disjoint column slices (no
cross-tenant collectives by construction), each with its own optimizer,
data stream and checkpoint lineage; when one job finishes, the other
inherits the freed columns at the next rebalance (here: demonstrated by
re-initialising the survivor's step on the wider slice).

    PYTHONPATH=src python examples_torch/partitioned_training.py [--device cpu]

The same program as ``examples/partitioned_training.py`` on
``repro_torch``, at the smoke configs.  Two of the reference's behaviours
are not copied: it seeds each tenant with ``hash(name) % 1000``, which
Python salts per process, so its weights change from run to run; here
llama is seeded 0 and mamba 1.  And it leaves its checkpoints in a
directory it never removes; here they go into a temporary directory that
the run removes.  ``--device`` defaults to ``cuda`` and the run raises
where there is no card; ``--device cpu`` runs it on the CPU.  ``main``
returns what it printed: the grants, each tenant's losses, the survivor's
growth and the restored step.
"""

import argparse
import tempfile

from repro_torch.configs import get
from repro_torch.distributed.tenancy import TenantMeshManager
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainConfig, init_sharded, make_train_step

# (tenant, arch, steps, seed)
JOBS = (("llama", "llama3.2-3b", 20, 0), ("mamba", "mamba2-780m", 10, 1))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="partitioned training demo")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    mesh = make_host_mesh(model=1, device=args.device)
    # demand-weighted slices via the repro_torch.api policy registry
    # ("equal" would reproduce the paper's Algorithm 1 verbatim)
    mgr = TenantMeshManager(mesh, "model", policy="proportional")
    mgr.admit("llama", demand=10.0)
    mgr.admit("mamba", demand=5.0)
    grants = {k: str(v) for k, v in mgr.rebalance().items()}
    print(f"tenancy grants: {grants}")

    jobs = {}
    for name, arch, steps, seed in JOBS:
        # on a 1-column host mesh only one tenant gets a spatial slice; the
        # other time-shares the whole mesh (what a real deployment does when
        # over-subscribed — Algorithm 1 queues it for the next free round)
        placed = mgr.tenant(name).partition is not None
        sub = mgr.submesh(name) if placed else mesh
        cfg = get(arch).smoke
        params, opt = init_sharded(cfg, sub, seed=seed)
        train = TrainConfig(opt=OptConfig(lr=5e-3, warmup_steps=2, total_steps=steps))
        _, jitted = make_train_step(cfg, sub, train)
        dcfg = DataConfig(vocab=cfg.vocab, batch=4, seq=32, seed=1)
        jobs[name] = dict(
            mesh=sub,
            params=params,
            opt=opt,
            jitted=jitted,
            dcfg=dcfg,
            steps=steps,
            step_fn=None,
            losses=[],
        )

    grown = None
    with tempfile.TemporaryDirectory(prefix="partitioned_training_") as ckpt_dir:
        for step in range(20):
            for name, j in jobs.items():
                if step >= j["steps"]:
                    continue
                batch = make_batch(j["dcfg"], step, j["mesh"])
                if j["step_fn"] is None:
                    j["step_fn"] = j["jitted"](j["params"], j["opt"], batch)
                j["params"], j["opt"], m = j["step_fn"](j["params"], j["opt"], batch)
                j["losses"].append(float(m["loss"]))
                if step == j["steps"] - 1:
                    ckpt.save(
                        f"{ckpt_dir}/{name}",
                        step + 1,
                        {"params": j["params"], "opt": j["opt"]},
                    )
                    print(
                        f"[{name}] finished at step {step + 1}, "
                        f"loss {j['losses'][0]:.3f} -> {j['losses'][-1]:.3f}, "
                        f"checkpointed"
                    )
                    if name == "mamba":
                        # tenant drains -> release + merge-accelerate survivor
                        mgr.release("mamba")
                        grown = {k: str(v) for k, v in mgr.grow_into_free().items()}
                        print(f"mamba released; survivor growth: {grown}")

        # restart demo: restore llama from its checkpoint (elastic re-shard path)
        like = {"params": jobs["llama"]["params"], "opt": jobs["llama"]["opt"]}
        got = ckpt.restore_latest(f"{ckpt_dir}/llama", like)
    if got is None:
        raise RuntimeError("no llama checkpoint to restore")
    print(f"\nrestored llama checkpoint from step {got[0]} — restart-safe")
    print("done.")
    return {
        "grants": grants,
        "losses": {name: j["losses"] for name, j in jobs.items()},
        "growth": grown,
        "restored_step": got[0],
        "restored": got[1],
        "trained": {"params": jobs["llama"]["params"], "opt": jobs["llama"]["opt"]},
    }


if __name__ == "__main__":
    main()
