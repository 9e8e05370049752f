"""Quickstart: the paper's algorithm end to end on repro_torch.

1. Reproduce Fig. 9 (heavy workload) through `repro_torch.api.Session`:
   dynamic partitioning vs sequential, then compare partition policies.
2. Run the fused multi-tenant partitioned GEMM and check it against
   ``x @ w``: on the card, one launch of the hand-written CUDA kernel (the
   dense or the compact one, as ``grid_mode="auto"`` picks); on the CPU,
   the kernel's plain version.
3. Train a reduced llama3.2-3b for 30 steps and watch the loss drop.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The same program as ``examples/quickstart.py`` on ``repro_torch``.  Part 1
prints the reference's text.  Part 2's header names the kernel's backend in
place of the reference's "(Pallas, interpret)", and its operands come from
a generator seeded with the tenant's index, so the max errors differ from
the reference's; so do part 3's losses.  ``--device`` defaults to ``cuda``
and the run raises where there is no card; ``--device cpu`` runs it on the
CPU.  ``main`` returns what it printed, with part 2's operands and outputs.
"""

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.api import Session, list_policies
from repro_torch.configs import get
from repro_torch.kernels import fused_tenant_gemm
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sim.runner import format_report
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainConfig, init_sharded, make_train_step

GEMMS = [(100, 200, 96), (256, 128, 300)]  # (T, K, N) a tenant, float32
MAX_ERR = 1e-3
BACKEND = {"cuda": "CUDA sm_90a kernel", "cpu": "plain version, CPU"}


def paper() -> dict:
    print("=" * 70)
    print("1) Fig. 9 reproduction — heavy workload (policy='equal' = Alg. 1)")
    print("=" * 70)
    res = Session(policy="equal", backend="sim").run("heavy")
    print(format_report(res))

    print()
    print("policy comparison (heavy):")
    policies = {}
    for pol in list_policies():
        r = policies[pol] = Session(policy=pol, backend="sim").run("heavy")
        print(
            f"  {pol:<14} time saving {r.time_saving * 100:5.1f}%  "
            f"energy saving {r.energy_saving * 100:5.1f}%"
        )
    return {"report": res, "policies": policies}


def kernel(device: torch.device) -> dict:
    print()
    print("=" * 70)
    print(f"2) fused multi-tenant partitioned-WS GEMM ({BACKEND[device.type]})")
    print("=" * 70)
    xs, ws = [], []
    for i, (t, k, n) in enumerate(GEMMS):
        gen = torch.Generator(device=device).manual_seed(i)
        xs.append(torch.randn((t, k), generator=gen, device=device))
        ws.append(torch.randn((k, n), generator=gen, device=device))
    outs = fused_tenant_gemm(xs, ws)
    errs = []
    for i, (x, w, o) in enumerate(zip(xs, ws, outs)):
        err = float((o - x @ w).abs().max())  # a check; the kernel computed o
        errs.append(err)
        print(
            f"tenant {i}: {tuple(x.shape)} @ {tuple(w.shape)} -> {tuple(o.shape)}, "
            f"max err {err:.2e}"
        )
        if not err < MAX_ERR:
            raise RuntimeError(f"tenant {i}: max err {err} against x @ w")
    return {"xs": xs, "ws": ws, "outs": outs, "max_err": errs}


def train(device: torch.device) -> dict:
    print()
    print("=" * 70)
    print("3) train reduced llama3.2-3b, 30 steps")
    print("=" * 70)
    cfg = get("llama3.2-3b").smoke
    mesh = make_host_mesh(device=device)
    params, opt_state = init_sharded(cfg, mesh, seed=0)
    _, jitted = make_train_step(
        cfg,
        mesh,
        TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=5, total_steps=100)),
    )
    dcfg = DataConfig(vocab=cfg.vocab, batch=8, seq=32, seed=0)
    step_fn = None
    losses = []
    for i in range(30):
        batch = make_batch(dcfg, i, mesh)
        if step_fn is None:
            step_fn = jitted(params, opt_state, batch)
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:3d}  loss {losses[-1]:.4f}")
    first, last = losses[0], losses[-1]
    if not last < first:
        raise RuntimeError(f"loss did not drop: {first} -> {last}")
    print(f"\nloss {first:.3f} -> {last:.3f}: OK")
    return {"losses": losses}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="repro_torch quickstart")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    out = {"paper": paper(), "gemm": kernel(device), "train": train(device)}
    print("\nquickstart complete.")
    return out


if __name__ == "__main__":
    main()
