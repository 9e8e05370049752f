"""Multi-tenant serving driver — the paper's Fig. 4 timeline, live.

Counterpart of ``repro.launch.serve``: admits several architectures as
tenants of ONE device grid, feeds each a request stream, and runs the
engine until drained, printing the partition width history (the serving
analogue of Fig. 9(c,d))::

    python -m repro_torch.launch.serve \\
        --tenants llama3.2-3b,mamba2-780m,recurrentgemma-2b \\
        --requests 4 --max-new 8

The tenants are the smoke configs, on the card (``--device cpu`` for the
CPU).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import leaves
from repro_torch.configs import get
from repro_torch.distributed.tenancy import TenantMeshManager
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import ModelConfig, init_params
from repro_torch.serving.engine import MultiTenantEngine
from repro_torch.serving.kv_cache import DecodeSession


def add_tenant(
    eng: MultiTenantEngine,
    name: str,
    cfg: ModelConfig,
    seed: int,
    slots: int,
    max_seq: int,
    device="cuda",
) -> DecodeSession:
    """Admit ``cfg`` as tenant ``name`` of ``eng``: random weights drawn
    from ``seed`` on ``device``, a ``slots`` × ``max_seq`` session, and
    the demand proxy of 2 FLOPs a parameter a token."""
    params = init_params(cfg, seed, device=device)
    sess = DecodeSession(cfg, params, batch_slots=slots, max_seq=max_seq, device=device)
    # demand proxy: params × 2 FLOPs/token
    flops_tok = 2.0 * sum(x.numel() for x in leaves(params))
    eng.add_tenant(name, sess, flops_per_token=flops_tok)
    return sess


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tenants", default="llama3.2-3b,mamba2-780m,recurrentgemma-2b")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument(
        "--model-cols",
        type=int,
        default=0,
        help="width of the model axis (0 = all devices)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    cols = args.model_cols or n_dev
    mesh = make_host_mesh(model=cols, data=n_dev // cols, device=args.device)
    eng = MultiTenantEngine(TenantMeshManager(mesh, "model"))

    for i, name in enumerate(args.tenants.split(",")):
        add_tenant(eng, name, get(name).smoke, i, args.slots, args.max_seq, args.device)
        for r in range(args.requests):
            eng.submit(name, prompt=[1 + r, 2, 3], max_new=args.max_new)
        print(f"tenant {name}: {args.requests} requests queued")

    t0 = time.time()
    rounds = eng.run_until_drained()
    dt = time.time() - t0
    print(f"\ndrained in {rounds} rounds, {dt:.1f}s")
    print("partition width history (round, tenant, cols):")
    for rec in eng.width_history:
        print(f"  {rec}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
