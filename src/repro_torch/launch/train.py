"""End-to-end training launcher.

Counterpart of ``repro.launch.train``: a training loop with
checkpoint/restart, deterministic data and the JAX launcher's flags, on one
card (or the CPU with ``--device cpu``)::

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --steps 200 --batch 16 --seq 64 --ckpt-dir /tmp/ckpt

Kill the process at any step and run the same command again: it resumes
from the latest committed checkpoint and regenerates the exact data stream
from (seed, step).

Under ``torchrun`` it trains over every rank through the sharded step
(``make_host_mesh()`` over the world: data = ranks, model = 1), NCCL with
one card a rank, or gloo with ``--device cpu``; only rank 0 prints (on
the cards, its peak memory last)::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \\
        --device cpu --steps 3 --batch 4 --seq 16
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get, list_archs
from repro_torch.distributed.sharding import params_shardings
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models.model import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_loop import (
    TrainConfig,
    init_sharded,
    make_train_step,
    opt_shardings,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    p.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if "WORLD_SIZE" not in os.environ:  # one process
        return _train(args, print)
    dev = init_distributed(args.device)
    try:
        quiet = dist.get_rank() != 0
        rc = _train(args, (lambda *a, **k: None) if quiet else print)
        if dev.type == "cuda" and not quiet:
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            print(f"rank 0 of {dist.get_world_size()}: peak {peak:.2f} GB")
        return rc
    finally:
        dist.destroy_process_group()


def _train(args, say) -> int:
    """The run; ``say`` prints (a no-op on every rank but 0)."""
    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    mesh = make_host_mesh(device=args.device)
    say(
        f"arch={args.arch} family={cfg.family} mesh={mesh.devices.shape} "
        f"{mesh.axis_names}"
    )

    opt = OptConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps
    )
    tcfg = TrainConfig(opt=opt, microbatches=args.microbatches)
    _, jitted = make_train_step(cfg, mesh, tcfg)

    start = 0
    got = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if got is None:
        params, opt_state = init_sharded(cfg, mesh, seed=args.seed)
    else:
        # restored straight onto the mesh from the shapes alone: the state
        # is never held twice on the card
        shapes = init_params(cfg, device="meta")
        like = {"params": shapes, "opt": init_opt_state(shapes)}
        shardings = {
            "params": params_shardings(shapes, mesh),
            "opt": opt_shardings(shapes, mesh),
        }
        state = ckpt.restore(args.ckpt_dir, got, like, shardings)
        params, opt_state = state["params"], state["opt"]
        start = got
        say(f"resumed from step {start}")

    dcfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=args.seed)
    extras = {}
    if cfg.frontend == "audio":
        extras["frames"] = (args.batch, cfg.enc_seq, cfg.d_model)
    elif cfg.frontend == "vision":
        extras["patches"] = (args.batch, cfg.n_patches, cfg.d_model)

    step_fn = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_batch(dcfg, step, mesh, extras)
        if step_fn is None:
            step_fn = jitted(params, opt_state, batch)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            say(
                f"step {step + 1:5d}  loss {float(m['loss']):7.4f}  "
                f"gnorm {float(m['grad_norm']):8.3f}  {dt * 1e3:6.1f} ms/it",
                flush=True,
            )
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            d = ckpt.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state})
            say(f"checkpointed -> {d}", flush=True)
    say("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
