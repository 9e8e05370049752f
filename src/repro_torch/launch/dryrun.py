"""Multi-pod dry run: every (arch × shape × mesh) cell run on the meta device.

Counterpart of ``repro.launch.dryrun``.  It shows that the distribution
config is coherent without the hardware: the production meshes (16×16,
and 2×16×16 multi-pod) are meshes of placeholder meta devices
(``launch.mesh``, the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count=512``), and each cell's step
(``launch.steps``) runs at its full global shapes on meta arguments, which
allocates nothing.  A cell is ``ok`` when that run traces.  Each record
keeps the JAX package's keys:

* ``compile_s`` — the seconds the meta run took (there is no compile);
* ``flops_per_device`` — the step's matrix-product FLOPs
  (``torch.utils.flop_counter``) over the mesh's device count.  That is
  XLA's per-device dot FLOPs only where all the work is partitioned: work
  that XLA replicates (a dim no mesh axis divides) counts once here;
* ``arg_bytes``, ``out_bytes`` — what one device holds of the step's
  arguments and outputs, from each leaf's spec on the mesh;
* ``collectives`` ({kind: [count, bytes]} under XLA's names),
  ``collective_bytes`` (their sum) and ``temp_bytes`` (the peak of live
  bytes beyond the arguments) — from a second run of the step as rank 0
  of the mesh runs it, in a fake process group of the mesh's size
  (``launch.steps.Lowerable.partition``): each layer's leaves gathered
  over the data axes, the heads, ff columns, vocab, experts, lru
  channels and SSD heads computed split over "model", nothing issued
  over an axis of one rank, the decode cache split over its batch and KV
  sequence as ``arg_bytes`` counts it.  The port partitions by its own
  rules, not GSPMD's (where "model" does not divide the attention heads,
  the full-sequence steps give a rank its run of whole heads from the
  gathered weights), so these are the port's numbers, not XLA's; a train
  cell whose batch shard is smaller than the microbatch count
  accumulates over as many microbatches as the shard allows.  The
  printed line adds that run's matrix-product FLOPs (``rank_flops``),
  the rank's share of the work, which the record does not keep (its keys
  are the JAX package's);
* ``bytes_per_device``, ``flops_xla_raw``, ``bytes_xla_raw``,
  ``transcendentals`` — only a compiler can give these: ``null``, never
  an estimate.

Usage::

    python -m repro_torch.launch.dryrun                   # all cells
    python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --cell train_4k --mesh both
    python -m repro_torch.launch.dryrun --out results.json

The default ``--out`` is ``build/dryrun_torch.json``; ``benchmarks/`` stays
the JAX package's.  The exit code is 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ARCHS, TUNED_PROFILES, get
from repro_torch.distributed.sharding import choose_mesh_shape
from repro_torch.launch.mesh import _mesh, make_production_mesh
from repro_torch.launch.steps import build_lowerable
from repro_torch.training.train_loop import TrainConfig

# what only XLA's compiled artifact gives; the port records them as null
XLA_ONLY = (
    "bytes_per_device",
    "flops_xla_raw",
    "bytes_xla_raw",
    "transcendentals",
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="all")
    p.add_argument("--cell", default="all")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--out", default="build/dryrun_torch.json")
    p.add_argument(
        "--microbatches",
        type=int,
        default=16,
        help="grad-accumulation for train cells (memory)",
    )
    p.add_argument(
        "--tuned",
        action="store_true",
        help="per-arch optimized profile: choose_mesh_shape factorization + "
        "Q-chunked causal attention + microbatch-32",
    )
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    arch_ids = list(ARCHS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results: dict[str, dict] = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    n_ok = n_fail = 0
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        mesh_name = "2x16x16" if multi_pod else "16x16"
        n_chips = 512 if multi_pod else 256
        for arch_id in arch_ids:
            spec = get(arch_id)
            mb = args.microbatches
            if args.tuned:
                prof = TUNED_PROFILES.get(arch_id)
                data_w, model_w = (
                    prof["mesh"] if prof else choose_mesh_shape(spec.model, 256)
                )
                shape = (2, data_w, model_w) if multi_pod else (data_w, model_w)
                axes = ("pod", "data", "model") if multi_pod else ("data", "model")
                mesh = _mesh(shape, axes, "meta")
                mesh_name = ("2x" if multi_pod else "") + f"{data_w}x{model_w}"
                spec = dataclasses.replace(
                    spec,
                    model=dataclasses.replace(
                        spec.model,
                        attn_q_chunks=(prof or {}).get("q_chunks", 4),
                        attn_chunk=(prof or {}).get("attn_chunk", 1024),
                    ),
                )
                mb = (prof or {}).get("microbatches", 32)
            cells = (
                [c.name for c in spec.shapes()] if args.cell == "all" else [args.cell]
            )
            for cell_name in cells:
                if cell_name in spec.skip_shapes:
                    continue
                key = f"{arch_id}|{cell_name}|{mesh_name}"
                t0 = time.time()
                try:
                    low = build_lowerable(
                        spec, cell_name, mesh, train=TrainConfig(microbatches=mb)
                    )
                    lowered = low.lower()
                    part = low.partition()
                    rank_flops = part.flops
                    rec = {
                        "arch": arch_id,
                        "cell": cell_name,
                        "mesh": mesh_name,
                        "chips": n_chips,
                        "ok": True,
                        "compile_s": round(time.time() - t0, 1),
                        "flops_per_device": lowered.flops / mesh.size,
                        "arg_bytes": lowered.arg_bytes,
                        "out_bytes": lowered.out_bytes,
                        "temp_bytes": part.temp_bytes,
                        "collective_bytes": part.collective_bytes,
                        "collectives": part.collectives,
                        **dict.fromkeys(XLA_ONLY),
                    }
                    n_ok += 1
                    if not args.quiet:
                        print(
                            f"OK   {key:55s} {rec['compile_s']:6.1f}s "
                            f"flops={rec['flops_per_device']:.3g} "
                            f"args={rec['arg_bytes'] / 1e9:.2f}GB "
                            f"out={rec['out_bytes'] / 1e9:.2f}GB "
                            f"temp={rec['temp_bytes'] / 1e9:.2f}GB "
                            f"coll={rec['collective_bytes'] / 1e9:.2f}GB "
                            f"rank_flops={rank_flops:.4g}",
                            flush=True,
                        )
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {
                        "arch": arch_id,
                        "cell": cell_name,
                        "mesh": mesh_name,
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "compile_s": round(time.time() - t0, 1),
                    }
                    n_fail += 1
                    print(f"FAIL {key}: {rec['error'][:300]}", flush=True)
                    if not args.quiet:
                        traceback.print_exc()
                results[key] = rec
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1, sort_keys=True)

    print(f"\ndry-run: {n_ok} ok, {n_fail} failed ({len(results)} cells recorded)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
