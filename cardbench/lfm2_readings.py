"""The readings that the LFM2-MoE prefill check's limits are set from, on
the card.

    python3 cardbench/lfm2_readings.py --workload lfm2-24b-prefill-16k \\
        --seeds 12 --control-seeds 3 --fault-seeds 2 --seconds 2 \\
        --out build/lfm2-readings.json

In one process, for one cell at its own size: the check's three numbers
(``max_rel_err``, ``route_mismatch``, ``logit_rel_err``) for the program on
``--seeds`` seeds, for the control (the plain reference's GEMM from float8
operands in the program's place) and for each planted fault
(``lfm2_faults.py``), each over a short window at the cell's own load.  The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from cardbench import harness, lfm2_faults  # noqa: E402

# seeds count up from here, past 2**31, one a run
FIRST_SEED = 2_147_484_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import fused_tenant_gemm

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    ref = harness.module("references", harness.config(cell["config"])["reference"])
    device = torch.device("cuda", 0)
    seed = args.first_seed
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "runs": []}

    def one(kind, program, plant=contextlib.nullcontext()):
        nonlocal seed
        t = time.perf_counter()
        with plant:
            res, rec = harness.run_cell(
                bench, cell, seed=seed, seconds=args.seconds, trace=False,
                device=device, t_start=t, program=program,
            )
        row = {"kind": kind, "seed": seed, **rec["check"], "correct": res["correct"],
               "rounds": rec["rounds"], "window_s": rec["window_s"],
               "check_s": rec["check_s"], "s": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        out["runs"].append(row)
        seed += 1
        del res, rec
        torch.cuda.empty_cache()

    for _ in range(args.seeds):
        one("program", fused_tenant_gemm)
    for _ in range(args.control_seeds):
        one("control", ref.control)
    for name, fault in lfm2_faults.FAULTS.items():
        for _ in range(args.fault_seeds):
            one(name, *fault(fused_tenant_gemm))
    for kind in dict.fromkeys(r["kind"] for r in out["runs"]):
        rows = [r for r in out["runs"] if r["kind"] == kind]
        span = {k: (min(r[k] for r in rows), max(r[k] for r in rows))
                for k in ref.LIMITS}
        print(f"{kind}: {json.dumps(span)} over {len(rows)} seeds")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
