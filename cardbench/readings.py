"""The readings that the check's limits are set from, on the card.

    python3 cardbench/readings.py --workload heavy-b128 --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 --seconds 2 --out build/readings.json

In one process, for one cell at its own size: the program's worst gap
(``max_rel_err``) on ``--seeds`` seeds (the lower reading is their
largest), the control's (the plain reference from float8 operands in the
program's place; the upper reading is its smallest) and each planted fault's
(``faults.py``), each over a short window at the cell's own load.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from cardbench import faults, harness  # noqa: E402

# seeds count up from here, past 2**31, one a run
FIRST_SEED = 2_147_483_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
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
    seed = FIRST_SEED
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "runs": []}

    def one(kind: str, program) -> None:
        nonlocal seed
        t = time.perf_counter()
        res, rec = harness.run_cell(
            bench, cell, seed=seed, seconds=args.seconds, trace=False, device=device,
            t_start=t, program=program,
        )
        row = {
            "kind": kind,
            "seed": seed,
            "max_rel_err": rec["check"]["max_rel_err"],
            "correct": res["correct"],
            "rounds": rec["rounds"],
            "window_s": rec["window_s"],
            "compared": rec["compared"],
            "s": time.perf_counter() - t,
        }
        print(json.dumps(row), flush=True)
        out["runs"].append(row)
        seed += 1
        torch.cuda.empty_cache()

    for _ in range(args.seeds):
        one("program", fused_tenant_gemm)
    for _ in range(args.control_seeds):
        one("control", ref.control)
    for name, plant in faults.FAULTS.items():
        for _ in range(args.fault_seeds):
            one(name, plant(fused_tenant_gemm))
    for kind in dict.fromkeys(r["kind"] for r in out["runs"]):
        vals = [r["max_rel_err"] for r in out["runs"] if r["kind"] == kind]
        print(f"{kind}: min {min(vals)} max {max(vals)} over {len(vals)} seeds")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
