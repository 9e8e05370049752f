"""Run one cell of the benchmark once and print its result line.

    python3 cardbench/run.py --workload heavy-b128 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout; measures ``repro_torch`` (``src/``) on the
CUDA card.  Set-up (importing torch, building or loading the kernels,
drawing the operands on the card, warming every wave's geometry) counts in
``setup_s``; then the cell's ``drivers/<name>.py`` measures for
``--seconds`` and checks what the timed path produced against the plain
reference, and this prints, as the last line of standard output, one JSON
object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared and its limit,
also the last lines of standard error).  Exits 2 without a result where
there is no card or too few, and 3 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from cardbench import harness  # noqa: E402


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: power limit not read ({e})"
    return "card: " + out.stdout.strip().replace("\n", "; ")


def round_line(record: dict) -> str:
    """The spread of the window's rounds: completion intervals and host
    enqueue time a round (ms), and the slowest rounds by index."""
    iv, enq = record["round_s"], record["round_enqueue_s"]
    if not iv:
        return "rounds: none completed"

    def q(v):
        v = sorted(v)
        mid = v[len(v) // 2]
        return f"min {1e3 * v[0]:.3f} median {1e3 * mid:.3f} max {1e3 * v[-1]:.3f}"

    slow = sorted(range(len(iv)), key=lambda i: -iv[i])[:5]
    return (
        f"round ms: {q(iv)}; slowest {[(i, round(1e3 * iv[i], 3)) for i in slow]}; "
        f"enqueue ms a round: {q(enq) if enq else 'none'}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    result, record = harness.run_cell(
        bench,
        cell,
        seed=args.seed,
        seconds=args.seconds,
        trace=bool(args.trace),
        device=torch.device("cuda", 0),
        t_start=T_START,
    )
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"forbidden modules loaded: {', '.join(leaked)}", file=sys.stderr)
        return 3
    print(power_line())
    print(f"build_s: {record['build_s']}")
    print(f"launches in the window: {json.dumps(record['launches'])}")
    print(
        f"rounds: {record['rounds']} in {record['window_s']} s; checked round "
        f"{record['check_round']}, {record['compared']} GEMMs in {record['check_s']} s"
    )
    print(round_line(record))
    if record.get("trace"):
        tr = record["trace"]
        print(
            f"trace: {tr['rounds']} rounds, {tr['kernels']} kernels; "
            f"per-wave table {tr['table']}"
        )
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
