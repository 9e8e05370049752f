"""The readings that the GLM-4.7-Flash prefill check's limits are set from,
on the card.

    python3 cardbench/glm_readings.py --workload glm-4.7-flash-prefill-16k \\
        --seeds 12 --control-seeds 3 --fault-seeds 2 --seconds 2 \\
        --out build/glm-readings.json

``lfm2_readings.py``'s loop, unchanged, with this model's planted faults
(``glm_faults.py``) in place of LFM2's: in one process, for one cell at its
own size, the check's three numbers for the program on ``--seeds`` seeds,
for the float8 control and for each fault.  The benchmark's own runs never
run this.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from cardbench import glm_faults, lfm2_readings  # noqa: E402


def main(argv=None) -> int:
    lfm2_readings.lfm2_faults = glm_faults
    return lfm2_readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
