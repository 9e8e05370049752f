"""One short run of a cell end to end on the card; skips without one.

    python -m pytest -q -m cuda cardbench/tests/test_cardbench_card.py
"""

import json
import subprocess
import sys

import pytest

from cardbench import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_light_b128(card, trace):
    out = subprocess.run(
        [
            sys.executable,
            "cardbench/run.py",
            *("--workload", "light-b128", "--seed", "2147483649"),
            *("--seconds", "1", "--trace", str(trace)),
        ],
        cwd=harness.REPO,
        capture_output=True,
        text=True,
        timeout=340,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    metrics = harness.metrics_for(harness.benchmark(), "light-b128", bool(trace))
    want = {m["name"] for m in metrics}
    assert set(res["metrics"]) == want
    assert out.stderr.strip().splitlines()[-1].startswith("check max_rel_err")
