"""The port's three device example programs against the reference's,
run with ``--device cpu``.

``multi_tenant_serving`` prints nothing that a weight decides, so its
stdout is the reference's, whole.  ``quickstart`` and
``partitioned_training`` are compared line for line up to the last line
the reference prints: the reference stops early on this JAX version (the
fault of ``make_train_step(...)[1]`` in ROADMAP queue 3), the port runs to
its end.  Floats are masked only where the two packages draw different
random numbers (losses, the GEMM's max error).  What the reference cannot
reach is checked on the port alone.
"""

import math
import re
import tempfile

import pytest

torch = pytest.importorskip("torch")

from _examples import run_port, run_reference

CPU = ["--device", "cpu"]
FLOAT = r"-?\d+\.\d+(?:e[+-]\d+)?"
# the floats a random draw decides: they differ between the packages
DRAWN = [
    (re.compile(rf"max err {FLOAT}"), "max err <drawn>"),
    (re.compile(rf"loss {FLOAT}"), "loss <drawn>"),
    (re.compile(rf"loss {FLOAT} -> {FLOAT}"), "loss <drawn> -> <drawn>"),
]
# the one line that names the GEMM's backend: Pallas in interpret mode in
# the reference, the kernel's plain version on the port's CPU path
BACKEND_LINE = (
    "2) fused multi-tenant partitioned-WS GEMM (plain version, CPU)",
    "2) fused multi-tenant partitioned-WS GEMM (Pallas, interpret)",
)


def _masked(text: str) -> list[str]:
    lines = []
    for line in text.splitlines():
        if line == BACKEND_LINE[0]:
            line = BACKEND_LINE[1]
        for pattern, mask in DRAWN:
            line = pattern.sub(mask, line)
        lines.append(line)
    return lines


def _same_as_far_as_the_reference_goes(name, monkeypatch, capsys, tmp_path):
    """Each package runs in a working and a temporary directory of its own
    (``tmp_path``/ref, ``tmp_path``/port)."""
    for side in ("ref", "port"):
        (tmp_path / side / "tmp").mkdir(parents=True)
    monkeypatch.chdir(tmp_path / "ref")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "ref" / "tmp"))
    want, _ = run_reference(name, [], monkeypatch, capsys)
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "port" / "tmp"))
    got, data = run_port(name, CPU, capsys)
    want, got = _masked(want), _masked(got)
    assert want, "the reference printed nothing"
    assert got[: len(want)] == want
    return got, data


def _finite_and_falling(losses):
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses


def test_multi_tenant_serving_prints_what_the_reference_prints(
    monkeypatch, capsys, tmp_path
):
    monkeypatch.chdir(tmp_path)
    want, error = run_reference("multi_tenant_serving", [], monkeypatch, capsys)
    assert error is None, error
    got, data = run_port("multi_tenant_serving", CPU, capsys)
    assert got == want
    assert data["drained"]
    assert data["tokens"] == {
        "llama3.2-3b": 18,
        "mamba2-780m": 24,
        "recurrentgemma-2b": 30,
    }


def test_quickstart_matches_the_reference_and_runs_to_its_end(
    monkeypatch, capsys, tmp_path
):
    """The reference prints parts 1 and 2, then fails in part 3: its
    ``make_train_step(...)[1]`` does not trace ``forward``'s embedding
    gather on this JAX version (``DuplicateSpecError``; ROADMAP queue 3).
    The port trains its 30 steps."""
    got, data = _same_as_far_as_the_reference_goes(
        "quickstart", monkeypatch, capsys, tmp_path
    )
    assert got[-1] == "quickstart complete."
    assert len(data["train"]["losses"]) == 30
    _finite_and_falling(data["train"]["losses"])
    gemm = data["gemm"]
    for x, w, o in zip(gemm["xs"], gemm["ws"], gemm["outs"]):
        torch.testing.assert_close(o, x @ w, rtol=1e-4, atol=1e-4)


def test_partitioned_training_matches_the_reference_and_restores(
    monkeypatch, capsys, tmp_path
):
    """The reference prints its grants line, then fails: its
    ``make_train_step(...)[1]`` does not trace ``forward``'s embedding
    gather on this JAX version (``ShardingTypeError``; ROADMAP queue 3).
    The port trains both tenants, restores llama from step 20 and leaves
    no checkpoint behind."""
    got, data = _same_as_far_as_the_reference_goes(
        "partitioned_training", monkeypatch, capsys, tmp_path
    )
    assert got[-1] == "done."
    assert data["grants"] == {"llama": "1x1@0"}
    assert [len(v) for v in data["losses"].values()] == [20, 10]
    for losses in data["losses"].values():
        _finite_and_falling(losses)
    assert data["restored_step"] == 20
    restored, trained = data["restored"], data["trained"]
    from repro_torch._tree import leaves

    for a, b in zip(leaves(restored), leaves(trained), strict=True):
        assert torch.equal(a, b)
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["tmp"]
    assert list((tmp_path / "port" / "tmp").iterdir()) == []
