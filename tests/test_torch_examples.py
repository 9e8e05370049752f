"""The port's host example programs against the reference's.

Each of ``examples_torch/{open_loop_serving,fair_sharing,chaos_serving,
memory_contention,overload_serving,trace_viewer}.py`` is host arithmetic on
``repro_torch`` (the serving, chaos, overload and obs paths), so its stdout
is byte for byte the one of ``examples/`` of the same name, for its
default run and for each of its flags; ``trace_viewer``'s two files too.
The three examples that put tensors on a device are held in
``test_torch_examples_device.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from _examples import PORT, REFERENCE, names, run_port, run_reference

CASES = [
    ("open_loop_serving", []),
    ("open_loop_serving", ["--preemption"]),
    ("fair_sharing", []),
    ("fair_sharing", ["--trace"]),
    ("fair_sharing", ["--sharded"]),
    ("chaos_serving", []),
    ("chaos_serving", ["--seed", "7"]),
    ("chaos_serving", ["--none"]),
    ("memory_contention", []),
    ("memory_contention", ["--capacity", "0.25"]),
    ("overload_serving", []),
    ("overload_serving", ["--load", "1.2"]),
    ("trace_viewer", []),
]

# the files an example writes into the working directory
WRITES = {
    "trace_viewer": ("trace_viewer.perfetto-trace.json", "trace_viewer.timeline.csv"),
}

DEVICE_EXAMPLES = ("multi_tenant_serving", "partitioned_training", "quickstart")


def _id(case):
    name, argv = case
    return " ".join([name, *argv])


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_host_example_prints_what_the_reference_prints(
    case, tmp_path, monkeypatch, capsys
):
    name, argv = case
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    want, error = run_reference(name, argv, monkeypatch, capsys)
    assert error is None, error
    monkeypatch.chdir(tmp_path / "port")
    got, data = run_port(name, argv, capsys)
    assert got == want
    assert isinstance(data, dict) and data
    for written in WRITES.get(name, ()):
        ref = (tmp_path / "ref" / written).read_bytes()
        assert (tmp_path / "port" / written).read_bytes() == ref, written
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        WRITES.get(name, ())
    )


def test_every_reference_example_has_its_port():
    assert names(PORT) == names(REFERENCE)
    hosted = {name for name, _ in CASES}
    assert sorted(hosted | set(DEVICE_EXAMPLES)) == names(REFERENCE)


@pytest.mark.parametrize("name", [n for n, argv in CASES if not argv])
def test_host_example_needs_no_card(name, monkeypatch, tmp_path, capsys):
    """The host examples put nothing on a device: they run where CUDA
    is absent, and launch no partitioned-GEMM kernel."""
    import repro_torch.kernels as K

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    K.reset_launch_counts()
    run_port(name, [], capsys)
    assert K.launch_counts() == {"dense": 0, "compact": 0}
