"""Run one example program of either package and catch what it prints.

The reference's examples (``examples/*.py``) are scripts: they run at
import and read ``sys.argv``, so they are run by path under a patched
``sys.argv``.  The port's (``examples_torch/*.py``) each have
``main(argv)``, which returns what it printed as data.  Each run starts
with its package's cost-model caches cleared, as in a fresh process: a
run with obs armed prints a gauge (``oracle.calls_per_event``) read from
those process-global caches, which earlier tests in the worker warm.
"""

import importlib
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "examples")
PORT = os.path.join(ROOT, "examples_torch")


def _fresh(pkg: str) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.clear_cost_caches(pkg)


def names(folder: str) -> list[str]:
    return sorted(n[:-3] for n in os.listdir(folder) if n.endswith(".py"))


def run_reference(name, argv, monkeypatch, capsys):
    """The reference example's stdout, and the exception that stopped it
    (None where it ran to its end)."""
    path = os.path.join(REFERENCE, f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    _fresh("repro")
    capsys.readouterr()
    error = None
    try:
        runpy.run_path(path, run_name="__main__")
    except Exception as e:  # the reference faults the port does not copy
        error = e
    return capsys.readouterr().out, error


def run_port(name, argv, capsys):
    """The port example's stdout and what its ``main`` returned."""
    _fresh("repro_torch")
    main = importlib.import_module(f"examples_torch.{name}").main
    capsys.readouterr()
    got = main(list(argv))
    return capsys.readouterr().out, got
