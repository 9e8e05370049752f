"""The port's rules: no JAX, nothing of ``repro``, and CUDA by default."""

import ast
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(path):
    """Imports of jax or repro, and any use of a name ``jax``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            if isinstance(node, ast.Name) and node.id == "jax":
                bad.append(f"line {node.lineno}: name jax")
            continue
        for m in mods:
            top = m.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"line {node.lineno}: import {m}")
    return bad


def test_scan_sees_every_module():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert len(files) >= 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_repro_imports(path):
    assert _forbidden(path) == []


def test_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import dnng\nx = jax\n")
    assert len(_forbidden(str(src))) == 3


def _creating_calls():
    from repro_torch.configs import get
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.serving.kv_cache import DecodeSession

    cfg = get("llama3.2-3b").smoke
    return {
        "init_params": lambda: init_params(cfg),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "params_from_jax": lambda: params_from_jax({"w": [[1.0]]}),
        "DecodeSession": lambda: DecodeSession(cfg, {}, 1, 8),
    }


@pytest.mark.parametrize(
    "entry", ["init_params", "init_cache", "params_from_jax", "DecodeSession"]
)
def test_creating_entry_points_default_to_cuda(entry, monkeypatch):
    """Without ``device=`` an entry point that creates tensors targets
    CUDA, and raises where there is none — never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _creating_calls()[entry]()


def test_kernel_wrapper_never_falls_back_on_an_unknown_device():
    from repro_torch.kernels import partitioned_matmul

    xs = torch.zeros((1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        partitioned_matmul(xs, torch.zeros((128, 128), device="meta"), [0], [128])
