"""Build the CUDA kernels at first use and bind them with ``ctypes``.

``nvcc`` compiles ``csrc/partitioned_matmul.cu`` for ``sm_90a`` into a
shared library with a plain C interface.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, named by a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is loaded as it is.  ``ptxas -v`` (registers, shared memory
and spills of every kernel instantiation) is kept beside it in
``ptxas.log``.  Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "partitioned_matmul.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# seconds the last build took (0.0 when the library was already built)
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libpartitioned_matmul.so"


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, compiled on the first call of the process."""
    global last_build_seconds
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # compile to a private name, then rename: a concurrent builder or a
        # killed build never leaves a half-written library under the real name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True,
                text=True,
            )
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            (so.parent / "ptxas.log").write_text(proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    # every pointer, the stream included, is c_void_p: without argtypes
    # ctypes would pass a Python int as a 32-bit C int and cut the address
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pm_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.pm_layout.restype = i32
    lib.pm_launch.argtypes = [i32, i32, ptr, i32, ptr]
    lib.pm_launch.restype = i32
    return lib


LAYOUT_FIELDS = (
    "params_bytes",
    "buffers_offset",
    "tenants_offset",
    "tenant_bytes",
    "segments_offset",
    "segment_bytes",
    "max_buffers",
    "max_tenants",
    "max_segments",
    "tile_rows_float32",
    "tile_cols_float32",
    "tile_rows_bfloat16",
    "tile_cols_bfloat16",
    "tile_narrow",
    "zero_rows",
    "smem_float32",
    "smem_bfloat16",
    "k_slice_float32",
    "k_slice_bfloat16",
)


@functools.cache
def layout() -> dict[str, int]:
    """The launch table's C layout and the CTA geometry, as the library
    reports them (see ``pm_layout`` in the source)."""
    vals = (ctypes.c_int * len(LAYOUT_FIELDS))()
    load().pm_layout(vals)
    return dict(zip(LAYOUT_FIELDS, vals))


def ptxas_log() -> str:
    """What ``ptxas -v`` said when the library was built."""
    return (library_path().parent / "ptxas.log").read_text()
