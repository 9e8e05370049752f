"""Plain reference of a GEMM-rounds configuration, and its comparison.

Each tenant's GEMM ``x @ w`` is worked out again here from the operands the
benchmark drew, in float32 with TF32 off (plain ``torch.matmul``, no kernel
of the program), a block of rows at a time so that it fits beside the
program's outputs.  The number compared is a GEMM's *gap*: the largest
absolute difference between the program's output and the reference over the
reference's largest magnitude.  A check takes the worst gap over every
tenant's output of the checked round.

The control is this reference computed from operands rounded to float8
(e4m3), the precision below the configuration's bfloat16: ``control``
stands in the program's place and must read above the limit.

Imports torch only: nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

# the limit on the worst gap, set between the program's largest reading
# over a dozen seeds and more (1.35e-5, table1-heavy) and the float8
# control's smallest (0.0431, table1-light), on the card; PERF.md §2
LIMITS = {"max_rel_err": 1e-3}

# elements of a reference block (rows x N, float32)
BLOCK_ELEMS = 1 << 26


@contextlib.contextmanager
def full_float32():
    """float32 matmuls in full float32: TF32 off for the block."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def _rows(t: int, n: int) -> int:
    return max(1, min(t, BLOCK_ELEMS // max(n, 1)))


def gap(x: torch.Tensor, w: torch.Tensor, out) -> float:
    """max |out - x @ w| / max |x @ w| in float32; ``inf`` where ``out`` is
    not a (T, N) tensor or holds a value that is not finite."""
    t, n = x.shape[0], w.shape[1]
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != (t, n):
        return math.inf
    wf = w.float()
    worst = peak = 0.0
    with full_float32():
        for a in range(0, t, _rows(t, n)):
            b = min(t, a + _rows(t, n))
            ref = x[a:b].float() @ wf
            got = out[a:b].to(device=ref.device, dtype=torch.float32)
            diff = (got - ref).abs().max().item()
            if not math.isfinite(diff):
                return math.inf
            worst = max(worst, diff)
            peak = max(peak, ref.abs().max().item())
    if peak == 0.0:
        return 0.0 if worst == 0.0 else math.inf
    return worst / peak


def worst_gap(gemms) -> tuple[float, int, int]:
    """Over ``(x, w, out)`` triples: the worst gap, the GEMMs compared and
    the GEMMs whose gap is over the limit."""
    worst, over, seen = 0.0, 0, 0
    for x, w, out in gemms:
        g = gap(x, w, out)
        seen += 1
        over += not g <= LIMITS["max_rel_err"]
        worst = max(worst, g)
    return worst, seen, over


def _fp8(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float8_e4m3fn).float()


def control(xs, ws, **_kw) -> list[torch.Tensor]:
    """The control, in the program's place: every tenant's ``x @ w`` from
    operands rounded to float8 e4m3, float32 products, TF32 off."""
    outs = []
    with full_float32():
        for x, w in zip(xs, ws):
            t, n = x.shape[0], w.shape[1]
            out = torch.empty((t, n), dtype=torch.float32, device=x.device)
            w8 = _fp8(w)
            step = _rows(t, n)
            for a in range(0, t, step):
                out[a : a + step] = _fp8(x[a : a + step]) @ w8
            outs.append(out)
    return outs
