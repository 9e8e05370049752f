"""HLO-text analysis: collective bytes and loop-aware cost for roofline terms.

Counterpart of ``repro.launch.hlo_analysis``, text in and numbers out (the
standard library only).  The port makes no HLO: here it reads HLO text
that comes from elsewhere, such as the JAX package's compiled dumps
(``compiled.as_text()``), and gives the numbers the JAX package gives for
the same text.

``cost_analysis()`` has no collective-traffic entry, so the compiled
(post-SPMD-partitioning) HLO text is parsed, the computation call graph
built, and the bytes moved by every collective op summed **per execution**
— collectives inside a ``while`` body (e.g. the lax.scan over layers) are
multiplied by the loop trip count recovered from the condition computation
(``compare(iv, constant(N)), direction=LT``).

Per-device wire-byte convention (ring algorithms; asymptotic factors):

    all-reduce        2 × tensor bytes   (reduce-scatter + all-gather)
    all-gather        1 × output bytes
    reduce-scatter    1 × input bytes ≈ output × group size ≈ gathered size
    all-to-all        1 × tensor bytes
    collective-permute 1 × tensor bytes
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter

_DTYPE_BYTES = {
    "pred": 1,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "bf16": 2,
    "f16": 2,
    "s32": 4,
    "u32": 4,
    "f32": 4,
    "s64": 8,
    "u64": 8,
    "f64": 8,
    "c64": 8,
    "f8e4m3fn": 1,
    "f8e5m2": 1,
    "c128": 16,
    "s4": 1,
    "u4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

_COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_OP_RE = re.compile(
    r"=\s+(.*?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\("
)
_COND_RE = re.compile(r"conditional\(.*?branch_computations=\{([^}]*)\}")
_TRUE_FALSE_RE = re.compile(
    r"conditional\(.*?true_computation=%?([\w\.\-_]+).*?"
    r"false_computation=%?([\w\.\-_]+)"
)
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _type_bytes(type_str: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class _Comp:
    name: str
    coll_bytes: Counter
    coll_count: Counter
    whiles: list[tuple[str, str]]  # (condition, body)
    calls: list[tuple[str, str]]  # (kind: call|fusion, name)
    conds: list[list[str]]  # branch computation groups


def _header_name(line: str) -> str | None:
    """The computation a line opens (``[ENTRY ]%name (params…) -> type {``,
    params may nest parens), or None."""
    stripped = line.strip()
    if line.startswith(" ") or "->" not in line or not stripped.endswith("{"):
        return None
    head = stripped.removeprefix("ENTRY ").strip()
    return head.split("(", 1)[0].strip().lstrip("%")


def _split_computations(hlo_text: str) -> dict[str, _Comp]:
    comps: dict[str, _Comp] = {}
    cur: _Comp | None = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        name = _header_name(line)
        if name:
            cur = _Comp(name, Counter(), Counter(), [], [], [])
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        m = _OP_RE.search(stripped)
        if m and m.group(3) != "-done":
            kind = m.group(2)
            cur.coll_bytes[kind] += _type_bytes(m.group(1)) * _COLLECTIVES[kind]
            cur.coll_count[kind] += 1
        mw = re.search(r"condition=%?([\w\.\-_]+), body=%?([\w\.\-_]+)", stripped)
        if mw and " while(" in stripped:
            cur.whiles.append((mw.group(1), mw.group(2)))
        is_fusion = " fusion(" in stripped
        for mc in re.finditer(
            r"(?:to_apply|calls|called_computation)=%?([\w\.\-_]+)", stripped
        ):
            if " while(" not in stripped:
                cur.calls.append(("fusion" if is_fusion else "call", mc.group(1)))
        mb = _COND_RE.search(stripped)
        if mb:
            cur.conds.append([b.strip().lstrip("%") for b in mb.group(1).split(",")])
        mt = _TRUE_FALSE_RE.search(stripped)
        if mt:
            cur.conds.append([mt.group(1), mt.group(2)])
    return comps


def _trip_count(cond: _Comp | None, raw_text: str) -> int:
    """Loop bound from `compare(iv, constant(N)), direction=LT` patterns."""
    if cond is None:
        return 1
    block = _comp_block(raw_text, cond.name)
    consts = [int(x) for x in _CONST_RE.findall(block)]
    return max(consts) if consts else 1


def _comp_block(hlo_text: str, name: str) -> str:
    idx = hlo_text.find(f"%{name} ")
    if idx < 0:
        idx = hlo_text.find(f"{name} ")
    if idx < 0:
        return ""
    end = hlo_text.find("\n}", idx)
    return hlo_text[idx : end if end > 0 else len(hlo_text)]


def _entry_name(hlo_text: str) -> str | None:
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            head = line.strip().removeprefix("ENTRY ")
            return head.split("(", 1)[0].strip().lstrip("%")
    return None


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        parts = [
            f"{k}×{int(self.count_by_kind[k])}:{self.bytes_by_kind[k] / 1e6:.1f}MB"
            for k in sorted(self.bytes_by_kind)
        ]
        return " ".join(parts) if parts else "none"


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Per-device, per-execution collective wire bytes (loop-aware)."""
    comps = _split_computations(hlo_text)
    entry = _entry_name(hlo_text)
    if entry is None or entry not in comps:
        # fall back: flat sum (no loop weighting)
        flat_b: Counter = Counter()
        flat_c: Counter = Counter()
        for c in comps.values():
            flat_b.update(c.coll_bytes)
            flat_c.update(c.coll_count)
        return CollectiveStats(dict(flat_b), dict(flat_c))

    memo: dict[str, tuple[Counter, Counter]] = {}
    visiting: set[str] = set()

    def visit(name: str) -> tuple[Counter, Counter]:
        if name in memo:
            return memo[name]
        if name in visiting or name not in comps:
            return Counter(), Counter()
        visiting.add(name)
        c = comps[name]
        b = Counter(c.coll_bytes)
        n = Counter(c.coll_count)
        for _kind, callee in c.calls:
            cb, cn = visit(callee)
            b.update(cb)
            n.update(cn)
        for branches in c.conds:
            # worst-case branch
            best: tuple[Counter, Counter] = (Counter(), Counter())
            for br in branches:
                cb, cn = visit(br)
                if sum(cb.values()) > sum(best[0].values()):
                    best = (cb, cn)
            b.update(best[0])
            n.update(best[1])
        for cond_name, body_name in c.whiles:
            trips = _trip_count(comps.get(cond_name), hlo_text)
            cb, cn = visit(body_name)
            for k, v in cb.items():
                b[k] += v * trips
            for k, v in cn.items():
                n[k] += v * trips
        visiting.discard(name)
        memo[name] = (b, n)
        return b, n

    b, n = visit(entry)
    return CollectiveStats(dict(b), dict(n))


def while_trip_counts(hlo_text: str) -> list[int]:
    """Trip counts of every while loop (scan extents) for sanity checks."""
    comps = _split_computations(hlo_text)
    out = []
    for c in comps.values():
        for cond_name, _body in c.whiles:
            out.append(_trip_count(comps.get(cond_name), hlo_text))
    return out


# ---------------------------------------------------------------------------
# Loop-aware FLOP / HBM-byte cost (XLA's cost_analysis() counts each while
# body ONCE — useless for lax.scan-over-layers models; this walk multiplies
# by trip counts exactly like collective_stats above).
# ---------------------------------------------------------------------------

_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w\.\-_]+)\s*=\s*(.+?)\s+([\w\-]+)\(")
_OPERANDS_RE = re.compile(r"\(((?:%[\w\.\-_]+(?:,\s*)?)+)\)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def _shape_dims(type_str: str) -> tuple[list[int], float]:
    """First shape's dims + TOTAL bytes of (possibly tuple) type."""
    dims: list[int] | None = None
    total = 0.0
    for dt, ds in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        d = [int(x) for x in ds.split(",")] if ds else []
        if dims is None:
            dims = d
        n = 1
        for x in d:
            n *= x
        total += n * _DTYPE_BYTES[dt]
    return dims if dims is not None else [], total


@dataclasses.dataclass
class _CompCost:
    flops: float = 0.0
    bytes_hbm: float = 0.0


def _operand_names(line: str, start: int) -> list[str]:
    ops = _OPERANDS_RE.search(line[start:])
    if not ops:
        return []
    return [o.strip().lstrip("%") for o in ops.group(1).split(",")]


def _comp_costs(hlo_text: str) -> tuple[dict[str, _CompCost], dict[str, _Comp]]:
    """Per-computation direct FLOPs (dot ops) + HBM bytes (fusion/dot/copy
    parameter+result traffic, XLA's bytes-accessed convention)."""
    comps = _split_computations(hlo_text)
    costs: dict[str, _CompCost] = {name: _CompCost() for name in comps}
    # %name identifiers repeat across computations — scope per computation
    shapes: dict[str, list[int]] = {}
    bytes_of: dict[str, float] = {}
    cur: str | None = None
    for line in hlo_text.splitlines():
        header = _header_name(line)
        if header is not None:
            cur = header
            shapes, bytes_of = {}, {}
            continue
        if cur is None or cur not in costs:
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, op = m.groups()
        dims, nbytes = _shape_dims(type_str)
        is_tuple = type_str.lstrip().startswith("(")
        shapes[name] = dims
        # tuples are passed by reference — only materialised elements
        # (via get-tuple-element) count as traffic
        bytes_of[name] = 0.0 if is_tuple else nbytes
        cc = costs[cur]
        operands = _operand_names(line, m.end() - 1)
        if op == "dot":
            # flops = 2 × result elements × product(contracting dims)
            res_elems = 1
            for d in dims:
                res_elems *= d
            k = 1
            mc = _CONTRACT_RE.search(line)
            if mc and operands:
                lhs_dims = shapes.get(operands[0], [])
                for ci in (int(x) for x in mc.group(1).split(",") if x):
                    if ci < len(lhs_dims):
                        k *= lhs_dims[ci]
            cc.flops += 2.0 * res_elems * k
        if op in ("dynamic-slice", "gather"):
            # reads only the slice, writes the result: ≈ 2 × result bytes
            # (charging the full stacked-weights operand would overcount
            # every scan iteration by the whole stack)
            cc.bytes_hbm += 2.0 * nbytes
        elif op in ("dynamic-update-slice", "scatter"):
            # in-place: reads the update, writes the slice ≈ 2 × update
            upd = bytes_of.get(operands[1], 0.0) if len(operands) >= 2 else 0.0
            cc.bytes_hbm += 2.0 * upd
        elif op in (
            "dot",
            "fusion",
            "copy",
            "custom-call",
            "convolution",
            "reduce",
            "sort",
            "select-and-scatter",
        ):
            # XLA bytes-accessed convention: operands + result, for ops
            # that really touch memory after fusion (layout ops excluded —
            # a TPU compile fuses them; the CPU dump leaves them around).
            total = 0.0 if is_tuple else nbytes
            for o in operands:
                total += bytes_of.get(o, 0.0)
            cc.bytes_hbm += total
    return costs, comps


@dataclasses.dataclass
class LoopAwareCost:
    flops: float
    bytes_hbm: float


def loop_aware_cost(hlo_text: str) -> LoopAwareCost:
    """Per-device, per-execution dot-FLOPs + HBM-byte traffic."""
    costs, comps = _comp_costs(hlo_text)
    entry = _entry_name(hlo_text)
    if entry is None or entry not in comps:
        total = _CompCost()
        for c in costs.values():
            total.flops += c.flops
            total.bytes_hbm += c.bytes_hbm
        return LoopAwareCost(total.flops, total.bytes_hbm)

    memo: dict[str, tuple[float, float]] = {}
    visiting: set[str] = set()

    def visit(name: str) -> tuple[float, float]:
        if name in memo:
            return memo[name]
        if name in visiting or name not in comps:
            return 0.0, 0.0
        visiting.add(name)
        c = comps[name]
        fl = costs[name].flops
        by = costs[name].bytes_hbm
        for kind, callee in c.calls:
            f2, b2 = visit(callee)
            fl += f2
            # fusion internals live in registers/VMEM — their dots are real
            # compute but their intermediate tensors are not HBM traffic
            # (the fusion op itself already contributed operand+result bytes)
            by += 0.0 if kind == "fusion" else b2
        for branches in c.conds:
            best = (0.0, 0.0)
            for br in branches:
                got = visit(br)
                if got[0] + got[1] > best[0] + best[1]:
                    best = got
            fl += best[0]
            by += best[1]
        for cond_name, body_name in c.whiles:
            trips = _trip_count(comps.get(cond_name), hlo_text)
            f2, b2 = visit(body_name)
            fl += f2 * trips
            by += b2 * trips
        visiting.discard(name)
        memo[name] = (fl, by)
        return fl, by

    fl, by = visit(entry)
    return LoopAwareCost(fl, by)
