"""What the fused GEMM's launches did, and where their host time went.

One store per process.  Its counters are always on: every launch adds one
to its launch table's own counter, and the store sums each table's
launches times its numbers (:class:`TableCounts`, worked out once per
table) when it is read.  The host phases of a card call are timed, and
marked as ``torch.profiler`` spans, only while tracing is armed
(:func:`set_tracing`):

* ``prepare``: shape and dtype checks, the grid-mode choice (from the
  tenants' shapes), the per-operand device and stride reads;
* ``alloc``: the output ``torch.empty``;
* ``table``: the launch-table lookup (or build) and its packing;
* ``launch``: the device check, the stream handle, the library, the ctypes
  launch and the counters.

The launcher in the kernels' library counts too: the live operands of
its bfloat16 launches by the feed it gave them (:data:`FEEDS`), which
``launch_stats`` reads from the library and ``reset_launch_stats`` zeroes
there.

Armed, each phase adds its host nanoseconds (``time.perf_counter_ns``) and
one call to the store; while a profiler records, each phase is also a
``record_function`` span named ``repro_torch.gemm.<phase>``, on the clock of
the profiler's device events.  Disarmed (the default), a call reads one
module global and makes no timer and no span.  The CPU path launches
nothing and records no phase.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

PHASES = ("prepare", "alloc", "table", "launch")
SPAN_PREFIX = "repro_torch.gemm."
_SPANS = tuple(SPAN_PREFIX + p for p in PHASES)

# read at every call of the card path: the one cost of tracing when off
armed = False


class TableCounts(NamedTuple):
    """One launch of a launch table, counted from the table: 1 where it is
    the dense kernel's (0 the compact's), its tiles (a float32 CTA runs one;
    the bfloat16 kernel's persistent CTAs share them), those that run a K
    loop, those that only write zeros (the rest, past the caller's rows, are
    skipped), the
    multiply-adds the K loops issue (whole tiles of the shape that ran, the
    depth rounded up to the dtype's K slice), those the tenants' GEMMs need,
    and those of the issued ones whose x or w row pitch is not a 16-byte
    multiple, which rules out 16-byte copies (the staged feed).  The table
    knows pitches, not addresses: a tile staged for an operand's origin, or
    for want of a tensor map, is not counted there; the launcher's own
    choice for each operand is counted by feed (``launch_stats()["feed"]``,
    :data:`FEEDS`)."""

    dense: int
    ctas: int
    mac_ctas: int
    fill_ctas: int
    macs_issued: int
    macs_useful: int
    feed_staged_macs: int


# the feeds the launcher counts the live operands of bfloat16 launches by
# (x of each live tenant, w of each live segment): a tensor map of their
# own, a map shared with other operands of one storage, the staged feed
FEEDS = ("own_map", "shared_map", "staged")


def _feed_counts(reset: bool = False) -> dict[str, int]:
    """The launcher's counters by feed, from the library where this
    process has loaded it (zeros where it has not), zeroed there after the
    read where ``reset``."""
    lib = _build.loaded
    if lib is None:
        return dict.fromkeys(FEEDS, 0)
    v = (ctypes.c_longlong * len(FEEDS))()
    lib.pm_feed_counts(v, int(reset))
    return dict(zip(FEEDS, v))


# a launch adds one to its table's own counter (``LaunchTable.launched``);
# the store watches each counter from its first launch and sums counter
# times counts when it is read, or when FOLD counters are watched
FOLD = 256


class _Store:
    __slots__ = ("launches", "totals", "watched", "table_builds", "phase_ns",
                 "phase_calls")

    def __init__(self) -> None:
        self.launches = 0
        self.totals = [0] * len(TableCounts._fields)
        self.watched: list[tuple[TableCounts, list[int], int]] = []
        self.table_builds = 0
        self.phase_ns = [0] * len(PHASES)
        self.phase_calls = [0] * len(PHASES)

    def fold(self) -> None:
        """Add every watched counter's launches into the totals and zero it;
        its next launch has it watched again."""
        watched, self.watched = self.watched, []
        for counts, launched, i in watched:
            n, launched[i] = launched[i], 0
            self.launches += n
            for j, v in enumerate(counts):
                self.totals[j] += n * v


_store = _Store()


def set_tracing(on: bool) -> bool:
    """Arm (``True``) or disarm the phase timers and spans; returns the
    previous state."""
    global armed
    was, armed = armed, bool(on)
    return was


def launch_stats() -> dict:
    """The store since the process started or the last reset: ``launches``
    by kind; ``ctas``, ``mac_ctas``, ``fill_ctas`` (tiles);
    ``macs_issued``, ``macs_useful``, ``feed_staged_macs``
    (multiply-adds); ``table_builds``
    (launch tables built, not found in their cache); ``feed``, the live
    operands of bfloat16 launches by the feed the launcher gave them
    (:data:`FEEDS`); and per phase the armed calls (``phase_calls``) and
    their host nanoseconds (``phase_ns``)."""
    s = _store
    s.fold()
    out = dict(zip(TableCounts._fields, s.totals))
    dense = out.pop("dense")
    return {
        "launches": {"dense": dense, "compact": s.launches - dense},
        **out,
        "table_builds": s.table_builds,
        "feed": _feed_counts(),
        "phase_calls": dict(zip(PHASES, s.phase_calls)),
        "phase_ns": dict(zip(PHASES, s.phase_ns)),
    }


def reset_launch_stats() -> None:
    global _store
    _feed_counts(reset=True)
    for _, launched, i in _store.watched:
        launched[i] = 0
    _store = _Store()


def launch_counts() -> dict[str, int]:
    """Kernel launches since the process started or the last reset."""
    return launch_stats()["launches"]


reset_launch_counts = reset_launch_stats


def watch(counts: TableCounts, launched: list[int], i: int) -> None:
    """Watch ``launched[i]``, a table's launch counter that has just counted
    its first launch since the store last summed it; each of its launches
    adds ``counts``."""
    s = _store
    s.watched.append((counts, launched, i))
    if len(s.watched) >= FOLD:
        s.fold()


def count_table_build() -> None:
    _store.table_builds += 1


# whether a profiler records now (0.1 us a call; read only when armed)
_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span named ``name`` where tracing is armed and
    a profiler records; otherwise one shared context that does nothing."""
    if armed and _profiling():
        return torch.profiler.record_function(name)
    return _NULL


class Clock:
    """The phases of one armed card call, from its entry: each :meth:`mark`
    ends the current phase (its host ns and a call into the store) and
    begins the next.  Under a profiler (as found at the entry) each phase is
    a span too, opened and closed outside the timed intervals; otherwise one
    clock read marks both the end of a phase and the start of the next."""

    __slots__ = ("phase", "t", "span")

    def __init__(self) -> None:
        self.phase = 0
        self.span = _open(0) if _profiling() else None
        self.t = time.perf_counter_ns()

    def mark(self) -> None:
        t = time.perf_counter_ns()
        i = self.phase
        s = _store
        s.phase_ns[i] += t - self.t
        s.phase_calls[i] += 1
        self.phase = i = i + 1
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = _open(i) if i < len(PHASES) else None
            t = time.perf_counter_ns()
        self.t = t

    def finish(self) -> None:
        """End the call: the phases not yet begun take no time."""
        while self.phase < len(PHASES):
            self.mark()


def _open(phase: int):
    span = torch.profiler.record_function(_SPANS[phase])
    span.__enter__()
    return span
