"""Ring-buffered structured tracer — the port's own copy of
``repro.obs.tracer``: bounded-memory span/event capture.

The serving stack records almost nothing while it runs.  Only *rare*
instants are recorded live against the simulation clock (preemption,
migration, policy decision audits — events whose inputs exist only at
the moment they fire); everything else is **derived lazily** from
records the baseline was building anyway:

* per-job instants (dispatch choice, scheduler arrival, completion)
  convert from the simulator's job-record builders at read time
  (:meth:`attach_source`);
* per-layer *spans* (a tenant's stage-in / compute / stage-out / drain
  window on one array node) convert from the
  :class:`~repro_torch.core.scheduler.TraceEvent` records the scheduler
  maintains on its ``keep_trace=True`` path (:meth:`attach`).

That split is what keeps the armed overhead inside the traffic bench's
≤5% gate (``chip_smoke.py``'s serve phase): the hot event loop pays for a
couple of attribute stores per job, while the event stream materializes
only when a trace is actually read or exported — recording it a second
time at run time would double the cost for zero information.

* one ``collections.deque(maxlen=...)`` holds the newest ``max_events``
  live records — memory is bounded no matter how long the open-loop
  horizon runs, and an overflowing ring silently drops the *oldest*
  events (``n_dropped`` counts them, the summary renderer surfaces it);
* lazy sources are registered at end-of-run, after they stopped
  growing, and converted+cached on first read.  Runs with
  ``keep_trace=False`` (bounded-memory serving mode) therefore carry no
  spans — the span source was explicitly dropped;
* timestamps are simulation seconds (the scheduler's event clock), never
  wall time, so a trace is deterministic under a fixed seed and two runs
  export byte-identical Chrome/Perfetto JSON.

Records are ``(kind, t0, t1, node, tenant, args)`` tuples; ``args`` is a
(possibly empty) tuple of ``(key, value)`` pairs.  Spans have ``t1 > t0``;
instants carry ``t1 == t0``.  :class:`TraceEvent` is the friendly read
view (:meth:`Tracer.events`); exporters may read the raw tuples.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

# span kinds (t1 > t0)
STAGE_IN = "stage_in"
COMPUTE = "compute"
STAGE_OUT = "stage_out"
DRAIN = "drain"
# instant kinds (t1 == t0)
ARRIVE = "arrive"
DISPATCH = "dispatch"
DECISION = "decision"
PREEMPT = "preempt"
MIGRATE = "migrate"
COMPLETE = "complete"
# fault-injection instants (repro_torch.chaos): fault applied, belief
# transition detected, lost job's first post-retry completion
FAULT = "fault"
DETECT = "detect"
RECOVER = "recover"
# overload-control instant (repro_torch.overload): brownout stage entry/exit
BROWNOUT = "brownout"

SPAN_KINDS = (STAGE_IN, COMPUTE, STAGE_OUT, DRAIN)
INSTANT_KINDS = (
    ARRIVE,
    DISPATCH,
    DECISION,
    PREEMPT,
    MIGRATE,
    COMPLETE,
    FAULT,
    DETECT,
    RECOVER,
    BROWNOUT,
)


def _ORDER(r: tuple) -> tuple:
    """Merge order for materialized streams: start, end, node, kind,
    tenant — a total order over well-formed records, so exports are
    deterministic regardless of which buffer (ring, attached trace,
    absorbed pod) a record came from."""
    return (r[1], r[2], r[3], r[0], r[4] or "")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """Read view of one raw tracer record."""

    kind: str
    t0: float
    t1: float
    node: int
    tenant: str | None
    args: tuple

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    @property
    def is_span(self) -> bool:
        return self.t1 > self.t0


def _trace_spans(node: int, events) -> list[tuple]:
    """Convert one scheduler ``trace`` list into raw span tuples.

    One per-layer scheduler record fans out to up to three spans: the
    stage-in window (assignment → compute start: bus wait + transfer),
    the compute segment, and the tail — stage-out for a completed
    segment, partial-sum drain for a preempted one.  Preempt *instants*
    are emitted live by the scheduler (they must survive
    ``keep_trace=False``), so they are deliberately not derived here.
    """
    out = []
    for e in events:
        tenant = e.tenant
        if e.compute_start > e.start:
            out.append((STAGE_IN, e.start, e.compute_start, node, tenant, ()))
        if e.compute_end > e.compute_start:
            args = (
                ("layer", e.layer_name),
                ("cols", e.partition.cols),
                ("col_start", e.partition.col_start),
                ("fraction", e.fraction),
                ("resumed", e.resumed),
            )
            if e.preempted:
                args += (("preempted", True),)
            out.append((COMPUTE, e.compute_start, e.compute_end, node, tenant, args))
        if e.end > e.compute_end:
            kind = DRAIN if e.preempted else STAGE_OUT
            out.append((kind, e.compute_end, e.end, node, tenant, ()))
    return out


class Tracer:
    """Bounded ring buffer of live records + lazily-converted span sources.

    ``max_events`` bounds the ring; the newest events win.  Record
    methods are plain tuple appends — callers guard with ``if tracer is
    not None`` so the disabled path costs nothing.
    """

    __slots__ = ("max_events", "_n", "_buf", "_attached")

    def __init__(self, max_events: int = 65536):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self._n = 0  # live records ever offered to the ring
        self._buf: collections.deque = collections.deque(maxlen=max_events)
        # [zero-arg conversion callable, cached record list | None];
        # sources are attached at end-of-run, after they stopped
        # growing, so the conversion is cached on first read
        self._attached: list[list] = []

    # -- recording (hot path) ------------------------------------------------
    def span(
        self,
        kind: str,
        t0: float,
        t1: float,
        node: int = 0,
        tenant: str | None = None,
        args: tuple = (),
    ) -> None:
        self._n += 1
        self._buf.append((kind, t0, t1, node, tenant, args))

    def instant(
        self,
        kind: str,
        t: float,
        node: int = 0,
        tenant: str | None = None,
        args: tuple = (),
    ) -> None:
        self._n += 1
        self._buf.append((kind, t, t, node, tenant, args))

    def attach(self, node: int, trace: list) -> None:
        """Register one scheduler's per-layer ``trace`` as a span source.

        Zero-copy: the list is held by reference and converted to span
        tuples on first read.  Call once per node at end of run (the
        simulator does this automatically when ``keep_trace`` is on).
        """
        self._attached.append([lambda: _trace_spans(node, trace), None])

    def attach_source(self, convert) -> None:
        """Register any zero-argument callable returning a list of raw
        record tuples as a lazy source, evaluated and cached on first
        read.  The simulator uses this to derive per-job instants from
        the job records it builds anyway — nothing is recorded on the
        serving path."""
        self._attached.append([convert, None])

    # -- reading -------------------------------------------------------------
    def _attached_records(self) -> list[tuple]:
        out: list[tuple] = []
        for entry in self._attached:
            cached = entry[1]
            if cached is None:
                cached = entry[1] = entry[0]()
            out.extend(cached)
        return out

    def __len__(self) -> int:
        return len(self._buf) + len(self._attached_records())

    @property
    def n_recorded(self) -> int:
        """Total events captured: live ring records (including any the
        ring has since dropped) plus spans derived from attached traces."""
        return self._n + len(self._attached_records())

    @property
    def n_dropped(self) -> int:
        """Live events lost to ring overflow (oldest-first).  Attached
        spans never drop — they live in the scheduler's own trace."""
        return self._n - len(self._buf)

    def raw(self) -> list[tuple]:
        """The materialized record stream (ring + derived spans), merged
        into deterministic ``(t0, t1, node, kind, tenant)`` order."""
        return sorted(list(self._buf) + self._attached_records(), key=_ORDER)

    def events(self) -> Iterator[TraceEvent]:
        """The materialized records as :class:`TraceEvent` views."""
        for kind, t0, t1, node, tenant, args in self.raw():
            yield TraceEvent(kind, t0, t1, node, tenant, args)

    def counts_by_kind(self) -> dict[str, int]:
        """Histogram by kind over the *retained* stream (sorted keys):
        ring survivors plus derived spans; ``n_dropped`` says how many
        live records overflowed out before counting."""
        counts: dict[str, int] = {}
        for r in self._buf:
            k = r[0]
            counts[k] = counts.get(k, 0) + 1
        for r in self._attached_records():
            k = r[0]
            counts[k] = counts.get(k, 0) + 1
        return dict(sorted(counts.items()))

    # -- merging (sharded pods) ----------------------------------------------
    def state(self) -> dict:
        """Picklable snapshot for cross-process folding: the materialized
        stream bounded to the newest ``max_events`` records."""
        return {
            "max_events": self.max_events,
            "n_recorded": self.n_recorded,
            "records": self.raw()[-self.max_events :],
        }

    def absorb(self, state: dict) -> None:
        """Fold one pod's :meth:`state` into this tracer.  Records are
        interleaved by start time with a stable tie-break so the merged
        stream is deterministic regardless of pod arrival order; overflow
        drops the oldest merged records, same as live recording."""
        self._n += state["n_recorded"]
        merged = sorted(
            list(self._buf) + [tuple(r) for r in state["records"]],
            key=_ORDER,
        )
        self._buf.clear()
        self._buf.extend(merged[-self.max_events :])
