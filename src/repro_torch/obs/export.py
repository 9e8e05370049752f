"""Trace/timeline exporters — the port's own copy of ``repro.obs.export``:
Chrome trace-event (Perfetto) JSON and CSV.

``chrome_trace`` converts a :class:`~repro_torch.obs.tracer.Tracer` buffer into
the Chrome trace-event format that https://ui.perfetto.dev (and
``chrome://tracing``) loads directly:

* one **process track per array node** (``pid`` = node index, named via
  ``process_name`` metadata);
* one **thread lane per tenant** within its node (``tid`` assigned in
  first-appearance order, named via ``thread_name`` metadata) — a
  tenant's stage-in / compute / stage-out / drain spans render as
  ``ph:"X"`` complete slices on its lane;
* **instant markers** (``ph:"i"``) for arrivals, dispatch choices,
  policy decision audits, preemptions, migrations and completions.

Timestamps are simulation seconds scaled to microseconds (the format's
unit), so a 3 ms serve run renders as a 3000 µs timeline.  Everything is
emitted in deterministic order — two exports of the same run are
byte-identical (the obs bench gates this).

``timeline_csv`` flattens a registry's retained series points into a
``series,t,value`` CSV string for spreadsheet/pandas consumption.
"""

from __future__ import annotations

import json

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import Tracer

_US = 1e6  # trace-event timestamps are microseconds


def chrome_trace(tracer: Tracer, fleet_name: str = "repro") -> dict:
    """Build a Chrome trace-event JSON object from the tracer buffer."""
    events: list[dict] = []
    # lane assignment: tid 0 is the node's control lane (markers with no
    # tenant); tenants get 1.. in first-appearance order per node
    lanes: dict[tuple[int, str], int] = {}
    next_lane: dict[int, int] = {}
    nodes_seen: list[int] = []

    def lane(node: int, tenant: str | None) -> int:
        if node not in next_lane:
            next_lane[node] = 1
            nodes_seen.append(node)
        if tenant is None:
            return 0
        key = (node, tenant)
        tid = lanes.get(key)
        if tid is None:
            tid = lanes[key] = next_lane[node]
            next_lane[node] = tid + 1
        return tid

    for kind, t0, t1, node, tenant, args in tracer.raw():
        ev: dict = {
            "name": kind if tenant is None else f"{kind}:{tenant}",
            "cat": kind,
            "pid": node,
            "tid": lane(node, tenant),
            "ts": t0 * _US,
        }
        if t1 > t0:
            ev["ph"] = "X"
            ev["dur"] = (t1 - t0) * _US
        else:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant marker
        if args:
            ev["args"] = dict(args)
        events.append(ev)

    meta: list[dict] = []
    for node in sorted(nodes_seen):
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": node,
                "tid": 0,
                "args": {"name": f"array-node-{node}"},
            }
        )
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": node,
                "tid": 0,
                "args": {"name": "scheduler"},
            }
        )
    for (node, tenant), tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": node,
                "tid": tid,
                "args": {"name": tenant},
            }
        )
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "fleet": fleet_name,
            "events_recorded": tracer.n_recorded,
            "events_dropped": tracer.n_dropped,
        },
    }


def write_chrome_trace(path: str, tracer: Tracer, fleet_name: str = "repro") -> dict:
    """Write the Perfetto-loadable JSON to ``path``; returns the object."""
    blob = chrome_trace(tracer, fleet_name=fleet_name)
    with open(path, "w") as f:
        json.dump(blob, f, indent=1)
        f.write("\n")
    return blob


def timeline_csv(registry: MetricsRegistry) -> str:
    """Flatten every retained series point to ``series,t,value`` rows."""
    lines = ["series,t,value"]
    for name, series in sorted(registry.series_map.items()):
        for t, v in series.samples:
            lines.append(f"{name},{t!r},{v!r}")
    return "\n".join(lines) + "\n"
