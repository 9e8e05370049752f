"""The traced run's record, read from ``torch.profiler``'s chrome trace.

``drivers/gemm_rounds.py`` marks each profiled round (``cardbench.round``;
the profiler's own warm-up round is ``cardbench.warmup``), wave and wait
with a ``record_function`` span; the profiler (CUPTI) adds every device
operation.  Both lie on one clock in the trace.  The
traced window runs from the first device operation's start (the first
round span's where there is none) to the end of the last device operation
or round span, whichever is later.
"""

from __future__ import annotations

import json
from pathlib import Path

# chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "cardbench."
TOP = 10


def profiler():
    """A profiler over the host and, where there is one, the card."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(prof, path: Path) -> dict:
    """Write the chrome trace to ``path`` and read it back.

    Returns ``window_s``, ``busy_s`` (the union of device operations within
    the window), ``device`` (every device operation as ``(name, start_us,
    dur_us)``, in start order),
    ``device_ops`` (the ``TOP`` device operations by total seconds) and
    ``idle_gaps`` (the ``TOP`` longest gaps with no device operation, each
    named by the innermost ``cardbench.`` span the host was in at its
    start).  A trace without device operations reads ``busy_s`` 0."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((e.get("name", ""), ts, dur))
        elif e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN):
            spans.append((e["name"][len(SPAN) :], ts, dur))
    rounds = [s for s in spans if s[0].startswith("round")]
    if not rounds:
        empty: dict = {"device": [], "device_ops": [], "idle_gaps": []}
        return {"window_s": 0.0, "busy_s": 0.0, **empty}
    # the rounds loop drains the device before the traced rounds, so the
    # window opens with their first device operation, not with the host's first
    # enqueue into an empty queue; what ran before (the profiler's warm-up
    # round) is left out
    first = min(ts for _, ts, _ in rounds)
    device = sorted((e for e in device if e[1] >= first), key=lambda e: e[1])
    start = device[0][1] if device else first
    end = max([ts + d for _, ts, d in rounds] + [ts + d for _, ts, d in device])
    busy = _merge(
        (max(ts, start), min(ts + d, end)) for _, ts, d in device if ts + d > start
    )
    busy_us = sum(b - a for a, b in busy)

    by_name: dict = {}
    for name, _, d in device:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps, prev = [], start
    for a, b in busy + [[end, end]]:
        if a > prev:
            gaps.append((prev, a - prev))
        prev = max(prev, b)
    inner = sorted(spans, key=lambda s: s[2])  # shortest span first = innermost

    def host_at(t):
        for name, ts, d in inner:
            if ts <= t < ts + d:
                return name
        return "outside any span"

    gaps.sort(key=lambda g: -g[1])
    idle_gaps = [[host_at(t), d * 1e-6] for t, d in gaps[:TOP]]
    return {
        "window_s": (end - start) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device": device,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": idle_gaps,
    }
