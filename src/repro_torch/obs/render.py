"""Terminal rendering of registry/tracer summaries + host-cache snapshots —
the port's own copy of ``repro.obs.render``.

``render_summary`` prints the aligned counter/gauge/histogram/series table
of one registry (and tracer).

``snapshot_host_caches`` folds the process-global memo/cache statistics of
the costing and kernel paths into registry counters:

* ``oracle.layer_cost.{hits,misses}`` — the simulator backend's per-layer
  cost LRU (`repro_torch.sim.systolic.layer_cost`);
* ``oracle.ws_cost.{hits,misses}`` — the dataflow cost memo
  (`repro_torch.core.dataflow.ws_cost_cache_stats`);
* ``kernel.autotune.{hits,misses}`` — the fused-GEMM block autotuner LRU
  (`repro_torch.kernels.ops.autotune_blocks`).  The port's kernel module
  needs only torch, so it is read directly: no fallback hides the kernel
  path.

These are *cumulative process-wide* numbers (lru_cache has no reset), so
snapshot deltas across calls are the per-run view.
"""

from __future__ import annotations

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import Tracer


def snapshot_host_caches(
    registry: MetricsRegistry | None = None,
) -> MetricsRegistry:
    """Fold the host-side cost/kernel cache stats into ``registry`` (a new
    one when None) as counters; returns the registry."""
    from repro_torch.core.dataflow import ws_cost_cache_stats
    from repro_torch.kernels.ops import autotune_blocks
    from repro_torch.sim.systolic import layer_cost

    reg = registry if registry is not None else MetricsRegistry()
    ws = ws_cost_cache_stats()
    reg.counter("oracle.ws_cost.hits").value = ws["hits"]
    reg.counter("oracle.ws_cost.misses").value = ws["misses"]
    info = layer_cost.cache_info()
    reg.counter("oracle.layer_cost.hits").value = info.hits
    reg.counter("oracle.layer_cost.misses").value = info.misses
    info = autotune_blocks.cache_info()
    reg.counter("kernel.autotune.hits").value = info.hits
    reg.counter("kernel.autotune.misses").value = info.misses
    return reg


def _hit_rate(hits: int, misses: int) -> str:
    total = hits + misses
    if not total:
        return "-"
    return f"{100.0 * hits / total:.1f}%"


def render_summary(
    registry: MetricsRegistry | None = None,
    tracer: Tracer | None = None,
    title: str = "obs summary",
) -> str:
    """Aligned terminal table of one registry (+ optional tracer) state."""
    lines = [f"# {title}"]
    if registry is not None:
        counters = dict(sorted(registry.counters.items()))
        # pair up ".hits"/".misses" counters into one hit-rate row
        done = set()
        for name in counters:
            if name.endswith(".hits"):
                base = name[: -len(".hits")]
                m = f"{base}.misses"
                if m in counters:
                    h, mi = counters[name].value, counters[m].value
                    lines.append(
                        f"{base:<40}{h + mi:>12} calls  "
                        f"{_hit_rate(h, mi):>7} hit"
                    )
                    done.update((name, m))
        for name, c in counters.items():
            if name not in done:
                lines.append(f"{name:<40}{c.value:>12}")
        for name, g in sorted(registry.gauges.items()):
            lines.append(f"{name:<40}{g.value:>12.6g}")
        for name, h in sorted(registry.histograms.items()):
            lines.append(
                f"{name:<40}{h.count:>12} obs    mean {h.mean:.6g}  "
                f"max {h.max if h.count else float('nan'):.6g}"
            )
        for name, s in sorted(registry.series_map.items()):
            lines.append(
                f"{name:<40}{s.n_offered:>12} pts    mean {s.mean:.6g}  "
                f"last {s.last if s.last is not None else float('nan'):.6g}"
            )
    if tracer is not None:
        for kind, n in tracer.counts_by_kind().items():
            lines.append(f"trace.{kind:<34}{n:>12}")
        if tracer.n_dropped:
            lines.append(
                f"{'trace.dropped(ring overflow)':<40}"
                f"{tracer.n_dropped:>12}"
            )
    if len(lines) == 1:
        lines.append("(empty)")
    return "\n".join(lines)
