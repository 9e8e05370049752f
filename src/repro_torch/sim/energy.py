"""Accelergy-style 45 nm energy model (paper §4.2 toolchain analogue).

The port's own copy of ``repro.sim.energy``.  Constants are 16-bit-datapath
energies at 45 nm from the Eyeriss/Horowitz relative-cost tables (ALU : SRAM
: DRAM ≈ 1 : 6 : 200): MAC 1.0 pJ, pass-through forward 0.12 pJ (the
Mul_En=0 tri-stated PE, paper Fig. 7), SRAM 6.0 pJ, DRAM 200 pJ, PE leakage
25 µW.

**The tri-state gate is the dynamic-energy mechanism** (paper §3.4):

* baseline      — MAC energy ∝ (cycles × *all* array PEs)
* partitioned   — MAC energy ∝ (cycles × *own partition's* PEs)
                  + forward energy ∝ (cycles × rows × col_start) pass-through

Static leakage accrues over the whole array for the whole makespan in both
modes, so the makespan reduction is the second saving mechanism.  Every sum
below keeps the reference's order of operations, so the books are the same
floats.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.partition import ArrayShape
from repro_torch.core.scheduler import ScheduleResult
from repro_torch.sim.systolic import SystolicConfig, layer_cost


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    e_mac_pj: float = 1.0
    e_fwd_pj: float = 0.12
    e_sram_pj: float = 6.0
    # feed re-reads hit a small banked lane buffer (~8 KB/row), far cheaper
    # than the big load/drain SRAMs
    e_feed_pj: float = 2.0
    e_dram_pj: float = 200.0
    p_leak_pe_w: float = 25e-6
    # clock-tree + always-on control dynamic power, per PE per cycle while
    # the accelerator is powered (≈30 % of a PE's active dynamic at 45 nm)
    e_clk_pj: float = 0.30
    # memory-contention stall overheads per stalled bus cycle
    # (ScheduleResult.bus_stall_s × clock), folded into sram_j/dram_j and
    # priced only when a schedule actually stalled
    e_stall_sram_pj: float = 0.6
    e_stall_dram_pj: float = 1.2

    def leak_power(self, array: ArrayShape) -> float:
        return self.p_leak_pe_w * array.rows * array.cols


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Per-mechanism energy in joules; ``total`` is the Fig. 9(e,f) number."""

    mac_j: float
    forward_j: float
    sram_j: float
    dram_j: float
    clock_j: float
    leakage_j: float

    @property
    def total(self) -> float:
        return (
            self.mac_j
            + self.forward_j
            + self.sram_j
            + self.dram_j
            + self.clock_j
            + self.leakage_j
        )

    @property
    def dynamic(self) -> float:
        return self.total - self.leakage_j

    def as_dict(self) -> dict[str, float]:
        return {
            "mac_j": self.mac_j,
            "forward_j": self.forward_j,
            "sram_j": self.sram_j,
            "dram_j": self.dram_j,
            "clock_j": self.clock_j,
            "leakage_j": self.leakage_j,
            "total_j": self.total,
        }


def _identity(x):
    return x


def schedule_energy_with_layers(
    result: ScheduleResult,
    layers_by_key: dict[tuple[str, int], object],
    cfg: SystolicConfig,
    model: EnergyModel,
    baseline_pe: bool,
) -> EnergyBreakdown:
    """Full energy including SRAM/DRAM traffic.

    ``layers_by_key`` maps (tenant, layer_index) -> LayerShape so the access
    counts of each executed layer can be recomputed for its partition.

    Each :class:`TraceEvent` carries the ``fraction`` of the layer's compute
    it covers, and access counts are scaled per segment; at ``fraction ==
    1.0`` the scale is the identity, so integer operands stay intact and a
    preemption-free trace prices exactly as the reference does.  A
    ``preempted`` segment that did compute also pays the in-array psum drain
    (two 16-bit DRAM accesses per partition PE), and a ``resumed`` segment
    pays the weight re-stage (``K×N`` DRAM re-reads).
    """
    pj = 1e-12
    mac = fwd = sram = dram = 0.0
    full_pes = cfg.rows * cfg.cols
    for ev in result.trace:
        layer = layers_by_key[(ev.tenant, ev.layer_index)]
        cost = layer_cost(layer, ev.partition)
        frac = ev.fraction
        scale = _identity if frac == 1.0 else (lambda x: x * frac)
        if baseline_pe:
            # Fig. 7(b): no Mul_En — every clocked PE's multiplier toggles
            # every compute cycle
            mac += model.e_mac_pj * scale(cost.cycles) * full_pes * pj
        else:
            # Fig. 7(a): Mul_En=1 only while the partition's own feed data
            # streams through; load phases and foreign pass-through are
            # tri-stated (latch/wire energy only)
            mac += model.e_mac_pj * scale(cost.feed_pe_cycles) * pj
            fwd += model.e_fwd_pj * scale(cost.load_pe_cycles) * pj
            fwd += (
                model.e_fwd_pj
                * scale(cost.cycles)
                * ev.partition.rows
                * ev.partition.col_start
                * pj
            )
        sram += (
            model.e_sram_pj * scale(cost.load_buf_reads + cost.drain_buf_writes) * pj
        )
        sram += model.e_feed_pj * scale(cost.feed_buf_reads) * pj
        dram += model.e_dram_pj * scale(cost.dram_reads + cost.dram_writes) * pj
        if ev.preempted and ev.fraction > 0.0:
            # psum drain: fp32 accumulators of the column group, written out
            # as 2 × 16-bit DRAM accesses per PE
            dram += model.e_dram_pj * 2 * ev.partition.n_pes * pj
        if ev.resumed:
            # weight re-stage: the stationary K×N operands re-read from DRAM
            dram += model.e_dram_pj * layer.gemm_k * layer.gemm_n * pj
    if result.bus_stall_s:
        # memory-contention stalls: bill the stalled DRAM interface and
        # staging-SRAM port cycles (unarmed schedules skip this block)
        stall_cycles = result.bus_stall_s * cfg.clock_hz
        sram += model.e_stall_sram_pj * stall_cycles * pj
        dram += model.e_stall_dram_pj * stall_cycles * pj
    leak = model.leak_power(cfg.array) * result.makespan
    clk = (model.e_clk_pj * full_pes * result.makespan * cfg.clock_hz) * pj
    return EnergyBreakdown(
        mac_j=mac, forward_j=fwd, sram_j=sram, dram_j=dram, clock_j=clk, leakage_j=leak
    )
