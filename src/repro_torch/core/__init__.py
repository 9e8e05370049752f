"""The paper's primary contribution: DNNG model, Algorithm 1, scheduler,
dataflow."""

from repro_torch.core.dataflow import GEMM, DataflowCost, utilization, ws_cost
from repro_torch.core.dnng import DNNG, LayerShape, chain
from repro_torch.core.partition import (
    ArrayShape,
    Assignment,
    Partition,
    PartitionSet,
    partition_calculation,
    task_assignment,
)
from repro_torch.core.scheduler import (
    DynamicScheduler,
    ScheduleResult,
    TraceEvent,
    schedule_dynamic,
    schedule_sequential,
)

__all__ = [
    "DNNG",
    "LayerShape",
    "chain",
    "ArrayShape",
    "Assignment",
    "Partition",
    "PartitionSet",
    "partition_calculation",
    "task_assignment",
    "DynamicScheduler",
    "ScheduleResult",
    "TraceEvent",
    "schedule_dynamic",
    "schedule_sequential",
    "GEMM",
    "DataflowCost",
    "ws_cost",
    "utilization",
]
