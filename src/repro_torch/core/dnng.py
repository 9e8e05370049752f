"""Deep Neural Network Graph (DNNG) — the paper's workload abstraction (§2.1).

The port's own copy of ``repro.core.dnng``.  A DNNG is a weighted DAG
``G(V, E)`` whose vertices are layers and whose edges encode execution
precedence.  Each layer carries the 9 shape parameters
``{M, N, C, R, S, H, W, P, Q}`` (paper Eq. 1); ``Opr(l) = M·N·C·R·S·H·W``
(paper Eq. 2) is the priority key of Algorithm 1's Task_Assignment.

Every layer lowers to a GEMM:

    stationary (weights):  K × M   with K = C·R·S   (K on PE rows, M on PE cols)
    streamed  (im2col):    T × K   with T = N·P·Q   (T input rows streamed)

Fully connected / recurrent layers use R=S=1, H=W=P=Q=1 with the batch/time
steps folded into N.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Sequence


@functools.lru_cache(maxsize=4096)
def _chain_edges(n_layers: int) -> tuple[tuple[int, int], ...]:
    """Edge list of the default linear chain (shared across the per-job
    DNNG clones an open-loop traffic generator stamps out)."""
    return tuple((i, i + 1) for i in range(n_layers - 1))


@functools.lru_cache(maxsize=4096)
def _pred_table(
    edges: tuple[tuple[int, int], ...], n_layers: int
) -> tuple[tuple[int, ...], ...]:
    """Predecessor indices per layer, precomputed once per graph shape (the
    scheduler's readiness lookup)."""
    preds: list[list[int]] = [[] for _ in range(n_layers)]
    for s, d in edges:
        preds[d].append(s)
    return tuple(tuple(p) for p in preds)


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """The 9 shape parameters of one DNN layer (paper Eq. 1)."""

    M: int  # number of filters (output channels)
    N: int  # batch size
    C: int  # input channels
    R: int  # filter height
    S: int  # filter width
    H: int  # input height
    W: int  # input width
    P: int  # output height
    Q: int  # output width
    name: str = ""

    def __post_init__(self) -> None:
        for f in ("M", "N", "C", "R", "S", "H", "W", "P", "Q"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"LayerShape.{f} must be a positive int, got {v!r}")

    def __hash__(self) -> int:
        # memoized: LayerShape keys every cost-oracle memo, and the
        # generated dataclass hash re-tuples all 10 fields per lookup.
        # Frozen blocks setattr but not __dict__ writes; equal instances
        # hash equal because the memo comes from the field tuple eq compares.
        h = self.__dict__.get("_hash")
        if h is None:
            self.__dict__["_hash"] = h = hash(
                (
                    self.M,
                    self.N,
                    self.C,
                    self.R,
                    self.S,
                    self.H,
                    self.W,
                    self.P,
                    self.Q,
                    self.name,
                )
            )
        return h

    @property
    def opr(self) -> int:
        """Paper Eq. 2, ``Opr(l) = M·N·C·R·S·H·W`` (input spatial H·W, as the
        paper writes it); memoized like ``__hash__``."""
        v = self.__dict__.get("_opr")
        if v is None:
            v = self.M * self.N * self.C * self.R * self.S * self.H * self.W
            self.__dict__["_opr"] = v
        return v

    @property
    def macs(self) -> int:
        """Exact MAC count of the lowered GEMM: M·N·C·R·S·P·Q."""
        return self.M * self.N * self.C * self.R * self.S * self.P * self.Q

    @property
    def gemm_k(self) -> int:
        """Reduction dim = C·R·S (maps to PE rows; weights are stationary)."""
        return self.C * self.R * self.S

    @property
    def gemm_n(self) -> int:
        """Output-channel dim = M (maps to PE columns — the partitioned dim)."""
        return self.M

    @property
    def gemm_m(self) -> int:
        """Streamed dim = N·P·Q (rows of im2col input fed through the array)."""
        return self.N * self.P * self.Q

    @property
    def weight_bytes(self) -> int:
        return 2 * self.gemm_k * self.gemm_n  # bf16/int16 as in Scale-Sim configs

    @property
    def ifmap_elems(self) -> int:
        return self.N * self.C * self.H * self.W

    @property
    def ofmap_elems(self) -> int:
        return self.N * self.M * self.P * self.Q

    @staticmethod
    def conv(
        name: str,
        M: int,
        C: int,
        R: int,
        S: int,
        H: int,
        W: int,
        stride: int = 1,
        pad: int | None = None,
        N: int = 1,
    ) -> "LayerShape":
        """Build a conv layer; output spatial derived from stride/padding."""
        if pad is None:
            pad = R // 2
        P = (H + 2 * pad - R) // stride + 1
        Q = (W + 2 * pad - S) // stride + 1
        return LayerShape(
            M=M, N=N, C=C, R=R, S=S, H=H, W=W, P=max(P, 1), Q=max(Q, 1), name=name
        )

    @staticmethod
    def fc(
        name: str, in_features: int, out_features: int, batch: int = 1
    ) -> "LayerShape":
        """Fully connected layer: GEMM (batch × in) · (in × out)."""
        return LayerShape(
            M=out_features,
            N=batch,
            C=in_features,
            R=1,
            S=1,
            H=1,
            W=1,
            P=1,
            Q=1,
            name=name,
        )

    @staticmethod
    def lstm_cell(
        name: str, input_size: int, hidden: int, steps: int, batch: int = 1
    ) -> "LayerShape":
        """LSTM cell unrolled over ``steps``: one GEMM with K = input + hidden,
        M = 4·hidden (the four gates) and the time steps folded into N."""
        return LayerShape(
            M=4 * hidden,
            N=batch * steps,
            C=input_size + hidden,
            R=1,
            S=1,
            H=1,
            W=1,
            P=1,
            Q=1,
            name=name,
        )


@dataclasses.dataclass(frozen=True)
class DNNG:
    """A DNN graph: a named chain/DAG of layers with an arrival time (§2.1).

    ``edges`` holds (src, dst) layer-index pairs; None is the linear chain,
    which all the paper's workloads are.  ``arrival_time`` follows the
    simulator's clock.
    """

    name: str
    layers: tuple[LayerShape, ...]
    arrival_time: float = 0.0
    edges: tuple[tuple[int, int], ...] | None = None

    def __post_init__(self) -> None:
        if not self.layers:
            raise ValueError(f"DNNG {self.name!r} has no layers")
        n = len(self.layers)
        if self.edges is not None:
            for s, d in self.edges:
                if not (0 <= s < n and 0 <= d < n):
                    raise ValueError(f"edge ({s},{d}) out of range for {n} layers")
                if s >= d:
                    raise ValueError(f"edge ({s},{d}) violates topological order")

    @property
    def edge_list(self) -> tuple[tuple[int, int], ...]:
        if self.edges is not None:
            return self.edges
        return _chain_edges(len(self.layers))

    @property
    def pred_table(self) -> tuple[tuple[int, ...], ...]:
        """Predecessors per layer index, cached per graph shape."""
        return _pred_table(self.edge_list, len(self.layers))

    def predecessors(self, idx: int) -> list[int]:
        return list(self.pred_table[idx])

    def successors(self, idx: int) -> list[int]:
        return [d for s, d in self.edge_list if s == idx]

    def roots(self) -> list[int]:
        """Layers with no predecessors (ready at arrival)."""
        dsts = {d for _, d in self.edge_list}
        return [i for i in range(len(self.layers)) if i not in dsts]

    def clone(
        self, name: str | None = None, arrival_time: float | None = None
    ) -> "DNNG":
        """Re-stamp a validated graph with a new name / arrival, skipping
        ``dataclasses.replace``'s re-validation (layers and edges are
        shared, already-validated objects)."""
        g = object.__new__(DNNG)
        d = g.__dict__
        d["name"] = self.name if name is None else name
        d["layers"] = self.layers
        d["arrival_time"] = self.arrival_time if arrival_time is None else arrival_time
        d["edges"] = self.edges
        return g

    @property
    def total_macs(self) -> int:
        return sum(layer.macs for layer in self.layers)

    @property
    def total_opr(self) -> int:
        return sum(layer.opr for layer in self.layers)

    def __iter__(self) -> Iterator[LayerShape]:
        return iter(self.layers)

    def __len__(self) -> int:
        return len(self.layers)


def chain(name: str, layers: Sequence[LayerShape], arrival_time: float = 0.0) -> DNNG:
    """Convenience constructor for the (ubiquitous) linear-chain DNNG."""
    return DNNG(name=name, layers=tuple(layers), arrival_time=arrival_time)


def validate_dag(g: DNNG) -> bool:
    """The edge list must be acyclic and topologically sorted."""
    seen: set[int] = set()
    for s, d in g.edge_list:
        if d in seen and s not in seen:
            return False
        seen.add(s)
        seen.add(d)
    return all(s < d for s, d in g.edge_list)


def estimated_execution_time(g: DNNG, macs_per_cycle: float) -> float:
    """E_t estimate of Algorithm 1 line 8 (coarse: MACs / throughput)."""
    if macs_per_cycle <= 0:
        raise ValueError("macs_per_cycle must be positive")
    return g.total_macs / macs_per_cycle
