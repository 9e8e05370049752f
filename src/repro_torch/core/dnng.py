"""Deep Neural Network Graph (DNNG) — the paper's workload abstraction (§2.1).

The port's own copy of what ``repro.core.dnng`` holds for the Table-1
workloads: a layer's 9 shape parameters ``{M, N, C, R, S, H, W, P, Q}``
(paper Eq. 1), its GEMM lowering for the weight-stationary array, and the
linear-chain graph of layers.

Every layer lowers to a GEMM:

    stationary (weights):  K × M   with K = C·R·S   (K on PE rows, M on PE cols)
    streamed  (im2col):    T × K   with T = N·P·Q   (T input rows streamed)

Fully connected / recurrent layers use R=S=1, H=W=P=Q=1 with the batch/time
steps folded into N.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence


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
    """A DNN graph: a named chain of layers with an arrival time (§2.1)."""

    name: str
    layers: tuple[LayerShape, ...]
    arrival_time: float = 0.0

    def __post_init__(self) -> None:
        if not self.layers:
            raise ValueError(f"DNNG {self.name!r} has no layers")

    def __iter__(self) -> Iterator[LayerShape]:
        return iter(self.layers)


def chain(name: str, layers: Sequence[LayerShape], arrival_time: float = 0.0) -> DNNG:
    """Convenience constructor for the (ubiquitous) linear-chain DNNG."""
    return DNNG(name=name, layers=tuple(layers), arrival_time=arrival_time)
