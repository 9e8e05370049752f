"""Serving-side cache/session management on top of ``models.model``.

Counterpart of ``repro.serving.kv_cache``.  A :class:`DecodeSession` owns a
fixed-capacity batched cache for one tenant model and multiplexes request
slots into it (continuous batching): requests claim a free row, their prompt
is ingested by decode steps that advance only that row (prefill by decode),
decode steps advance every live row together, greedy argmax picks each
token, and finished rows are released for reuse.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import ModelConfig, decode_step, init_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class DecodeSession:
    """Fixed-slot continuous-batching session for one model/tenant.

    ``last_logits`` holds the (batch_slots, 1, vocab) logits of the most
    recent decode step, on the device (None before the first step).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        batch_slots: int,
        max_seq: int,
        *,
        device="cuda",
    ):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, batch_slots, max_seq, device=self.device)
        self.cache_len = torch.zeros(batch_slots, dtype=torch.int32, device=self.device)
        self.live: dict[int, Request] = {}  # slot -> request
        self._free = list(range(batch_slots))
        self.last_logits: torch.Tensor | None = None

    # -- admission ----------------------------------------------------------
    def can_admit(self) -> bool:
        return bool(self._free)

    def admit(self, req: Request) -> None:
        if not self._free:
            raise RuntimeError("no free slots")
        if not req.prompt or len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens + "
                f"{req.max_new} new must be 1..{self.max_seq} positions"
            )
        slot = self._free.pop()
        req.slot = slot
        self.live[slot] = req
        # sequential prompt ingestion through decode_step (prefill by
        # decode): each prompt token advances only this row
        for tok in req.prompt:
            toks = [0] * self.slots
            toks[slot] = tok
            self._advance(toks, [slot])

    def _advance(self, toks: list[int], rows: list[int]) -> torch.Tensor:
        """One decode step that writes the cache of ``rows`` only (the JAX
        package's masked per-row merge) and advances their lengths."""
        live = torch.zeros(self.slots, dtype=torch.bool)
        live[rows] = True
        live = live.to(self.device)
        token = torch.tensor(toks, dtype=torch.long)[:, None].to(self.device)
        logits, self.cache = decode_step(
            self.cfg, self.params, self.cache, token, self.cache_len, live
        )
        self.cache_len = torch.where(live, self.cache_len + 1, self.cache_len)
        self.last_logits = logits
        return logits

    # -- decode -------------------------------------------------------------
    def step(self) -> dict[int, int]:
        """One decode step for every live row; returns {rid: new_token}."""
        if not self.live:
            return {}
        # last emitted (or last prompt) token per row
        toks = [0] * self.slots
        for slot, req in self.live.items():
            toks[slot] = req.out[-1] if req.out else req.prompt[-1]
        logits = self._advance(toks, list(self.live))

        emitted: dict[int, int] = {}
        greedy = logits[:, 0, :].argmax(dim=-1).tolist()
        for slot, req in list(self.live.items()):
            tok = int(greedy[slot])
            req.out.append(tok)
            emitted[req.rid] = tok
            if req.done:
                self.release(slot)
        return emitted

    def release(self, slot: int) -> None:
        req = self.live.pop(slot)
        req.slot = -1
        self.cache_len[slot] = 0
        self._free.append(slot)

    @property
    def occupancy(self) -> float:
        return len(self.live) / self.slots
