"""Batched continuous-batching decode engine (the port of
``repro/serve/engine.py``).

Fixed-slot design (vLLM-style static batching): B slots, each holding one
request's KV cache region.  New requests claim free slots, prompts are
prefilled token by token through the same decode step, then generation
proceeds; finished slots free at once and the next queued request claims
them mid-flight (continuous batching).

The decode step is an eager call of the model's ``decode_step`` on one
device: the card unless the caller passes ``device="cpu"``.  The weights
that every use casts to the activation dtype are cast once, when the
engine is built (``convert.compute_params``), which gives the same bits
as the per-call cast.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import decode_step
from ..models.config import ModelConfig
from ..models.convert import compute_params
from ..models.layers import MeshAxes
from ..models.transformer import init_caches, tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    done_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.done_at is not None


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 4
    max_ctx: int = 256
    eos_id: int = -1          # -1: only stop on max_new


class EngineStallError(RuntimeError):
    """``run_until_drained`` hit its step budget with work still in
    flight.  Carries enough to debug the stall: the step count plus the
    request ids still occupying slots and still queued."""

    def __init__(self, steps: int, active_rids: List[int],
                 queued_rids: List[int]):
        self.steps = steps
        self.active_rids = active_rids
        self.queued_rids = queued_rids
        super().__init__(
            f"engine stalled after {steps} steps: "
            f"active requests {active_rids}, queued {queued_rids}")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, ax: MeshAxes,
                 scfg: ServeConfig, *, device=None):
        self.device = resolve_device(device, "ServeEngine")
        self.cfg = cfg
        self.ax = ax
        self.scfg = scfg
        self.params = compute_params(
            tree_map(lambda a: a.to(self.device), params), cfg)
        B = scfg.batch_slots
        self.caches = init_caches(self.params, cfg, B, scfg.max_ctx, ax)
        self.pos = np.zeros((B,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_phase = ["free"] * B          # free | prefill | gen
        self.slot_cursor = np.zeros((B,), np.int32)
        self.queue: "collections.deque[Request]" = collections.deque()
        self._rid = itertools.count()
        self.steps = 0

    def _step(self, toks, pos):
        with torch.no_grad():
            return decode_step(self.params, toks, self.caches, pos,
                               self.cfg, self.ax)

    # -- API -----------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16) -> Request:
        r = Request(rid=next(self._rid), prompt=list(prompt),
                    max_new=max_new, submitted_at=time.perf_counter())
        self.queue.append(r)
        return r

    def _admit(self):
        for b in range(self.scfg.batch_slots):
            if self.slot_phase[b] == "free" and self.queue:
                r = self.queue.popleft()
                self.slot_req[b] = r
                self.slot_phase[b] = "prefill"
                self.slot_cursor[b] = 0
                self.pos[b] = 0
                self._reset_slot_cache(b)

    def _reset_slot_cache(self, b: int):
        """Zero slot ``b``'s rows of every layer's state in place;
        attention caches get ``pos = -1`` sentinels, and the shared write
        index ``idx`` stays as it is."""
        def reset(leaf):
            if leaf.ndim > 0:
                leaf[b] = 0
        for c in self.caches:
            if isinstance(c, dict) and "pos" in c:
                c["k"][b] = 0
                c["v"][b] = 0
                c["pos"][b] = -1
            else:
                tree_map(reset, c)

    def step(self):
        """One engine tick: admit, build the token batch, decode, route."""
        self._admit()
        B = self.scfg.batch_slots
        toks = np.zeros((B, 1), np.int32)
        for b in range(B):
            r = self.slot_req[b]
            if r is None:
                continue
            if self.slot_phase[b] == "prefill":
                toks[b, 0] = r.prompt[self.slot_cursor[b]]
            else:
                toks[b, 0] = r.out[-1] if r.out else r.prompt[-1]
        nxt, self.caches = self._step(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos).to(self.device))
        nxt = nxt.cpu().numpy()
        self.steps += 1

        for b in range(B):
            r = self.slot_req[b]
            if r is None:
                continue
            self.pos[b] += 1
            if self.slot_phase[b] == "prefill":
                self.slot_cursor[b] += 1
                if self.slot_cursor[b] >= len(r.prompt):
                    self.slot_phase[b] = "gen"
                    r.out.append(int(nxt[b, 0]))
            else:
                r.out.append(int(nxt[b, 0]))
                if len(r.out) >= r.max_new or \
                        (self.scfg.eos_id >= 0 and
                         r.out[-1] == self.scfg.eos_id):
                    r.done_at = time.perf_counter()
                    self.slot_req[b] = None
                    self.slot_phase[b] = "free"

    def run_until_drained(self, *, max_steps: int = 10_000,
                          on_stall: str = "raise") -> int:
        """Tick until every request completes.  Hitting ``max_steps``
        with requests still in flight is a stall, not a drain — it
        raises :class:`EngineStallError` naming the stuck request ids
        (pass ``on_stall="return"`` for the legacy silent behaviour)."""
        while (self.queue or any(p != "free" for p in self.slot_phase)) \
                and self.steps < max_steps:
            self.step()
        if self.queue or any(p != "free" for p in self.slot_phase):
            if on_stall == "raise":
                raise EngineStallError(
                    self.steps,
                    [r.rid for r in self.slot_req if r is not None],
                    [r.rid for r in self.queue])
        return self.steps

    @property
    def active(self) -> int:
        return sum(p != "free" for p in self.slot_phase)
