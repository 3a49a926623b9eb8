"""Serving engine of the port: continuous batching over a fixed slot pool,
as the reference package's ``serve/engine.py``.

``ServeEngine`` keeps a (max_slots, max_len) KV cache on the model's
device; requests claim free slots via the batch-first ``admit_many`` (all
newly admitted prompts prefill together, one decode step per prompt
position across the wave -- the reference's prefill-by-decode, kept), then
advance together in batched decode steps; finished slots are recycled
mid-flight (continuous batching).  Each decode step reads its logits back
to the host once, as the reference's ``np.asarray(logits)`` does, and picks
tokens there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models.model import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (P,) integers
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False


@dataclass
class SlotAdmission:
    """Outcome of one slot-claim pass: who got a slot, who hit slot
    exhaustion.  The shared report for ``admit`` and ``admit_many``."""

    admitted: list[Request] = field(default_factory=list)
    rejected: list[Request] = field(default_factory=list)


class ServeEngine:
    def __init__(self, model: Model, params, max_slots: int = 4,
                 max_len: int = 128, cache_dtype: torch.dtype = torch.float32
                 ) -> None:
        self.model = model
        self.params = params
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = model.init_cache(max_slots, max_len, dtype=cache_dtype)
        self.free = list(range(max_slots))
        self.active: dict[int, Request] = {}
        self.pos = np.zeros(max_slots, np.int64)
        self._tokens_decoded = 0
        # slot-admission telemetry (shared by admit / admit_many)
        self.admitted_total = 0
        self.slot_rejections = 0
        self.last_admission: Optional[SlotAdmission] = None

    def _decode(self, toks: np.ndarray, poss: np.ndarray) -> np.ndarray:
        """One batched decode step; the logits come back to the host once."""
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.tensor(toks, device=self.device),
            torch.tensor(poss, device=self.device))
        return logits.cpu().numpy()

    # -- slot management ------------------------------------------------------
    def _claim_slots(self, reqs: list[Request]) -> SlotAdmission:
        """The one slot-claim path: every admission route reports slot
        exhaustion through the same counters and ``last_admission``."""
        report = SlotAdmission()
        for req in reqs:
            if not self.free:
                report.rejected.append(req)
                continue
            req.slot = self.free.pop()
            self.active[req.slot] = req
            report.admitted.append(req)
        self.admitted_total += len(report.admitted)
        self.slot_rejections += len(report.rejected)
        self.last_admission = report
        return report

    def admit(self, req: Request) -> bool:
        """One-request shim over :meth:`admit_many`."""
        return bool(self.admit_many([req]))

    def admit_many(self, reqs: list[Request]) -> list[Request]:
        """Batch-first admission: claim free slots for as many requests as
        fit, then prefill *all* claimed slots together -- one decode step
        per prompt position across the batch.  Returns the admitted
        requests; the rest stay with the caller (and are listed in
        ``last_admission.rejected``)."""
        admitted = self._claim_slots(reqs).admitted
        if not admitted:
            return admitted
        last: dict[int, np.ndarray] = {}
        for t in range(max(len(r.prompt) for r in admitted)):
            toks = np.zeros((self.max_slots, 1), np.int64)
            poss = self.pos.copy()
            stepped = [r for r in admitted if t < len(r.prompt)]
            for r in stepped:
                toks[r.slot, 0] = int(r.prompt[t])
                poss[r.slot] = t
            logits = self._decode(toks, poss)
            self._tokens_decoded += len(stepped)
            for r in stepped:
                if t == len(r.prompt) - 1:
                    last[r.slot] = logits[r.slot]
        for r in admitted:
            self.pos[r.slot] = len(r.prompt)
            r.out.append(int(np.argmax(last[r.slot])))
        return admitted

    # -- batched decode ------------------------------------------------------
    def step(self) -> list[Request]:
        """One decode step for every active slot; returns finished requests."""
        if not self.active:
            return []
        toks = np.zeros((self.max_slots, 1), np.int64)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out[-1]
        logits = self._decode(toks, self.pos)
        finished = []
        for slot, req in list(self.active.items()):
            self.pos[slot] += 1
            req.out.append(int(np.argmax(logits[slot])))
            self._tokens_decoded += 1
            if (len(req.out) >= req.max_new
                    or self.pos[slot] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                del self.active[slot]
                self.free.append(slot)
                self.pos[slot] = 0
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Continuous batching: admit whenever slots free up, in one
        batched prefill per admission wave."""
        pending = list(requests)
        done: list[Request] = []
        while pending or self.active:
            if pending and self.free:
                admitted = self.admit_many(pending[:len(self.free)])
                del pending[:len(admitted)]
            done.extend(self.step())
        return done
