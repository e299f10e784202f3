"""Serving: batched prefill + decode with KV caches.

Port of ``repro.serve.engine``.  ``make_serve_step`` builds the one-token
decode step: tokens (B,1) + caches → next tokens (B,1) (greedy argmax on
the device) + logits (B,1,V) + caches.  The step writes the attention
caches in place, as the reference donates them.

The host-side ``ServeLoop`` is a thin adapter over the port's slot
scheduler (``serve/scheduler.py``), as the reference's rides its own:
each request becomes a ``SlotTask`` sharing one lock-step decode batch,
the scheduler owns admission/stepping/release, and the shared
``batch_key`` group dispatch keeps the whole batch advancing as ONE decode
step per round.

Placement: the mesh is the port's ``parallel.sharding.Mesh`` of one
member; parameters and caches live on that member's device.  A mesh of
more than one member needs the caches' placement over members (ROADMAP
item 10c2c) and raises until it lands.  The reference's
``serve_cache_shardings`` and ``jit_serve_step`` have no counterpart:
nothing is jitted here, and their placement is that slice's work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

PLACEMENT_SLICE = ("a ServeLoop over a mesh of more than one member needs the caches' "
                   "placement over members, a later slice (ROADMAP item 10c2c)")


def make_serve_step(cfg: ModelConfig, *, memory=None):
    def serve_step(params, tokens, caches):
        logits, caches = tf.decode_step(params, cfg, tokens, caches, memory=memory)
        # greedy sampling on the device (argmax); temperature sampling is a
        # host-side concern in this engine
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, caches

    return serve_step


@dataclass
class Request:
    uid: int
    prompt: Any  # (S,) int token ids: a tensor, array or list
    max_new: int
    generated: list = field(default_factory=list)
    done: bool = False


class _DecodeTask:
    """``SlotTask`` face of one request inside a lock-step decode batch.

    All tasks of one :class:`_LockstepDecoder` share its ``batch_key``, so
    the scheduler co-dispatches them: one ``step_batch`` call advances the
    WHOLE batch one decode step, and each task only owns its request's
    per-slot bookkeeping (append token, notice budget exhaustion, release
    on cancel)."""

    def __init__(self, decoder: "_LockstepDecoder", row: int, request: Request):
        self.decoder, self.row, self.request = decoder, row, request
        self.cancelled = False

    @property
    def batch_key(self):
        return id(self.decoder)

    @property
    def done(self) -> bool:
        return self.request.done or self.cancelled

    def step(self) -> None:
        # lock-step: a solo step still advances the shared batch (the KV
        # cache carries one write position — there is no per-slot clock)
        self.decoder.tick()

    @staticmethod
    def step_batch(tasks: list["_DecodeTask"]) -> None:
        tasks[0].decoder.tick()

    def finish(self) -> Request:
        return self.request

    def cancel(self) -> None:
        self.cancelled = True  # the decoder stops appending to this slot


class _LockstepDecoder:
    """Shared decode state for one admitted batch: prompts right-padded to
    a common length and prefilled token-by-token through the SAME decode
    step generation uses.  Every ``tick`` appends the current greedy token
    to each live request (one device read a tick) and runs one decode step
    for the whole batch."""

    def __init__(self, loop: "ServeLoop", requests: list[Request]):
        self.loop = loop
        self.tasks = [_DecodeTask(self, i, r) for i, r in enumerate(requests)]
        loop._reset()
        dev = loop.device
        rows = [torch.as_tensor(r.prompt, dtype=torch.int32).reshape(-1).to(dev) for r in requests]
        plen = max(int(r.shape[0]) for r in rows)
        prompts = torch.zeros((loop.slots, plen), dtype=torch.int32, device=dev)
        for i, r in enumerate(rows):
            prompts[i, : r.shape[0]] = r
        next_tok = prompts[:, :1]
        for t in range(plen):
            tokens = prompts[:, t: t + 1]
            next_tok, _, loop.caches = loop.step_fn(loop.params, tokens, loop.caches)
        self.tokens = next_tok

    def tick(self) -> None:
        current = self.tokens[:, 0].tolist()
        for task in self.tasks:
            if task.done:
                continue
            r = task.request
            r.generated.append(int(current[task.row]))
            if len(r.generated) >= r.max_new:
                r.done = True
        if any(not t.done for t in self.tasks):
            self.tokens, _, self.loop.caches = self.loop.step_fn(
                self.loop.params, self.tokens, self.loop.caches
            )


class ServeLoop:
    """Lock-step batched serving over a fixed slot grid — a thin client of
    the slot scheduler (``serve/scheduler.py``).

    All slots advance together (the KV cache carries one shared write
    position), which the scheduler expresses as one ``batch_key`` group:
    every request is its own ``SlotTask``, admission/stepping/release run
    through ``Scheduler``, and each scheduling round advances the whole
    batch one decode step.  Admission stays batch-granular, as in the
    reference.
    """

    def __init__(self, mesh, cfg: ModelConfig, params, *, slots: int, max_len: int):
        members = list(mesh.devices.reshape(-1))
        if len(members) != 1:
            raise NotImplementedError(PLACEMENT_SLICE)
        self.mesh, self.cfg = mesh, cfg
        self.device = members[0].device
        self.params = tf.tree_map(lambda t: t.to(self.device), params)
        self.slots = slots
        self.max_len = max_len
        self.step_fn = make_serve_step(cfg)
        self._reset()

    def _reset(self):
        self.caches = tf.init_caches(self.cfg, self.slots, self.max_len,
                                     tf.torch_dtype(self.cfg.dtype), device=self.device)

    def run_batch(self, requests: list[Request]) -> list[Request]:
        from repro_torch.serve.scheduler import Scheduler

        if len(requests) > self.slots:
            raise ValueError(f"{len(requests)} requests for {self.slots} slots")
        sched = Scheduler(slots=self.slots)
        decoder = _LockstepDecoder(self, requests)
        for task, r in zip(decoder.tasks, requests):
            sched.submit(task, tenant=f"req-{r.uid}")
        sched.run_until_idle()
        return requests
