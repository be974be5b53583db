"""Batched serving engine: fixed-slot continuous batching.

Port of ``repro.serve.engine``.  The engine owns one cache per slot (KV
``[.., 1, max_len, ..]``, and a Mamba model's conv and ssm state), which
prefill and decode write in place.  Requests queue up; whenever a slot
frees (sequence finished), the next request is prefilled into that slot,
over the state of the slot's last request, and decoding continues for
every busy slot.  Everything runs on the
params' device.  Greedy sampling by default; with a temperature, tokens
are drawn through a ``torch.Generator`` seeded by ``seed``.

Each ``Result`` also carries what a caller needs to judge and time the
run: the top-1 minus top-2 logit margin at every sampled token, the
host-clock milliseconds of its prefill and of each decode step (each
ends in a read of the sampled token, so the device has finished), and,
with ``keep_prefill_logits``, the prefill's last-position logits.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] token ids
    max_new_tokens: int = 32
    eos_id: int | None = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: list[int]
    margins: list[float] = dataclasses.field(default_factory=list)
    prefill_ms: float = 0.0
    decode_ms: list[float] = dataclasses.field(default_factory=list)
    prefill_logits: torch.Tensor | None = None  # [vocab] f32 on the host


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, batch_slots: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 keep_prefill_logits: bool = False):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.device = params["tok"]["embed"].device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.keep_prefill_logits = keep_prefill_logits
        self.queue: deque[Request] = deque()
        self.results: list[Result] = []
        # per-slot state
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_len = np.zeros(batch_slots, np.int64)
        self.slot_res: list[Result | None] = [None] * batch_slots
        self.caches = [model.init_cache(cfg, 1, max_len, device=self.device)
                       for _ in range(batch_slots)]
        self.last_tok = np.zeros(batch_slots, np.int64)

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self) -> list[Result]:
        """Run until queue and slots drain.  Returns completed results."""
        with torch.inference_mode():
            while self.queue or any(r is not None for r in self.slot_req):
                self._fill_slots()
                self._decode_tick()
        return self.results

    # ------------------------------------------------------------- internals
    def _fill_slots(self) -> None:
        for i in range(self.slots):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.popleft()
                t0 = time.perf_counter()
                toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                       device=self.device)[None, :]
                logits, self.caches[i] = model.prefill(
                    self.params, self.cfg, tokens=toks, cache=self.caches[i]
                )
                res = Result(req.uid, [])
                self.last_tok[i] = self._sample(logits[0, -1], res)
                res.prefill_ms = (time.perf_counter() - t0) * 1e3
                if self.keep_prefill_logits:
                    res.prefill_logits = logits[0, -1, : self.cfg.vocab].float().cpu()
                self.slot_req[i] = req
                self.slot_len[i] = len(req.prompt)
                self.slot_res[i] = res

    def _sample(self, logits: torch.Tensor, res: Result) -> int:
        logits = logits[: self.cfg.vocab].float()
        top2 = torch.topk(logits, 2).values
        if self.temperature <= 0:
            tok = torch.argmax(logits)
        else:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self.gen)[0]
        tok, a, b = torch.stack([tok.float(), top2[0], top2[1]]).tolist()
        res.margins.append(a - b)
        return int(tok)

    def _decode_tick(self) -> None:
        for i in range(self.slots):
            req, res = self.slot_req[i], self.slot_res[i]
            if req is None:
                continue
            tok = int(self.last_tok[i])
            res.tokens.append(tok)
            done = (
                len(res.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or self.slot_len[i] + 1 >= self.max_len
            )
            if done:
                self.results.append(res)
                self.slot_req[i] = self.slot_res[i] = None
                continue
            t0 = time.perf_counter()
            logits, self.caches[i] = model.decode_step(
                self.params, self.cfg,
                token=torch.tensor([[tok]], dtype=torch.long, device=self.device),
                cache=self.caches[i], cache_len=int(self.slot_len[i]),
            )
            self.slot_len[i] += 1
            self.last_tok[i] = self._sample(logits[0, -1], res)
            res.decode_ms.append((time.perf_counter() - t0) * 1e3)
