"""Continuous-batching serve engine with adaptive admission; the PyTorch
port of the reference's serving/engine.py, on an explicit device.

A fixed pool of ``max_batch`` sequence slots shares one padded KV cache;
every decode iteration steps all slots. Admission of waiting requests
follows the paper's Alg 1 (serving/batcher.py). As in the reference, a
request's prompt is prefilled into its slot (the prefill's logits are not
used) and the first decode step feeds the prompt's last token again at
position len(prompt); decoding is greedy. Every slot, live or not, goes
through each decode step, so a dead slot's token takes MoE capacity, and
the re-fed token goes through an SSM layer's state a second time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..models.model import decode_step, init_caches, prefill
from ..tree import tree_leaves
from .batcher import AdaptiveRequestBatcher


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    output: List[int] = field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token_at is None else self.first_token_at - self.submitted_at


class ServeEngine:
    """Serves requests on ``device`` (default "cuda"; raises without CUDA
    unless the caller passes "cpu"); ``params`` must already live there."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8, cache_len: int = 256,
                 batcher: Optional[AdaptiveRequestBatcher] = None, device="cuda"):
        self.device = resolve_device(device)
        if not cfg.embed_input or "cross" in cfg.layer_pattern:
            raise ValueError(f"{cfg.name}: the engine serves token prompts alone, and this "
                             "config also takes frame embeddings or vision states")
        if params["final_norm"].device != self.device:
            raise ValueError(f"params are on {params['final_norm'].device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.batcher = batcher or AdaptiveRequestBatcher(max_batch=max_batch)
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}  # slot -> request
        self._next_rid = 0
        self.caches = init_caches(params, cfg, max_batch, cache_len)
        self.cur_pos = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.live = torch.zeros((max_batch,), dtype=torch.bool, device=self.device)
        self.last_tok = torch.zeros((max_batch, 1), dtype=torch.int64, device=self.device)
        self.completed: List[Request] = []

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16, eos_id=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, np.asarray(prompt, np.int32), max_new_tokens, eos_id))
        return rid

    def run(self, max_rounds: int = 10_000) -> List[Request]:
        """Serve until every submitted request finishes."""
        rounds = 0
        while (self.waiting or self.active) and rounds < max_rounds:
            self.step_round()
            rounds += 1
        return self.completed

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.max_batch) if s not in self.active]

    def _admit(self, n: int) -> None:
        """Prefill n waiting requests into free slots, one at a time (the
        prompt lengths differ)."""
        for _ in range(n):
            if not self.waiting:
                return
            slots = self._free_slots()
            if not slots:
                return
            slot = slots[0]
            req = self.waiting.pop(0)
            prompt = torch.from_numpy(req.prompt.astype(np.int64)).to(self.device)[None, :]
            _, caches_1, _ = prefill(self.params, self.cfg, {"inputs": prompt},
                                     cache_len=self.cache_len)
            # Copy the single-row caches into this slot of the pool, leaf for
            # leaf (K/V, SSM state and conv tail, the shared block's K/V; a
            # local layer's ring has as many slots in both).
            for pool, one in zip(tree_leaves(self.caches), tree_leaves(caches_1)):
                pool[:, slot: slot + 1] = one
            self.cur_pos[slot] = len(req.prompt)
            self.last_tok[slot, 0] = int(req.prompt[-1])
            self.live[slot] = True
            self.active[slot] = req

    def step_round(self) -> None:
        t0 = time.perf_counter()
        self._admit(self.batcher.admit(len(self.waiting), len(self._free_slots())))
        served = len(self.active)
        if served:
            logits, self.caches = decode_step(self.params, self.cfg, {"inputs": self.last_tok},
                                              self.caches, self.cur_pos)
            nxt = torch.argmax(logits, dim=-1)  # greedy
            nxt_np = nxt.cpu().numpy()
            cur_np = self.cur_pos.cpu().numpy()
            now = time.perf_counter()
            done_slots = []
            for slot, req in self.active.items():
                tok = int(nxt_np[slot])
                if req.first_token_at is None:
                    req.first_token_at = now
                req.output.append(tok)
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.output) >= req.max_new_tokens
                        or int(cur_np[slot]) + 1 >= self.cache_len - 1):
                    req.finished_at = now
                    done_slots.append(slot)
            self.last_tok = nxt[:, None]
            self.cur_pos = self.cur_pos + self.live.to(torch.int32)
            for slot in done_slots:
                self.completed.append(self.active.pop(slot))
                self.live[slot] = False
        self.batcher.update(time.perf_counter() - t0, served)
