"""Batched token decoding with continuous batching and masked admission.

Mirrors `repro.models.decode_engine`, and like it knows the model only
through `registry.model_fns`: `init_decode_state` and `decode_step` of
any ported family (dense KV caches, the hybrid's SSM states and shared
block caches, the xLSTM's states, or the enc-dec family's caches and its
`enc_out`, zeroed as in the reference: the engine takes no audio, so a
caller that serves audio writes `encode`'s output into
`engine.state["enc_out"]` before `run`).  The decode state is batch-wide with a single shared write
position, so every `decode_step` advances every slot.  A newly admitted request's prompt is
therefore fed through the shared loop one token per step, isolated to its
slot's row (its logits ignored until the prompt is consumed), while live
slots keep decoding their own streams; admission itself is host
bookkeeping only.  Greedy decoding (temperature 0) is the reference's
token for token; temperature sampling draws from a `torch.Generator`
seeded with 0 at the start of each `run` (the reference restarts its
`PRNGKey(0)` there too), which cannot give `jax.random`'s draws.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from . import layers, registry


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0
    eos_token: int = 0
    state_dtype: object = torch.float32


class Engine:
    """Single-card serving engine over the model's decode_step.

    Runs on the card unless `device` is given; the model must live there.
    """

    def __init__(self, cfg: ArchConfig, model, serve_cfg: ServeConfig,
                 batch_slots: int = 8, *, device=None):
        self.device = layers.resolve_device(device)
        where = next(model.parameters()).device
        if where.type != self.device.type or (
                self.device.index is not None
                and where.index != self.device.index):
            raise ValueError(f"Engine on {self.device}, model on {where}")
        self.cfg = cfg
        self.model = model
        self.scfg = serve_cfg
        self.fns = registry.model_fns(cfg)
        self.slots = batch_slots
        self.state = self.fns["init_decode_state"](
            cfg, batch_slots, serve_cfg.max_len, dtype=serve_cfg.state_dtype,
            device=self.device)
        # no reference to self: a cycle would keep the model's weights on
        # the card after the engine is dropped, until the cyclic collector
        decode_step = self.fns["decode_step"]
        self._step = lambda s, t: decode_step(cfg, model, s, t)
        # slot bookkeeping (host side)
        self.live = np.zeros(batch_slots, bool)
        self.outputs: List[List[int]] = [[] for _ in range(batch_slots)]
        self.queue: List[List[int]] = []
        self.cur_token = np.zeros((batch_slots, 1), np.int32)
        # prompt tokens not yet fed; consumed one per decode step while
        # the slot is in its prefill phase (logits ignored until empty)
        self.pending: List[List[int]] = [[] for _ in range(batch_slots)]

    def submit(self, prompt_tokens: List[int]):
        self.queue.append(list(prompt_tokens))

    def _admit(self):
        """Assign queued requests to free slots (host bookkeeping only)."""
        for s in range(self.slots):
            if not self.live[s] and self.queue:
                prompt = self.queue.pop(0) or [0]
                self.live[s] = True
                self.outputs[s] = []
                self.cur_token[s, 0] = prompt[0]
                self.pending[s] = list(prompt[1:])

    def run(self, max_new_tokens: int = 32) -> List[List[int]]:
        """Decode until all live sequences stop or the budget of batch
        steps is spent; a slot admitted mid-run spends its first
        len(prompt) steps in prefill before it emits."""
        self._admit()
        gen = None
        if self.scfg.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
        for _ in range(max_new_tokens):
            if not self.live.any():
                break
            tokens = torch.from_numpy(self.cur_token).to(self.device)
            logits, self.state = self._step(self.state, tokens)
            lg = logits[:, -1]
            if gen is not None:
                probs = torch.softmax(lg.float() / self.scfg.temperature,
                                      dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(lg, dim=-1)
            nxt = nxt.cpu().numpy().astype(np.int32)
            for s in range(self.slots):
                if not self.live[s]:
                    continue
                if self.pending[s]:
                    # prefill: feed the next prompt token, ignore logits
                    self.cur_token[s, 0] = self.pending[s].pop(0)
                    continue
                self.outputs[s].append(int(nxt[s]))
                self.cur_token[s, 0] = int(nxt[s])
                if int(nxt[s]) == self.scfg.eos_token and len(
                        self.outputs[s]) > 1:
                    self.live[s] = False
                    self._admit()
        return self.outputs
