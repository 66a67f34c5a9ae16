"""Batched serving engine: continuous-batching decode over a fixed slot pool
(port of ``repro.serve.engine``).

  * ``n_slots`` concurrent sequences share one decode-state allocation
    (slot = batch row): a KV cache, a recurrent state (rwkv6, Mamba2) or
    both (zamba2).
  * Requests queue in; a free slot is filled by running prefill for one
    request, whose state then replaces the slot's row of the pool, and
    the slot joins the batched decode step.
  * Finished slots (EOS, max_new_tokens, or a full cache) are released.

The host loop, the slot pool, admit/step/run and the stop rules are the
reference's.  So is the pool's one shared length: slots decode in
lockstep from ``max(pooled_len, prompt_len)``, which never shrinks, so RoPE
positions and the decode mask follow the pooled length; a request that
joins behind a longer one attends to the zero K/V rows in its gap, and
its tokens depend on its neighbours.  Past ``max_len`` the cache write
clamps to the last row (``models/attention.py``).

The model's weights are cast to the compute dtype once, when the engine
is built (``model.compute_params``), instead of at every product.
Sampling draws from one ``torch.Generator`` on the model's device; greedy
rows (temperature 0) take the first maximum, as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.registry import ModelAPI
from repro_torch.serve import sampling


@dataclasses.dataclass
class Request:
    uid: int
    tokens: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    max_len: int = 512
    eos_id: int = 2
    prompt_bucket: int = 64        # carried; prompts are not padded


class ServeEngine:
    """Host-side continuous batching around prefill and decode steps on the
    device that holds ``params``."""

    def __init__(self, model: ModelAPI, params, ecfg: EngineConfig,
                 generator: torch.Generator | None = None):
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.device = next(params.parameters()).device
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self.compute_params = model.compute_params(params)

        self._decode = lambda p, tok, st: model.decode_step(p, tok, st)
        self._prefill = lambda p, batch: model.prefill(p, batch,
                                                       ecfg.max_len)

        # slot-pool state (single shared decode batch)
        self.state = model.init_decode_state(ecfg.n_slots, ecfg.max_len,
                                             device=self.device)
        self.slot_req: list[Request | None] = [None] * ecfg.n_slots
        self.slot_len = np.zeros(ecfg.n_slots, np.int32)
        self.last_token = np.zeros((ecfg.n_slots, 1), np.int64)
        self.queue: list[Request] = []
        self._uid = 0
        self.stats = {"prefills": 0, "prefill_tokens": 0,
                      "decode_steps": 0, "peak_len": 0}

    # ------------------------------------------------------------- plumbing
    def submit(self, tokens: list[int], max_new_tokens: int = 32,
               temperature: float = 0.0) -> Request:
        req = Request(self._uid, list(tokens), max_new_tokens, temperature)
        self._uid += 1
        self.queue.append(req)
        return req

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _merge(self, pool, single, slot: int):
        """``single`` (a one-sequence state tree) written into slot ``slot``
        of ``pool`` in place.  Each tensor's batch axis is the first where
        the pool has ``n_slots`` and the single state 1; a scalar, or a
        leaf of the pool's own shape, is taken from ``single``."""
        if isinstance(pool, dict):
            return {k: self._merge(pool[k], single[k], slot) for k in pool}
        if (not isinstance(pool, torch.Tensor) or pool.ndim == 0
                or pool.shape == single.shape):
            return single
        for ax in range(pool.ndim):
            if pool.shape[ax] == self.ecfg.n_slots and single.shape[ax] == 1:
                pool.narrow(ax, slot, 1).copy_(single)
                return pool
        raise ValueError(f"no batch axis: {tuple(pool.shape)} vs "
                         f"{tuple(single.shape)}")

    def _write_slot(self, slot: int, prefill_state, req: Request,
                    first_logits):
        """Merge a single-sequence prefill state (any model's tree: a K/V
        cache of all ``max_len`` rows, a recurrent state, both) into slot
        ``slot`` of the shared pool."""
        plen = prefill_state["len"]
        pooled_len = self.state["len"]
        self.state = self._merge(self.state, prefill_state, slot)
        # shared scalar length: slots decode in lockstep from the pooled
        # max; per-slot logical lengths are tracked host-side
        self.state["len"] = max(pooled_len, plen)
        self.slot_req[slot] = req
        self.slot_len[slot] = plen
        tok = int(sampling.sample(first_logits[:, -1, :], req.temperature,
                                  self.generator)[0])
        self.last_token[slot] = tok
        req.out_tokens.append(tok)

    # ----------------------------------------------------------------- run
    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            toks = torch.tensor([req.tokens], dtype=torch.int64,
                                device=self.device)
            logits, pstate = self._prefill(self.compute_params,
                                           {"tokens": toks})
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += len(req.tokens)
            self._write_slot(slot, pstate, req, logits)

    def step(self):
        """One engine iteration: admit + one batched decode step."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return
        tok = torch.from_numpy(self.last_token).to(self.device)
        logits, self.state = self._decode(self.compute_params, tok,
                                          self.state)
        self.stats["decode_steps"] += 1
        self.stats["peak_len"] = max(self.stats["peak_len"],
                                     self.state["len"])
        temps = [0.0 if r is None else r.temperature for r in self.slot_req]
        toks = sampling.sample(logits[:, -1, :], temps,
                               self.generator).tolist()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            t_int = toks[slot]
            req.out_tokens.append(t_int)
            self.last_token[slot] = t_int
            self.slot_len[slot] += 1
            if (t_int == self.ecfg.eos_id
                    or len(req.out_tokens) >= req.max_new_tokens
                    or int(self.slot_len[slot]) >= self.ecfg.max_len - 1):
                req.done = True
                self.slot_req[slot] = None

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
