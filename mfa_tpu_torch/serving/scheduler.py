"""Continuous-batching scheduler: slot-based serving over bucketed prompts.

Port of ``mfa_tpu/serving/scheduler.py``. Decode runs at a fixed batch
of slots; a prompt prefills at its bucket length (power-of-two padded)
into a batch-1 cache, which is spliced into a free slot with the slot's
length set back to the true prompt length. A finished slot is refilled
by the next queued request between steps. Every step runs under
``torch.inference_mode()``: serving never builds an autograd graph.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from mfa_tpu_torch.models.llama import Llama
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving import kv_cache as kv_mod
from mfa_tpu_torch.serving.sampling import sample
from mfa_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    prompt: list            # token ids
    max_new_tokens: int = 32
    eos_token: int | None = None
    id: int = dataclasses.field(default_factory=itertools.count().__next__)


@dataclasses.dataclass
class Completion:
    request: Request
    tokens: list
    prefill_len: int


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class ContinuousBatchingScheduler:
    """Slot-based continuous batching for one model replica.

    Usage:
        sched = ContinuousBatchingScheduler(model, num_slots=8,
                                            max_len=2048)
        sched.submit(Request(prompt=[...], max_new_tokens=64))
        done = sched.run()          # or step() repeatedly
    """

    def __init__(self, model: Llama, *, num_slots: int = 8,
                 max_len: int = 2048,
                 kv_precision: OperandPrecision = OperandPrecision.BF16,
                 prompt_buckets=(64, 128, 256, 512, 1024, 2048),
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, scheduler on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_precision = kv_precision
        self.prompt_buckets = tuple(b for b in prompt_buckets if b <= max_len)
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.caches = self._slot_caches()
        self.queue: list[Request] = []
        self.slots: list[dict | None] = [None] * num_slots
        self.last_tokens = np.zeros((num_slots,), np.int64)
        self.finished: list[Completion] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0}

    # -- device steps -----------------------------------------------------

    def _slot_caches(self):
        """The caches of the slots this scheduler holds."""
        return self.model.make_caches(self.num_slots, self.max_len,
                                      self.kv_precision)

    def _prefill(self, tokens: torch.Tensor, true_len: int):
        """Run the bucketed prompt through forward with a batch-1 cache;
        return (last-position logits, the batch-1 caches)."""
        caches1 = self.model.make_caches(1, self.max_len, self.kv_precision)
        logits, caches1 = self.model(tokens[None, :], caches=caches1)
        return logits[0, true_len - 1], caches1

    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, self.caches = self.model.decode_step(tokens, self.caches)
        return sample(logits, self.generator, temperature=self.temperature)

    def _splice(self, slot: int, caches1, true_len: int):
        """Write a batch-1 prefilled cache into ``slot`` of every layer's
        cache, its length set back to the prompt's."""
        for c, c1 in zip(self.caches, caches1):
            kv_mod.write_slot(c, slot, c1, true_len)

    def _reset(self, slot: int):
        """Free ``slot`` in every layer's cache."""
        for c in self.caches:
            kv_mod.reset_slot(c, slot)

    # -- host-side orchestration -----------------------------------------

    def submit(self, request: Request):
        self.queue.append(request)

    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def _admit(self):
        """Prefill queued requests into free slots (continuous admission)."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            t = len(req.prompt)
            bucket = _bucket(t, self.prompt_buckets)
            tokens = np.zeros((bucket,), np.int64)
            tokens[:t] = req.prompt
            last_logits, caches1 = self._prefill(
                torch.from_numpy(tokens).to(self.device), t)
            self._splice(slot, caches1, t)
            tok = int(sample(last_logits[None, :], self.generator,
                             temperature=self.temperature)[0])
            self.slots[slot] = {"request": req, "generated": [tok],
                                "prefill_len": t}
            self.last_tokens[slot] = tok
            self.stats["prefills"] += 1
            self.stats["tokens"] += 1

    @torch.inference_mode()
    def _retire(self):
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            req = s["request"]
            gen = s["generated"]
            done = len(gen) >= req.max_new_tokens or (
                req.eos_token is not None and gen and gen[-1] == req.eos_token)
            overflow = s["prefill_len"] + len(gen) >= self.max_len
            if done or overflow:
                self.finished.append(
                    Completion(req, list(gen), s["prefill_len"]))
                self.slots[i] = None
                self._reset(i)

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick: retire, admit, one batched decode step."""
        self._retire()
        self._admit()
        if not any(s is not None for s in self.slots):
            return False
        toks = self._decode(
            torch.from_numpy(self.last_tokens).to(self.device)).cpu().numpy()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s["generated"].append(int(toks[i]))
            self.last_tokens[i] = int(toks[i])
            self.stats["tokens"] += 1
        self.stats["decode_steps"] += 1
        return True

    @torch.inference_mode()
    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        self._retire()
        return self.finished
