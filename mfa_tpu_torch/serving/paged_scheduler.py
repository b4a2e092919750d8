"""Paged continuous-batching scheduler: serving over paged KV memory.

Port of ``mfa_tpu/serving/paged_scheduler.py``. KV memory is allocated in
pages by actual sequence length, so more sequences fit than with the
contiguous slots of ``serving/scheduler.py``, and a finished request's
pages return to the shared pool at once.

Division of labour:
- device: one batched decode step; per layer, a single-token append of
  every slot into its page (an indexed write), then paged attention (K6)
  over the lengths after the append, so the new token is read back in its
  stored, quantized form;
- host: the page allocator. Before each step it gives every active slot
  a page for the next token, so the step never allocates. Admission
  counts only the prompt's pages and defers the queue head
  (``oom_deferred``) when they are not free. A prompt prefills through
  the model's contiguous path into a batch-1 bf16 cache of
  ``bucket + 1`` rows, which is quantized into pages as it is spliced.

Each ``step()`` records a ``tick`` span into ``utils/tracing.py``'s
``metrics`` (its counts: pages reserved, tokens held, page size) with
the children ``retire``, ``admit`` (one ``prefill`` a request: forward,
splice and the first token's sample, with its ``req``, true ``prompt``
tokens and ``bucket`` tokens), ``prepare`` (the allocator and the
page-table upload), ``decode`` (enqueueing the step), ``sync`` (the
host waiting for the sampled tokens) and ``emit``; ``submit`` records
an instant with the request's id.

Every layer's ``PagedKVCache`` in ``mfa_tpu`` gets the same page ids: the
layers start alike and see the same allocator calls in the same order.
This port therefore keeps ONE allocator (``self.cache``, which also holds
layer 0's pool) and one device page table for all layers, uploaded once
per step; each layer has its own pool (``self.pools``).
"""

from __future__ import annotations

import numpy as np
import torch

from mfa_tpu_torch.kernels import quant
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.llama import Llama
from mfa_tpu_torch.ops.decode import paged_decode_attention
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.serving.paged_kv_cache import (
    PAGE_SIZE,
    PagedKVCache,
    PagePool,
    splice_pages,
)
from mfa_tpu_torch.serving.sampling import sample
from mfa_tpu_torch.serving.scheduler import Completion, Request, _bucket
from mfa_tpu_torch.utils.device import resolve_device
from mfa_tpu_torch.utils.tracing import metrics

__all__ = ["PagedScheduler", "PAGE_SIZE"]


def _append_token_batch(pool: PagePool, tables, lengths, k_new, v_new):
    """Write one token per sequence into the pool, in place.

    tables [B, max_pages] int32; lengths [B] int32, the lengths BEFORE the
    append; k_new, v_new [B, Hkv, D]. A slot of length 0 with an empty
    table writes row 0 of the null page.
    """
    ps = pool.page_size
    lens = lengths.long()
    pages = tables.long().gather(1, (lens // ps)[:, None])     # [B, 1]
    rows = (lens % ps)[:, None]                                # [B, 1]
    heads = torch.arange(pool.num_kv_heads, device=lens.device)[None, :]
    for buf, scales, x in ((pool.k_pages, pool.k_scale, k_new),
                           (pool.v_pages, pool.v_scale, v_new)):
        xq, xs = quant.quantize_for(buf.dtype, x)
        buf[pages, heads, rows] = xq
        scales[pages, heads, rows] = xs


class _CacheView:
    """One layer's pool with the step's shared tables and lengths, in the
    shape paged_decode_attention takes."""

    def __init__(self, pool: PagePool, max_pages: int, tables, lengths):
        self.pool = pool
        self.max_pages = max_pages
        self._tables = tables
        self._lengths = lengths

    def device_tables(self):
        return self._tables, self._lengths


class PagedScheduler:
    """Continuous batching over paged KV memory.

    Usage:
        sched = PagedScheduler(model, num_slots=8, num_pages=512)
        sched.submit(Request(prompt=[...], max_new_tokens=64))
        done = sched.run()          # or step() repeatedly
    """

    def __init__(self, model: Llama, *, num_slots: int = 8,
                 num_pages: int = 512, max_len: int = 2048,
                 kv_precision: OperandPrecision = OperandPrecision.BF16,
                 prompt_buckets=(64, 128, 256, 512, 1024, 2048),
                 temperature: float = 0.0, seed: int = 0,
                 page_size: int = 4 * PAGE_SIZE, device="cuda"):
        # mfa_tpu's default page is 512 tokens: fewer, larger page reads
        # for at most page_size - 1 tokens of waste per sequence.
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, scheduler on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg = model.cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_precision = kv_precision
        self.prompt_buckets = tuple(b for b in prompt_buckets if b <= max_len)
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.cache = PagedKVCache(num_pages, cfg.n_kv_heads, cfg.head_dim,
                                  num_slots, max_len, kv_precision,
                                  page_size=page_size, device=self.device)
        self.pools = [self.cache.pool] + [
            PagePool.create(num_pages, cfg.n_kv_heads, cfg.head_dim,
                            page_size, kv_precision, device=self.device)
            for _ in range(cfg.n_layers - 1)]
        self.queue: list[Request] = []
        self.slots: list[dict | None] = [None] * num_slots
        self.last_tokens = np.zeros((num_slots,), np.int64)
        self.finished: list[Completion] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "oom_deferred": 0}

    @property
    def free_pages(self) -> int:
        return self.cache.free_pages

    # -- device steps -----------------------------------------------------

    def _decode_step(self, tokens, tables, lengths):
        """One batched decode step: tokens [B], tables [B, max_pages] and
        lengths [B] (before the append) on the device → logits [B, vocab].
        Appends every slot's token to every layer's pool."""
        model, cfg = self.model, self.cfg
        b = tokens.shape[0]
        positions = lengths.long()[:, None]
        after = lengths + 1
        inv_freq = llama.rope_frequencies(cfg, self.device)
        x = model.embed[tokens][:, None, :]
        for pool, layer in zip(self.pools, model.layers):
            h = llama.rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q, k, v = llama._project_qkv(layer, h, cfg)       # [B, H, 1, D]
            q = llama.apply_rope(q, positions, inv_freq)
            k = llama.apply_rope(k, positions, inv_freq)
            _append_token_batch(pool, tables, lengths, k[:, :, 0], v[:, :, 0])
            view = _CacheView(pool, self.cache.max_pages, tables, after)
            o = paged_decode_attention(q[:, :, 0], view,
                                       sliding_window=cfg.sliding_window,
                                       device=self.device)
            x = x + llama._matmul(o.reshape(b, 1, -1), layer.wo)
            x = x + llama._mlp(layer, llama.rms_norm(x, layer.mlp_norm,
                                                     cfg.norm_eps))
        return llama._lm_head(model, x[:, 0])

    def _step_inputs(self):
        """The decode step's device inputs: last tokens, tables, lengths."""
        tables, lengths = self.cache.device_tables()
        return (torch.from_numpy(self.last_tokens).to(self.device), tables,
                lengths)

    def _prefill(self, tokens: torch.Tensor, true_len: int):
        """The bucketed prompt through forward into a batch-1 bf16 cache of
        bucket + 1 rows; returns (last-position logits, the caches)."""
        caches1 = self.model.make_caches(1, tokens.shape[0] + 1,
                                         OperandPrecision.BF16)
        logits, caches1 = self.model(tokens[None, :], caches=caches1)
        return logits[0, true_len - 1], caches1

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.cache.page_size)

    def _splice_prefill_all(self, slot: int, t: int, caches1):
        """Write a prefill's K/V into every layer's pool: the rows past the
        true length are zeroed, and the pool's format is quantized at the
        splice. The host only assigns page ids."""
        n_pages = self._pages_needed(t)
        t_pad = n_pages * self.cache.page_size
        self.cache._ensure_capacity(slot, t)
        ids = torch.as_tensor(self.cache.page_tables[slot, :n_pages],
                              dtype=torch.long, device=self.device)
        self.cache.lengths[slot] = t
        for pool, c1 in zip(self.pools, caches1):
            kv = []
            for buf in (c1.k, c1.v):
                x = buf[0, :, :t_pad].float()          # [Hkv, <= t_pad, D]
                x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - x.shape[1]))
                x[:, t:] = 0.0
                kv.append(x)
            splice_pages(pool, ids, *kv)

    # -- host-side orchestration -----------------------------------------

    def submit(self, request: Request):
        metrics.event("submit", req=request.id)
        self.queue.append(request)

    def _admit(self):
        for slot in [i for i, s in enumerate(self.slots) if s is None]:
            if not self.queue:
                break
            req = self.queue[0]
            t = len(req.prompt)
            # Admission control: defer (rather than fail mid-request) when
            # the prompt's pages are not free now.
            if self._pages_needed(t + 1) > self.free_pages:
                self.stats["oom_deferred"] += 1
                break
            self.queue.pop(0)
            bucket = _bucket(t, self.prompt_buckets)
            # Ends when the host holds the first token.
            with metrics.span("prefill", req=req.id, prompt=t,
                              bucket=bucket):
                tokens = np.zeros((bucket,), np.int64)
                tokens[:t] = req.prompt
                last_logits, caches1 = self._prefill(
                    torch.from_numpy(tokens).to(self.device), t)
                self._splice_prefill_all(slot, t, caches1)
                tok = int(sample(last_logits[None, :], self.generator,
                                 temperature=self.temperature)[0])
            self.slots[slot] = {"request": req, "generated": [tok],
                                "prefill_len": t}
            self.last_tokens[slot] = tok
            self.stats["prefills"] += 1
            self.stats["tokens"] += 1

    def _retire(self):
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            req, gen = s["request"], s["generated"]
            done = len(gen) >= req.max_new_tokens or (
                req.eos_token is not None and gen
                and gen[-1] == req.eos_token)
            overflow = s["prefill_len"] + len(gen) + 1 >= self.max_len
            if done or overflow:
                self.finished.append(Completion(req, list(gen),
                                                s["prefill_len"]))
                self.slots[i] = None
                self.cache.free_seq(i)

    def _ensure_decode_capacity(self):
        for i, s in enumerate(self.slots):
            if s is not None:
                self.cache._ensure_capacity(
                    i, int(self.cache.lengths[i]) + 1)

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick: retire, admit, one batched decode step."""
        cache = self.cache
        with metrics.span("tick",
                          pages=cache.pool.num_pages - 1 - cache.free_pages,
                          tokens=int(cache.lengths.sum()),
                          page_size=cache.page_size):
            with metrics.span("retire"):
                self._retire()
            with metrics.span("admit"):
                self._admit()
            if not any(s is not None for s in self.slots):
                return False
            with metrics.span("prepare"):
                self._ensure_decode_capacity()
                inputs = self._step_inputs()
            with metrics.span("decode"):
                logits = self._decode_step(*inputs)
                # Only active slots really appended (inactive ones wrote
                # into the null page); keep the host lengths in step.
                active = np.asarray([s is not None for s in self.slots],
                                    np.int32)
                cache.lengths += active
            with metrics.span("sync"):
                toks = sample(logits, self.generator,
                              temperature=self.temperature).cpu().numpy()
            with metrics.span("emit"):
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
