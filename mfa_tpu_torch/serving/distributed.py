"""Multi-card serving: the continuous-batching scheduler over a (dp, tp)
mesh.

Twin of ``mfa_tpu/serving/distributed.py``, the subsystem that serves the
JAX package's ``BASELINE.json`` configuration 5 ("Llama-3-8B decode,
continuous batching on 2-host"). There one host program drives global
arrays; here every rank runs the same host scheduler on rank-local
tensors:

- **Slots.** A rank holds its dp block of ``num_slots / dp`` slots and
  its tp block of KV heads; the caches are created at that size.
- **Decode.** One step runs the fused decode kernel (K2) on the local
  ``(B/dp, Hkv/tp)`` shard, the Megatron all-reduces and the logits'
  all-gather over tp inside the model (``models/llama.py``), then an
  all-gather of the logits over dp. Every rank then samples the same
  ``[B, vocab]`` with a generator seeded the same on every rank, so
  admission and retirement stay identical across ranks.
- **Prefill.** Replicated over dp and sharded over tp, as ``mfa_tpu``
  does: every rank prefills the prompt with its tp shard, and only the
  ranks whose dp block holds the slot splice it.

tp must divide ``n_kv_heads`` (8 for Llama-3-8B: tp <= 8), so each rank
keeps whole GQA groups.
"""

from __future__ import annotations

from mfa_tpu_torch.parallel import collectives
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import sharding
from mfa_tpu_torch.serving.sampling import sample
from mfa_tpu_torch.serving.scheduler import ContinuousBatchingScheduler


def cache_spec(batch_axis: str = "dp", head_axis: str = "tp") -> dict:
    """The dims of a ``KVCache``'s tensors cut over the mesh (``{axis:
    dim}`` per tensor): batch over dp, KV heads over tp."""
    data = {batch_axis: 0, head_axis: 1}
    return {"k": data, "v": data, "k_scale": data, "v_scale": data,
            "lengths": {batch_axis: 0}}


def replicated_cache_spec(head_axis: str = "tp") -> dict:
    """A batch-1 prefill cache's: replicated over dp, heads over tp."""
    data = {head_axis: 1}
    return {"k": data, "v": data, "k_scale": data, "v_scale": data,
            "lengths": {}}


def shard_caches(caches, mesh) -> list:
    """This rank's blocks of global caches (``sharding.shard_cache``)."""
    return [sharding.shard_cache(c, mesh) for c in caches]


def _check_tp(cfg, mesh) -> None:
    tp = mesh_mod.axis_size(mesh, "tp")
    if cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads}")


def make_decode_step(model, mesh):
    """The multi-card decode step of ``model``, this rank's tp shard
    (``sharding.shard_model``): ``fn(tokens [B], caches) -> (logits [B,
    vocab], caches)`` takes every slot's token and this rank's caches
    ``(B/dp, Hkv/tp)`` and returns every slot's logits on every rank."""
    _check_tp(model.cfg, mesh)
    dp_group = mesh.get_group("dp")

    def step(tokens, caches):
        local = mesh_mod.batch_sharded(tokens, mesh)
        logits, caches = model.decode_step(local, caches)
        return collectives.all_gather(logits, dp_group, dim=0), caches

    return step


def make_prefill(model, mesh, precision, max_len: int):
    """The batch-1 prefill of ``model``, this rank's tp shard, replicated
    over dp: ``fn(tokens [bucket], true_len) -> (last logits [vocab],
    batch-1 caches of this rank's KV heads)``."""
    _check_tp(model.cfg, mesh)

    def prefill(tokens, true_len: int):
        caches1 = model.make_caches(1, max_len, precision)
        logits, caches1 = model(tokens[None, :], caches=caches1)
        return logits[0, true_len - 1], caches1

    return prefill


class ShardedScheduler(ContinuousBatchingScheduler):
    """Continuous batching over a (dp, tp) mesh.

    The host behaviour is the single-card scheduler's (admission,
    retirement, buckets: the same greedy tokens); ``model`` (the whole
    model) is cut to this rank's tp shard (at tp = 1 its own tensors, no
    copy), the caches hold this rank's slots and heads, and the prefill,
    splice, reset and decode steps are the mesh's. ``num_slots`` must
    divide by dp. Every rank of the mesh runs it with the same requests.
    """

    def __init__(self, model, *, mesh, num_slots: int = 8, **kw):
        self.mesh = mesh
        self.dp = mesh_mod.axis_size(mesh, "dp")
        if num_slots % self.dp:
            raise ValueError(f"num_slots={num_slots} must be a multiple of "
                             f"mesh dp={self.dp}")
        _check_tp(model.cfg, mesh)
        self.local_slots = num_slots // self.dp
        self.first_slot = mesh.get_local_rank("dp") * self.local_slots
        super().__init__(sharding.shard_model(model, mesh),
                         num_slots=num_slots, **kw)
        self._prefill_fn = make_prefill(self.model, mesh, self.kv_precision,
                                        self.max_len)
        self._step = make_decode_step(self.model, mesh)

    def _slot_caches(self):
        return self.model.make_caches(self.local_slots, self.max_len,
                                      self.kv_precision)

    def _local(self, slot: int) -> int | None:
        """``slot``'s index in this rank's caches, None if another dp
        block holds it."""
        i = slot - self.first_slot
        return i if 0 <= i < self.local_slots else None

    def _prefill(self, tokens, true_len: int):
        return self._prefill_fn(tokens, true_len)

    def _splice(self, slot: int, caches1, true_len: int):
        i = self._local(slot)
        if i is not None:
            super()._splice(i, caches1, true_len)

    def _reset(self, slot: int):
        i = self._local(slot)
        if i is not None:
            super()._reset(i)

    def _decode(self, tokens):
        logits, self.caches = self._step(tokens, self.caches)
        return sample(logits, self.generator, temperature=self.temperature)
