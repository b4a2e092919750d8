"""Multi-rank dry run of the parallel layer, part 1.

Twin of ``__graft_entry__.py::dryrun_multichip`` (its tensor, data and
sequence parallel part): one SGD train step of a tiny Llama over a
(dp, tp) mesh (dp = 2 when the world is even, tp = the rest), then
causal ring attention over sp = the whole world. It spawns its ranks
(``parallel/mesh.py::spawn``, with a timeout): on the card rank r drives
card r over NCCL; with ``device="cpu"`` they are gloo processes.

``--parity`` runs :func:`parity_checks` instead: the parallel layer over
the world's ranks against one rank's own computation of the same thing
(the ring bit for bit against its one-process schedule, Ulysses against
full-sequence attention, a tp = world Llama against the unsharded one),
with the ring's and Ulysses' times beside one card's full-sequence
attention (on the card: Llama-3-8B's attention over 32768 tokens and its
widths at 2 layers; on the CPU: 256 tokens and the dry run's config).

    python -m mfa_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m mfa_tpu_torch.parallel.dryrun --world 4 --device cuda --parity
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from dataclasses import replace

from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models import training
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.attention import flash_attention
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import sharding
from mfa_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    ring_flash_attention,
    ring_schedule,
)
from mfa_tpu_torch.parallel.ulysses import ulysses_attention
from mfa_tpu_torch.utils import roofline
from mfa_tpu_torch.utils.device import resolve_device
from mfa_tpu_torch.utils.testing import KERNEL_BUDGETS, budget_share


def mesh_shape(world: int) -> tuple[int, int]:
    """(dp, tp) of the train step, as ``dryrun_multichip`` picks them."""
    dp = 2 if world % 2 == 0 else 1
    return dp, world // dp


def dryrun_config(tp: int) -> llama.LlamaConfig:
    return llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=max(4, tp), n_kv_heads=max(2, tp),
                             ffn_hidden=512)


def sgd_step(model: llama.Llama, tokens, lr: float = 1e-3, *,
             dp_group=None) -> torch.Tensor:
    """``dryrun_multichip``'s step: the mean next-token NLL of tokens
    [B, T+1] and p -= lr * grad in place (dp-averaged gradients); returns
    the loss."""
    loss = training.loss_and_grads(model, tokens, dp_group=dp_group)
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad.to(p.dtype))
    return loss


def sgd_dryrun(mesh, device, jax_params=None, tokens=None) -> dict:
    """The (dp, tp) train step on ``mesh``: ``jax_params`` (``mfa_tpu``'s
    parameter tree as numpy arrays) and ``tokens`` [dp * 2, 33] replace
    the seeded random ones. Returns the loss, this rank's dp and tp
    coordinates and its updated parameter shards (numpy)."""
    dp, tp = (mesh_mod.axis_size(mesh, a) for a in ("dp", "tp"))
    cfg = dryrun_config(tp)
    if jax_params is None:
        full = llama.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            torch.float32)
    else:
        full = params_from_numpy(jax_params, cfg, device=device).params()
    if tokens is None:
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (dp * 2, 33))
    model = llama.Llama(cfg, sharding.shard_params(full, mesh, cfg),
                        device=device, trainable=True,
                        tp_group=mesh.get_group("tp"))
    toks = mesh_mod.batch_sharded(torch.as_tensor(tokens, device=device),
                                  mesh)
    loss = sgd_step(model, toks, dp_group=mesh.get_group("dp"))
    return {"loss": float(loss), "dp": mesh.get_local_rank("dp"),
            "tp": mesh.get_local_rank("tp"),
            "params": {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}}


def ring_dryrun(world: int, device) -> bool:
    """Causal ring attention over sp = the world on seeded [1, 2,
    64 * world, 64] inputs; whether this rank's O is finite."""
    sp_mesh = mesh_mod.make_mesh(sp=world, device=device)
    rng = np.random.default_rng(0)
    q, k, v = (mesh_mod.local_shard(torch.as_tensor(
        rng.standard_normal((1, 2, 64 * world, 64)), dtype=torch.float32,
        device=device), sp_mesh, {"sp": 2}).contiguous() for _ in range(3))
    o = make_ring_attention(sp_mesh, causal=True, device=device)(q, k, v)
    return bool(torch.isfinite(o).all())


def run_rank(rank: int, world: int, init_method: str,
             device: str = "cuda") -> dict:
    """One rank of the dry run (:func:`sgd_dryrun`, then
    :func:`ring_dryrun`); rank r of a CUDA run drives card r."""
    dev = (torch.device("cuda", rank) if device == "cuda"
           else resolve_device(device))
    dp, tp = mesh_shape(world)
    mesh = mesh_mod.make_mesh(dp=dp, tp=tp, device=dev,
                              init_method=init_method, rank=rank,
                              world_size=world)
    out = sgd_dryrun(mesh, dev)
    out["ring_finite"] = ring_dryrun(world, dev)
    dist.destroy_process_group()
    return out


def _same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def _attention_parity(group, world, rank, device, seq) -> dict:
    """Ring and Ulysses over ``group`` on Llama-3-8B's attention (Hq 32,
    Hkv 8, D 128, bf16, ``seq`` tokens), forward and backward."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn((1, h, seq, 128), generator=gen,
                               device=device).bfloat16()
                   for h in (32, 8, 8, 32))

    def local(x):
        return x.chunk(world, dim=2)[rank].contiguous()

    def run(attn, causal):
        leaves = [local(x).requires_grad_() for x in (q, k, v)]
        o = attn(*leaves, group=group, causal=causal, device=device)
        o.backward(local(do))
        return [o.detach()] + [t.grad for t in leaves]

    def full(causal):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = flash_attention(*leaves, causal=causal, device=device)
        o.backward(do)
        return [o.detach()] + [t.grad for t in leaves]

    out, timed = {}, device.type == "cuda"
    for causal in (False, True):
        name = "causal" if causal else "noncausal"
        got = run(ring_flash_attention, causal)
        want = ring_schedule(q, k, v, do, n=world, causal=causal,
                             device=device)
        out[f"ring_{name}_bit_equal"] = all(
            _same_bits(a, local(b)) for a, b in zip(got, want))
        got = run(ulysses_attention, causal)
        want = [local(x) for x in full(causal)]
        out[f"ulysses_{name}_bit_equal"] = all(
            _same_bits(a, b) for a, b in zip(got, want))
        out[f"ulysses_{name}_shares"] = {
            n: budget_share(a, b, *KERNEL_BUDGETS[
                "flash_fwd_o_bf16" if n == "o" else f"flash_bwd_{n}_bf16"])
            for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        if timed:
            for label, fn in (
                    ("ring", lambda: run(ring_flash_attention, causal)),
                    ("ulysses", lambda: run(ulysses_attention, causal)),
                    ("full_sequence", lambda: full(causal))):
                out[f"{label}_{name}_fwd_bwd_ms"] = roofline.cuda_ms(
                    fn, iters=5, warmup=2)
    return out


def _tp_parity(mesh, world, device, cfg) -> dict:
    """A tp = ``world`` Llama of ``cfg`` (bf16) against the unsharded one
    from the same weights: forward logits and three decode steps' (the
    unsharded model's greedy tokens fed to both), within the bf16 mixed
    budget as chip_smoke.py holds logits in context: 5e-2 times the
    larger of 1 and the largest |logit|."""
    full = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(1), torch.bfloat16)
    model = llama.Llama(cfg, full, device=device)
    tp_model = llama.Llama(cfg, sharding.shard_params(full, mesh, cfg),
                           device=device, tp_group=mesh.get_group("tp"))
    tokens = torch.randint(1, cfg.vocab_size, (2, 256), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(2))

    def share(a, b):
        scale = max(1.0, float(b.float().abs().max()))
        return float((a.float() - b.float()).abs().max()) / (5e-2 * scale)

    shares = []
    with torch.inference_mode():
        shares.append(share(tp_model(tokens), model(tokens)))
        caches = [m.make_caches(2, 264) for m in (model, tp_model)]
        want, caches[0] = model(tokens, caches=caches[0])
        got, caches[1] = tp_model(tokens, caches=caches[1])
        tok = want[:, -1].argmax(-1)
        for _ in range(3):
            want, caches[0] = model.decode_step(tok, caches[0])
            got, caches[1] = tp_model.decode_step(tok, caches[1])
            shares.append(share(got, want))
            tok = want.argmax(-1)
    return {"tp": world, "layers": cfg.n_layers, "logit_shares": shares,
            "kv_heads_a_rank": caches[1][0].k.shape[1]}


def parity_checks(world: int, device, seq: int, cfg) -> dict:
    """On this rank of an initialised world: ring and Ulysses over sp =
    ``world`` against one rank's own computation (the ring's O and
    gradients equal to its one-process schedule bit for bit, Ulysses'
    within KERNEL_BUDGETS of full-sequence flash_attention, their bits
    compared too), and a tp = ``world`` Llama of ``cfg`` against the
    unsharded one. "ok" says whether every check held."""
    device = resolve_device(device)
    rank = dist.get_rank()
    sp_mesh = mesh_mod.make_mesh(sp=world, device=device)
    out = {"rank": rank, **_attention_parity(
        sp_mesh.get_group("sp"), world, rank, device, seq)}
    tp_mesh = mesh_mod.make_mesh(tp=world, device=device)
    out.update(_tp_parity(tp_mesh, world, device, cfg))
    out["ok"] = (all(v for k, v in out.items() if k.endswith("bit_equal")
                     and k.startswith("ring"))
                 and all(x <= 1 for k, v in out.items()
                         if k.startswith("ulysses") and k.endswith("shares")
                         for x in v.values())
                 and all(x <= 1 for x in out["logit_shares"]))
    return out


def parity_rank(rank: int, world: int, init_method: str,
                device: str = "cuda") -> dict:
    """One rank of :func:`parity_checks`: on the card at S 32768 and
    Llama-3-8B's widths cut to 2 layers, on the CPU at S 256 and
    :func:`dryrun_config`."""
    on_card = device == "cuda"
    dev = torch.device("cuda", rank) if on_card else resolve_device(device)
    # A collective that a rank never joins fails in two minutes, not ten.
    mesh_mod.make_mesh(device=dev, init_method=init_method, rank=rank,
                       world_size=world, timeout_s=120)
    cfg = (replace(llama.LlamaConfig.llama3_8b(), n_layers=2) if on_card
           else dryrun_config(world))
    out = parity_checks(world, dev, 32768 if on_card else 256, cfg)
    dist.destroy_process_group()
    return out


def dryrun(world: int = 4, device: str = "cuda",
           timeout_s: float = 300.0) -> list[dict]:
    """Run :func:`run_rank` on ``world`` ranks; their results in rank
    order."""
    return mesh_mod.spawn(run_rank, world, device, timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--parity", action="store_true")
    args = ap.parse_args(argv)
    if args.parity:
        results = mesh_mod.spawn(parity_rank, args.world, args.device,
                                 timeout_s=600)
        for r in results:
            print(json.dumps(r), flush=True)
        return 0 if all(r["ok"] for r in results) else 1
    results = dryrun(args.world, args.device)
    dp, tp = mesh_shape(args.world)
    print(json.dumps({"dp": dp, "tp": tp,
                      "loss": [r["loss"] for r in results],
                      "ring_finite": all(r["ring_finite"] for r in results)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
