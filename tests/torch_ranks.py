"""Rank functions of the port's gloo tests (test_torch_parallel.py,
test_torch_ring.py).

Each test file spawns its ranks once (``mfa_tpu_torch.parallel.mesh.
spawn``); every rank runs one suite function from here and returns numpy
results (numpy only: a tensor sent between processes would go through
shared memory that dies with its rank) that the test holds against
``mfa_tpu``. The spawned processes import this module, so it imports
torch and the port only, never JAX.
"""

import time
import types
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist

from mfa_tpu_torch.models import llama, training
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import dryrun, sharding
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    ring_schedule,
)
from mfa_tpu_torch.parallel.ulysses import make_ulysses_attention

MAX_LEN = 64
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def variant_config() -> llama.LlamaConfig:
    """LlamaConfig.tiny() with 4 KV heads (MHA), so that tp = 4 divides."""
    return replace(llama.LlamaConfig.tiny(), n_kv_heads=4)


def _np(t):
    return t.detach().float().numpy()


def _raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _init(rank, world, init):
    mesh_mod.make_mesh(device="cpu", init_method=init, rank=rank,
                       world_size=world)


# ---------------------------------------------------------------------------
# Tensor and data parallel Llama
# ---------------------------------------------------------------------------


def _llama_case(mesh, cfg, tree, data, precision=None):
    full = params_from_numpy(tree, cfg, device="cpu").params()
    if precision is not None:
        full = llama.quantize_params(full, precision)
    model = llama.Llama(cfg, sharding.shard_params(full, mesh, cfg),
                        device="cpu", tp_group=mesh.get_group("tp"))

    def local(x):
        return mesh_mod.batch_sharded(torch.from_numpy(x), mesh)

    out = {"dp": mesh.get_local_rank("dp"),
           "tp": mesh.get_local_rank("tp"),
           "logits": _np(model(local(data["tokens"])))}
    if precision is not None:
        return out
    caches = [sharding.shard_cache(c, mesh) for c in llama.make_caches(
        cfg, data["prompt"].shape[0], MAX_LEN, device="cpu")]
    logits, caches = model(local(data["prompt"]), caches=caches)
    out["prefill"] = _np(logits)
    out["decode"] = []
    for tok in data["decode"]:
        logits, caches = model.decode_step(local(tok), caches)
        out["decode"].append(_np(logits))
    out["cache_heads"] = caches[0].k.shape[1]
    return out


def _local_grads(ref, mesh, cfg):
    """The shards of a single-process model's gradients, by name."""
    tree = {"embed": ref.embed.grad, "final_norm": ref.final_norm.grad,
            "lm_head": ref.lm_head.grad,
            "layers": [{n: p.grad for n, p in layer.named_parameters()}
                       for layer in ref.layers]}
    return dict(llama.Llama(cfg, sharding.shard_params(tree, mesh, cfg),
                            device="cpu").named_parameters())


def _adamw_case(mesh, cfg, tree, tokens, steps):
    """The port's AdamW train_step over (dp, tp) against its own
    single-process step from the same parameters: each step's loss and
    grad norm, the first step's gradients, the parameters after
    ``steps``."""
    opt = training.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    ref = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    ref_state = training.create_train_state(ref, opt)
    model = llama.Llama(
        cfg, sharding.shard_params(
            params_from_numpy(tree, cfg, device="cpu").params(), mesh, cfg),
        device="cpu", trainable=True, tp_group=mesh.get_group("tp"))
    state = training.create_train_state(model, opt)
    toks = torch.from_numpy(tokens)
    out = {"steps": []}
    for step in range(steps):
        want = training.train_step(ref_state, toks)
        got = training.train_step(state, mesh_mod.batch_sharded(toks, mesh),
                                  dp_group=mesh.get_group("dp"))
        out["steps"].append({k: (float(got[k]), float(want[k]))
                             for k in got})
        if step == 0:
            grads = _local_grads(ref, mesh, cfg)
            out["grads"] = {n: (_np(p.grad), _np(grads[n]))
                            for n, p in model.named_parameters()}
    params = dict(llama.Llama(cfg, sharding.shard_params(
        ref.params(), mesh, cfg), device="cpu").named_parameters())
    out["param_diff"] = {n: float((p - params[n]).abs().max())
                         for n, p in model.named_parameters()}
    return out


def llama_suite(rank, world, init, data):
    _init(rank, world, init)
    tiny, variant = llama.LlamaConfig.tiny(), variant_config()
    out = {}
    for name, cfg, key, shape, precision in (
            ("tp2", tiny, "tiny", dict(tp=2), None),
            ("dp2_tp2", tiny, "tiny", dict(dp=2, tp=2), None),
            ("tp4", variant, "variant", dict(tp=4), None),
            ("int8_tp2", tiny, "tiny", dict(tp=2), OperandPrecision.INT8),
            ("int8_tp4", variant, "variant", dict(tp=4),
             OperandPrecision.INT8)):
        mesh = mesh_mod.make_mesh(**shape, device="cpu")
        if mesh.get_coordinate() is not None:
            out[name] = _llama_case(mesh, cfg, data[key], data, precision)
    mesh = mesh_mod.make_mesh(dp=2, tp=2, device="cpu")
    out["sgd"] = dryrun.sgd_dryrun(mesh, "cpu", data["dryrun_params"],
                                   data["dryrun_tokens"])
    out["adamw"] = _adamw_case(mesh, tiny, data["tiny"], data["train_tokens"],
                               steps=3)
    out["parity"] = dryrun.parity_checks(world, "cpu", 256,
                                         dryrun.dryrun_config(world))
    out["too_few_ranks"] = _raises(ValueError, lambda: mesh_mod.make_mesh(
        dp=4, tp=4, sp=4, device="cpu"))
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# Ring and Ulysses attention
# ---------------------------------------------------------------------------


def _attention(kind, mesh, causal):
    make = make_ring_attention if kind == "ring" else make_ulysses_attention
    return make(mesh, causal=causal, device="cpu")


def _attention_case(mesh, case):
    dtype = DTYPES[case["dtype"]]
    cut = {"tp": 1, "sp": 2}
    q, k, v, do = (mesh_mod.local_shard(torch.from_numpy(a).to(dtype), mesh,
                                        cut).contiguous()
                   for a in case["inputs"])
    fn = _attention(case["kind"], mesh, case["causal"])
    out = {"tp": mesh.get_local_rank("tp"),
           "sp": mesh.get_local_rank("sp")}
    if not case["grads"]:
        out["o"] = _np(fn(q, k, v))
        return out
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    (o.float() * do.float()).sum().backward()
    out.update(o=_np(o), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    return out


def attention_suite(rank, world, init, cases):
    _init(rank, world, init)
    out = {}
    for case in cases:
        mesh = mesh_mod.make_mesh(**case["mesh"], device="cpu")
        if mesh.get_coordinate() is not None:
            out[case["name"]] = _attention_case(mesh, case)
    # The one-process schedule of every rank's steps, on rank 0's single
    # thread like the ranks' own.
    if rank == 0:
        for case in cases:
            if case["kind"] == "ring" and case["grads"] and \
                    "tp" not in case["mesh"]:
                dtype = DTYPES[case["dtype"]]
                q, k, v, do = (torch.from_numpy(a).to(dtype)
                               for a in case["inputs"])
                out["schedule_" + case["name"]] = [_np(x) for x in (
                    ring_schedule(q, k, v, do, n=case["mesh"]["sp"],
                                  causal=case["causal"], device="cpu"))]
    mesh = mesh_mod.make_mesh(sp=4, device="cpu")
    if mesh.get_coordinate() is not None:
        x = torch.zeros(1, 2, 16, 16)
        out["bad_heads"] = _raises(ValueError, lambda: make_ulysses_attention(
            mesh, device="cpu")(x, x, x))
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# The kernel build under several processes
# ---------------------------------------------------------------------------


class _StandInLibrary:
    """Takes the argtypes and restype the loader sets on each entry."""

    def __getattr__(self, name):
        return types.SimpleNamespace()


def build_once(rank, world, init, build_dir):
    """kernels/build.py::library in every rank at once, with a stand-in
    compiler that notes each build in ``build_dir``/compiles and takes
    half a second; returns this rank's build log."""
    from mfa_tpu_torch.kernels import build

    def compile_(srcs, lib_path):
        with open(Path(build_dir) / "compiles", "a") as f:
            f.write(f"{rank}\n")
        time.sleep(0.5)
        lib_path.write_bytes(b"")
        return "compiled"

    build.BUILD_DIR = Path(build_dir)
    build._compile = compile_
    build.ctypes = types.SimpleNamespace(
        CDLL=lambda path: _StandInLibrary(), c_int=int)
    return build.library().build_log
