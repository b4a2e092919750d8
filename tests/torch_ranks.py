"""Rank functions of the port's gloo tests (test_torch_parallel.py,
test_torch_ring.py, test_torch_pipeline.py, test_torch_distributed.py,
test_torch_multihost.py).

Each test file spawns its ranks once (``mfa_tpu_torch.parallel.mesh.
spawn``); every rank runs one suite function from here and returns numpy
results (numpy only: a tensor sent between processes would go through
shared memory that dies with its rank) that the test holds against
``mfa_tpu``. The spawned processes import this module, so it imports
torch and the port only, never JAX.
"""

import os
import time
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mfa_tpu_torch.models import llama, training
from mfa_tpu_torch.models.from_jax import params_from_numpy
from mfa_tpu_torch.ops.precision import OperandPrecision
from mfa_tpu_torch.parallel import collectives, dryrun, multihost, pipeline
from mfa_tpu_torch.parallel import mesh as mesh_mod
from mfa_tpu_torch.parallel import ring_attention, sharding
from mfa_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    ring_schedule,
)
from mfa_tpu_torch.parallel.ulysses import make_ulysses_attention
from mfa_tpu_torch.serving import distributed, kv_cache
from mfa_tpu_torch.serving.scheduler import Request
from mfa_tpu_torch.utils import overlap

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


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def stage_fn(p, x):
    """tests/test_pipeline.py's stage: a residual MLP block."""
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def _stages(arrays, grad=False):
    return [{k: torch.from_numpy(v).requires_grad_(grad)
             for k, v in st.items()} for st in arrays]


def _pipeline_out(mesh, stages, x, num_micro, fn=stage_fn, grad=False):
    params = pipeline.shard_stacked(
        pipeline.stack_stages(_stages(stages)), mesh)
    if grad:
        params = {k: v.requires_grad_(True) for k, v in params.items()}
    out = pipeline.pipeline_apply(fn, params, torch.from_numpy(x),
                                  mesh=mesh, num_microbatches=num_micro)
    if not grad:
        return _np(out)
    (out ** 2).sum().backward()
    return {"stage": mesh.get_local_rank("pp"),
            "grads": {k: _np(v.grad) for k, v in params.items()}}


def _ring_waiting_first(q, k, v, group):
    """The ring's forward edited to wait for each rotation before its
    step's compute (the received chunk could be read in its own step)."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    o_acc, lse_acc = ring_attention.init_partials(q)
    kc, vc = k, v
    for s in range(n):
        src = (my - s) % n
        nxt = collectives.rotate([kc, vc], group) if s < n - 1 else None
        overlap.note("issue", "ring_forward", s, nxt)
        if nxt is not None:
            received = nxt.wait()
            overlap.note("consume", "ring_forward", s, nxt)
        o_acc, lse_acc = ring_attention.forward_step(
            q, kc, vc, o_acc, lse_acc, my=my, src=src, causal=False,
            device="cpu")
        overlap.note("compute", "ring_forward", s)
        if nxt is not None:
            kc, vc = received
    return o_acc


def _report(rep):
    return {"ok": rep.ok, "scans": rep.scans_seen,
            "permutes": rep.permutes_seen, "violations": rep.violations}


def _overlap_cases(world, data):
    out = {}
    mesh = mesh_mod.make_mesh(sp=world, device="cpu")
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in data["ring"])
    ring = make_ring_attention(mesh, causal=True, device="cpu")
    out["ring_forward"] = _report(overlap.check_overlap(ring, q, k, v))
    out["ring_grads"] = _report(overlap.check_overlap(
        lambda: ring(q, k, v).sum().backward()))
    out["ring_edited"] = _report(overlap.check_overlap(
        _ring_waiting_first, q.detach(), k.detach(), v.detach(),
        mesh.get_group("sp")))
    pp_mesh = mesh_mod.make_mesh(pp=4, device="cpu")
    if pp_mesh.get_coordinate() is not None:
        out["pipeline"] = _report(overlap.check_overlap(
            _pipeline_out, pp_mesh, data["stages4"], data["x"][4], 4))
        out["pipeline_grads"] = _report(overlap.check_overlap(
            _pipeline_out, pp_mesh, data["stages4"][:4], data["x"][4], 4,
            grad=True))
    return out


def pipeline_suite(rank, world, init, data):
    _init(rank, world, init)
    out = {"serial": {}, "schedule": {}}
    mesh = mesh_mod.make_mesh(pp=4, device="cpu")
    if mesh.get_coordinate() is not None:
        for m in (4, 8, 6):
            out["serial"][m] = _pipeline_out(mesh, data["stages4"],
                                             data["x"][m], m)
        if rank == 0:
            for m in (4, 8, 6):
                out["schedule"][m] = _np(pipeline.pipeline_schedule(
                    stage_fn, _stages(data["stages4"]),
                    torch.from_numpy(data["x"][m]), num_microbatches=m))
    mesh = mesh_mod.make_mesh(dp=2, pp=4, device="cpu")
    out["with_dp"] = _pipeline_out(mesh, data["stages_dp"], data["x_dp"], 4)

    mesh = mesh_mod.make_mesh(dp=2, pp=2, device="cpu")
    if mesh.get_coordinate() is not None:
        seen = []

        def probe(p, a):
            seen.append(tuple(a.shape))
            return stage_fn(p, a)

        _pipeline_out(mesh, data["stages_probe"], data["x_probe"], 4,
                      fn=probe)
        out["probe_shapes"] = seen

    mesh = mesh_mod.make_mesh(pp=2, device="cpu")
    if mesh.get_coordinate() is not None:
        out["grads"] = _pipeline_out(mesh, data["stages_grad"],
                                     data["x_grad"], 2, grad=True)
        cfg = replace(llama.LlamaConfig.tiny(), n_layers=4)
        model = params_from_numpy(data["llama"], cfg, device="cpu")
        tokens = torch.from_numpy(data["tokens"])
        with torch.inference_mode():
            out["llama"] = _np(llama.forward_pipelined(
                model, tokens, mesh=mesh, num_microbatches=4))
            out["llama_schedule"] = _np(llama.forward_pipeline_schedule(
                model, tokens, n_stages=2, num_microbatches=4))
        stage = pipeline.shard_stacked(
            llama.stack_layer_params(model.params(), 2), mesh)
        out["llama_stage_layers"] = int(stage["wq"].shape[0])

    x = torch.zeros(4, 2, 16)
    no_pp = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("x",))
    out["no_pp_axis"] = _raises(ValueError, lambda: pipeline.pipeline_apply(
        stage_fn, {}, x, mesh=no_pp, num_microbatches=2))
    mesh = mesh_mod.make_mesh(pp=2, device="cpu")
    out["bad_batch"] = _raises(ValueError, lambda: pipeline.pipeline_apply(
        stage_fn, {}, x, mesh=mesh, num_microbatches=3))
    out["overlap"] = _overlap_cases(world, data)
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# Sharded serving and the multi-host harness
# ---------------------------------------------------------------------------


def _decode_case(mesh, data):
    cfg = llama.LlamaConfig.tiny()
    model = params_from_numpy(data["tiny0"], cfg, device="cpu")
    caches = llama.make_caches(cfg, 4, 128, OperandPrecision.FP32,
                               device="cpu")
    for c, kv in zip(caches, data["fill"]):
        t = torch.from_numpy(kv)
        kv_cache.update(c, t, t)
    step = distributed.make_decode_step(sharding.shard_model(model, mesh),
                                        mesh)
    logits, caches = step(torch.tensor([3, 5, 7, 11]),
                          distributed.shard_caches(caches, mesh))
    return {"dp": mesh.get_local_rank("dp"), "tp": mesh.get_local_rank("tp"),
            "logits": _np(logits), "lengths": caches[0].lengths.numpy(),
            "row": _np(caches[0].k[:, :, data["ctx"]])}


def _scheduler_case(mesh, data, precision):
    cfg = llama.LlamaConfig.tiny()
    model = params_from_numpy(data["tiny1"], cfg, device="cpu")
    sched = distributed.ShardedScheduler(
        model, mesh=mesh, num_slots=2, max_len=128, kv_precision=precision,
        prompt_buckets=(8, 16), temperature=0.0, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=6) for p in data["prompts"]]
    for r in reqs:
        sched.submit(r)
    done = {c.request.id: c.tokens for c in sched.run(max_steps=64)}
    return {"tokens": [done[r.id] for r in reqs], "stats": sched.stats,
            "cache_shape": tuple(sched.caches[0].k.shape)}


def distributed_suite(rank, world, init, data):
    _init(rank, world, init)
    out = {}
    mesh = mesh_mod.make_mesh(dp=2, tp=2, device="cpu")
    out["decode"] = _decode_case(mesh, data)
    for precision in (OperandPrecision.FP32, OperandPrecision.INT8):
        out[precision.value] = _scheduler_case(mesh, data, precision)
    model = llama.Llama.init(llama.LlamaConfig.tiny(),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    out["odd_slots"] = _raises(ValueError, lambda: (
        distributed.ShardedScheduler(model, mesh=mesh, num_slots=3,
                                     device="cpu")))
    tp4 = mesh_mod.make_mesh(tp=4, device="cpu")
    out["bad_tp"] = _raises(ValueError, lambda: (
        distributed.make_decode_step(model, tp4)))
    out["bad_tp_scheduler"] = _raises(ValueError, lambda: (
        distributed.ShardedScheduler(model, mesh=tp4, num_slots=2,
                                     device="cpu")))
    out["serving_dryrun"] = dryrun.serving_dryrun(world, "cpu")
    sizes = dryrun.part2_sizes(world, on_card=False)
    out["parity_part2"] = dryrun.parity_checks_part2(world, "cpu", *sizes)
    dist.destroy_process_group()
    return out


def _harness_step(mesh):
    """tests/test_multihost.py's step: mean(tanh(x @ w)^2) over a dp
    batch of 4 rows a replica."""
    dp = mesh_mod.axis_size(mesh, "dp")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    x = mesh_mod.batch_sharded(torch.from_numpy(rng.standard_normal(
        (dp * 4, 16, 64)).astype(np.float32)), mesh)

    def step(w, x):
        return torch.mean(torch.tanh(x @ w) ** 2)

    return step, (w, x), dp * 4 * 16


def multihost_suite(rank, world, init):
    _init(rank, world, init)
    out = {"info": multihost.initialize_distributed(device="cpu")}
    out["scaling"] = multihost.dp_scaling_efficiency(
        _harness_step, dp_sizes=(1, 4), device="cpu")
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mesh = multihost.make_hybrid_mesh(dp=2, device="cpu")
    coord = mesh.get_coordinate()
    out["two_hosts"] = {"names": mesh.mesh_dim_names,
                        "ranks": mesh.mesh.tolist(),
                        "coordinate": None if coord is None else list(coord)}
    out["two_hosts_sum"] = None
    if coord is not None:
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=mesh.get_group("dp"))
        out["two_hosts_sum"] = float(t)
    del os.environ["LOCAL_WORLD_SIZE"]
    dist.destroy_process_group()
    return out
