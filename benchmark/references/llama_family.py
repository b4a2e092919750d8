"""Plain float32 reference of a Llama-family decoder (Mistral, Qwen2).

Follows the published architecture: token embedding; per block a
pre-norm RMSNorm, the Q, K and V projections (with Qwen2's bias), rotary
phases on the half-split pairs (theta from the config), causal softmax
attention of every query head over its group's K/V head, keeping the
last ``sliding_window`` keys of each query where the config has a window,
the output projection, a second RMSNorm and the SiLU-gated MLP, each added
to the residual; the final RMSNorm and the output head.

Serving state that the configuration states is part of the semantics:
where the cell stores its KV pages in FP8-e4m3, every query that a decode
step answers (the positions after the prompt) attends over K and V rows
rounded to FP8 with one scale per row (max |x| / 448), as stored; the
prompt's own positions attend over the exact rows, as prefill does.

Plain PyTorch in float32 with TF32 off, one block at a time: each block's
weights are widened to float32 only while it runs. It imports nothing of
the program. The checks' control is this reference with both operands of
every projection rounded to FP8-e4m3, one scale a row (``fp8``): the
precision below the bf16 the configurations state.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = {"fp8_e4m3": (torch.float8_e4m3fn, 448.0)}


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, theta):
    """x [H, T, D] at positions 0..T-1."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float64,
                       device=x.device)[:, None] * inv
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def stored(x, storage: str):
    """K or V rows [H, T, D] as the pages hold them, back in float32."""
    if storage not in FP8_MAX:
        return x
    dtype, qmax = FP8_MAX[storage]
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / qmax
    return (x / scale).to(dtype).float() * scale


def _attend(q, k, v, rows: range, window, block: int = 512):
    """Causal attention of the query rows ``rows`` over keys 0..row."""
    h, _, d = q.shape
    group = h // k.shape[0]
    out = torch.empty((h, len(rows), d), device=q.device)
    scale = d ** -0.5
    for s in range(rows.start, rows.stop, block):
        e = min(s + block, rows.stop)
        kk = k[:, :e].repeat_interleave(group, 0)
        vv = v[:, :e].repeat_interleave(group, 0)
        sc = torch.matmul(q[:, s:e], kk.transpose(1, 2)) * scale
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(e, device=q.device)[None, :]
        keep = j <= i
        if window is not None:
            keep &= j > i - window
        sc = sc.masked_fill(~keep, float("-inf"))
        out[:, s - rows.start:e - rows.start] = torch.matmul(
            torch.softmax(sc, -1), vv)
    return out


def _fp8(x):
    """x rounded to FP8-e4m3, a scale a row; gradients pass straight
    through the rounding."""
    with torch.no_grad():
        scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 448.0
        r = (x / scale).to(torch.float8_e4m3fn).float() * scale - x
    return x + r


def _linear(x, w, fp8):
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return x @ w.t()


def logits(config: dict, params: dict, tokens, prompt_len: int, positions,
           kv_storage: str = "bf16", fp8: bool = False):
    """Float32 logits [len(positions), vocab] that follow ``positions`` of
    the sequence ``tokens`` [T] (prompt_len prompt tokens, then the served
    ones). ``params`` as ``benchmark/weights.py`` makes them. ``fp8``
    rounds both operands of every projection to FP8-e4m3 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    heads = config["num_attention_heads"]
    d = config.get("head_dim") or config["hidden_size"] // heads
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    window = config.get("sliding_window")
    if not config.get("use_sliding_window", True):
        window = None
    t = tokens.shape[0]
    x = params["embed"][tokens].float()
    with torch.no_grad():
        for layer in params["layers"]:
            def proj(name, h):
                y = _linear(h, layer["w" + name].float(), fp8)
                if "b" + name in layer:
                    y = y + layer["b" + name].float()
                return y.view(t, -1, d).transpose(0, 1)    # [H, T, D]

            h = _rms(x, layer["attn_norm"], eps)
            q = _rope(proj("q", h), theta)
            k = _rope(proj("k", h), theta)
            v = proj("v", h)
            o = torch.empty_like(q)
            o[:, :prompt_len] = _attend(q, k, v, range(0, prompt_len),
                                        window)
            if prompt_len < t:
                o[:, prompt_len:] = _attend(q, stored(k, kv_storage),
                                            stored(v, kv_storage),
                                            range(prompt_len, t), window)
            x = x + _linear(o.transpose(0, 1).reshape(t, -1),
                            layer["wo"].float(), fp8)
            h = _rms(x, layer["mlp_norm"], eps)
            g = _linear(h, layer["w_gate"].float(), fp8)
            u = _linear(h, layer["w_up"].float(), fp8)
            x = x + _linear(torch.nn.functional.silu(g) * u,
                            layer["w_down"].float(), fp8)
        head = params.get("lm_head", params["embed"])
        h = _rms(x[positions], params["final_norm"], eps)
        return _linear(h, head.float(), fp8)


# ---------------------------------------------------------------------------
# Training: the causal-LM loss, its gradients, clipping and AdamW
# ---------------------------------------------------------------------------
#
# The same blocks, differentiated by autograd one block at a time: the
# forward keeps only each block's input, and the backward runs each block
# again under autograd. Attention is computed in query blocks, forward and
# backward, so no T x T matrix is held. The optimizer is the configured
# one: the global gradient norm clipped to ``grad_clip``, then AdamW
# (bias-corrected moments, decoupled weight decay on every parameter),
# with the learning rate of a linear warmup from 0 and a cosine decay to a
# tenth of the peak, read at the step count before the update. The
# parameters and both moments are stored in each parameter's own type
# (bf16 for the matrices, as the configuration trains them): every update
# is computed in float32 and rounded to that type once.
#
# ``fp8`` rounds both operands of every projection to FP8-e4m3, as in
# serving: the control of the check.


class _Attention(torch.autograd.Function):
    """Causal (windowed) GQA attention over [H, T, D] in query blocks."""

    @staticmethod
    def forward(ctx, q, k, v, window, block):
        h, t, d = q.shape
        group = h // k.shape[0]
        o = torch.empty_like(q)
        lse = torch.empty((h, t), device=q.device)
        scale = d ** -0.5
        for s in range(0, t, block):
            e = min(s + block, t)
            lo = 0 if window is None else max(0, s - window + 1)
            sc = torch.matmul(q[:, s:e], k[:, lo:e].repeat_interleave(
                group, 0).transpose(1, 2)) * scale
            sc = sc.masked_fill(~_keep(s, e, lo, window, q.device),
                                float("-inf"))
            lse[:, s:e] = torch.logsumexp(sc, -1)
            o[:, s:e] = torch.matmul(torch.exp(sc - lse[:, s:e, None]),
                                     v[:, lo:e].repeat_interleave(group, 0))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.block = window, block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        window, block = ctx.window, ctx.block
        h, t, d = q.shape
        hkv = k.shape[0]
        group = h // hkv
        scale = d ** -0.5
        dq = torch.zeros_like(q)
        dk = torch.zeros((h, t, d), device=q.device)
        dv = torch.zeros((h, t, d), device=q.device)
        delta = (do * o).sum(-1)
        for s in range(0, t, block):
            e = min(s + block, t)
            lo = 0 if window is None else max(0, s - window + 1)
            kk = k[:, lo:e].repeat_interleave(group, 0)
            vv = v[:, lo:e].repeat_interleave(group, 0)
            sc = torch.matmul(q[:, s:e], kk.transpose(1, 2)) * scale
            sc = sc.masked_fill(~_keep(s, e, lo, window, q.device),
                                float("-inf"))
            p = torch.exp(sc - lse[:, s:e, None])
            dv[:, lo:e] += torch.matmul(p.transpose(1, 2), do[:, s:e])
            dp = torch.matmul(do[:, s:e], vv.transpose(1, 2))
            ds = p * (dp - delta[:, s:e, None]) * scale
            dq[:, s:e] = torch.matmul(ds, kk)
            dk[:, lo:e] += torch.matmul(ds.transpose(1, 2), q[:, s:e])
        fold = lambda x: x.view(hkv, group, t, d).sum(1)  # noqa: E731
        return dq, fold(dk), fold(dv), None, None


def _keep(s, e, lo, window, device):
    i = torch.arange(s, e, device=device)[:, None]
    j = torch.arange(lo, e, device=device)[None, :]
    keep = j <= i
    if window is not None:
        keep &= j > i - window
    return keep


def _block(layer, x, c, fp8):
    """One block over x [T, dim] (autograd through it)."""
    t = x.shape[0]
    heads, d = c["heads"], c["d"]

    def proj(name, h):
        y = _linear(h, layer["w" + name], fp8)
        if "b" + name in layer:
            y = y + layer["b" + name]
        return y.view(t, -1, d).transpose(0, 1)

    h = _rms(x, layer["attn_norm"], c["eps"])
    q = _rope(proj("q", h), c["theta"])
    k = _rope(proj("k", h), c["theta"])
    v = proj("v", h)
    o = _Attention.apply(q, k, v, c["window"], 512)
    x = x + _linear(o.transpose(0, 1).reshape(t, heads * d), layer["wo"],
                    fp8)
    h = _rms(x, layer["mlp_norm"], c["eps"])
    g = _linear(h, layer["w_gate"], fp8)
    u = _linear(h, layer["w_up"], fp8)
    return x + _linear(torch.nn.functional.silu(g) * u, layer["w_down"], fp8)


def _head_loss(p, x, targets, c, fp8):
    h = _rms(x, p["final_norm"], c["eps"])
    logits = _linear(h, p["lm_head"], fp8)
    return torch.nn.functional.cross_entropy(logits, targets)


def loss_and_grads(config, p, tokens, fp8=False):
    """Loss of one sequence tokens [T + 1] under float32 parameters ``p``
    (the weights' names, as ``benchmark/weights.py`` makes them; an output
    head of its own) and the gradients, by name."""
    heads = config["num_attention_heads"]
    window = config.get("sliding_window")
    if not config.get("use_sliding_window", True):
        window = None
    c = {"heads": heads,
         "d": config.get("head_dim") or config["hidden_size"] // heads,
         "eps": config["rms_norm_eps"], "theta": config["rope_theta"],
         "window": window}
    inputs, targets = tokens[:-1], tokens[1:]
    with torch.no_grad():
        xs = [p["embed"][inputs]]
        for layer in p["layers"]:
            xs.append(_block(layer, xs[-1], c, fp8))
    grads = {}
    head = {n: p[n].requires_grad_() for n in ("final_norm", "lm_head")}
    x = xs[-1].requires_grad_()
    loss = _head_loss(p, x, targets, c, fp8)
    loss.backward()
    for n, t in head.items():
        grads[n] = t.grad
        t.grad = None
        t.requires_grad_(False)
    dx = x.grad
    for i in range(len(p["layers"]) - 1, -1, -1):
        layer = {n: t.requires_grad_() for n, t in p["layers"][i].items()}
        x = xs[i].requires_grad_()
        _block(layer, x, c, fp8).backward(dx)
        dx = x.grad
        for n, t in layer.items():
            grads[f"layers.{i}.{n}"] = t.grad
            t.grad = None
            t.requires_grad_(False)
        xs[i + 1] = None
    grads["embed"] = torch.zeros_like(p["embed"]).index_add_(0, inputs, dx)
    return float(loss.detach()), grads


def flat(p):
    """Name → tensor, with the layers' entries as ``layers.<i>.<name>``."""
    out = {n: t for n, t in p.items() if n != "layers"}
    for i, layer in enumerate(p["layers"]):
        out.update({f"layers.{i}.{n}": t for n, t in layer.items()})
    return out


def learning_rate(opt, count):
    peak, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if count < warm:
        return peak * count / warm
    t = min(count - warm, total - warm)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))
    return peak * (0.9 * cosine + 0.1)


def train(config, p, batches, opt, storage, fp8=False):
    """Steps of the configured AdamW over ``batches`` from float32
    parameters ``p`` (updated in place, each rounded to its type in
    ``storage`` by name). Returns the losses and, by name, the first
    step's clipped gradient norms; the change of ``p`` is the caller's to
    read."""
    named = flat(p)
    m = {n: torch.zeros_like(t) for n, t in named.items()}
    v = {n: torch.zeros_like(t) for n, t in named.items()}
    losses, first = [], None
    for step, tokens in enumerate(batches):
        loss, grads = loss_and_grads(config, p, tokens, fp8)
        losses.append(loss)
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        clip = 1.0 if norm < opt["grad_clip"] else opt["grad_clip"] / norm
        lr = learning_rate(opt, step)
        b1, b2 = opt["b1"], opt["b2"]
        if first is None:
            first = {n: float(g.norm()) * clip for n, g in grads.items()}
        with torch.no_grad():
            for n, t in named.items():
                g = grads.pop(n) * clip
                keep = storage[n]
                m[n] = (b1 * m[n] + (1 - b1) * g).to(keep).float()
                v[n] = (b2 * v[n] + (1 - b2) * g * g).to(keep).float()
                u = (m[n] / (1 - b1 ** (step + 1))) / (
                    torch.sqrt(v[n] / (1 - b2 ** (step + 1))) + 1e-8)
                t.copy_((t - lr * (u + opt["weight_decay"] * t)).to(keep))
    return losses, first
