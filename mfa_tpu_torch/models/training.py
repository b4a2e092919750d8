"""Training: loss, AdamW with a warmup-cosine schedule, train step.

Port of ``mfa_tpu/models/training.py``. The forward runs through the flash
kernel K1 and the backward through K3 and K4 (``ops/attention.py``). The
optimizer reproduces ``mfa_tpu``'s optax chain
``clip_by_global_norm(grad_clip)`` then ``adamw(schedule)`` rather than
``torch.optim.AdamW``, whose defaults differ:

- the learning rate is read at the step count *before* the update, so
  the first step's rate is 0 when ``warmup_steps >= 1``;
- ``total_steps`` (optax's ``decay_steps``) counts the warmup;
- weight decay applies to every parameter, norms and embeddings included;
- clipping comes before Adam, and the moments live in the parameter dtype;
- the update is ``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.

Unlike the functional JAX step, :func:`train_step` updates the model's
parameters and the moments in place and leaves the raw (unclipped)
gradients in each parameter's ``.grad``.

Data and tensor parallelism (``mfa_tpu`` jits the step over a sharded
mesh and XLA inserts the reductions): ``dp_group`` averages the loss and
the gradients over the data-parallel ranks; the tensor-parallel group is
the model's own (a ``Llama`` built from ``parallel/sharding.py`` knows
it), so the forward's collectives and the clip cannot disagree. The
clip's global norm sums the squares of the tp-sharded parameters over
tp and counts each replicated parameter once.

:func:`train_step` records a ``train_step`` span into
``utils/tracing.py``'s ``metrics`` with the children ``forward`` (model
and loss), ``backward``, ``clip`` (the global norm) and ``optimizer``
(AdamW); the last two are also timed on the card while a profiler
records.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

import torch.distributed as dist

from mfa_tpu_torch.models.llama import Llama
from mfa_tpu_torch.parallel import collectives, sharding
from mfa_tpu_torch.utils.tracing import metrics


def cross_entropy_loss(logits, targets, ignore_index: int = -100):
    """Mean token NLL over the targets that are not ``ignore_index``;
    logits [B, T, V] (taken in fp32). With every target ignored the loss
    is 0, not NaN."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.where(targets == ignore_index, 0, targets).long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    mask = (targets != ignore_index).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine to ``end_value``
    at ``decay_steps`` (which counts the warmup), constant after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


# optax.adamw's default epsilon (mfa_tpu does not set it).
_EPS = 1e-8


@dataclass(frozen=True)
class AdamW:
    """The optimizer's settings (the state lives in :class:`TrainState`)."""

    schedule: Callable[[int], float]
    weight_decay: float
    b1: float
    b2: float
    grad_clip: float


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> AdamW:
    """AdamW + warmup-cosine schedule (to ``lr / 10``) + global-norm
    clipping, the settings of ``mfa_tpu``'s ``make_optimizer``."""
    schedule = warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
                                            total_steps, end_value=lr * 0.1)
    return AdamW(schedule=schedule, weight_decay=weight_decay, b1=b1, b2=b2,
                 grad_clip=grad_clip)


@dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer, the
    Adam moments in the parameters' dtype, and the step count."""

    model: Llama
    optimizer: AdamW
    params: list = field(repr=False)
    mu: list = field(repr=False)
    nu: list = field(repr=False)
    step: int = 0


def create_train_state(model: Llama, optimizer: AdamW) -> TrainState:
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters: build it "
                         "with trainable=True")
    return TrainState(model=model, optimizer=optimizer, params=params,
                      mu=[torch.zeros_like(p) for p in params],
                      nu=[torch.zeros_like(p) for p in params])


def loss_and_grads(model: Llama, tokens, *, dp_group=None):
    """Causal-LM loss of tokens [B, T+1] (inputs tokens[:, :-1], targets
    tokens[:, 1:]); leaves the gradients in each parameter's ``.grad``.
    With ``dp_group`` the loss and the gradients are the mean over the
    data-parallel ranks' equal batches."""
    with metrics.span("forward"):
        for p in model.parameters():
            p.grad = None
        loss = cross_entropy_loss(model(tokens[:, :-1]), tokens[:, 1:])
    with metrics.span("backward"):
        loss.backward()
        loss = loss.detach()
        if dp_group is not None:
            n = dist.get_world_size(dp_group)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad = collectives.all_reduce(p.grad, dp_group) / n
            loss = collectives.all_reduce(loss, dp_group) / n
    return loss


def _global_norm(tensors, sharded=None, tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, accumulated in fp32.
    Under ``tp_group`` the squares of the ``sharded`` tensors (flags) are
    summed over tp; the replicated ones count once."""
    squares = [t.float().square().sum() for t in tensors]
    if tp_group is None:
        return torch.sqrt(sum(squares))
    local = sum(s for s, shard in zip(squares, sharded) if shard)
    rep = sum(s for s, shard in zip(squares, sharded) if not shard)
    return torch.sqrt(rep + collectives.all_reduce(
        torch.as_tensor(local, dtype=torch.float32,
                        device=squares[0].device), tp_group))


@torch.no_grad()
def _apply_adamw(state: TrainState, grads, gnorm):
    opt = state.optimizer
    lr = opt.schedule(state.step)
    count = state.step + 1
    bc1, bc2 = 1.0 - opt.b1 ** count, 1.0 - opt.b2 ** count
    clip = gnorm < opt.grad_clip
    for p, g, mu, nu in zip(state.params, grads, state.mu, state.nu):
        g = torch.where(clip, g, (g / gnorm.to(g.dtype)) * opt.grad_clip)
        mu.copy_((1 - opt.b1) * g + opt.b1 * mu)
        nu.copy_((1 - opt.b2) * (g * g) + opt.b2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
        u = u + opt.weight_decay * p
        p.copy_(p + (-lr) * u)


def train_step(state: TrainState, tokens, *, dp_group=None) -> dict:
    """One causal-LM step on tokens [B, T+1], in place. Returns
    {"loss", "grad_norm"} as 0-dim tensors on the model's device (the
    norm of the raw gradients). ``dp_group``: this rank's tokens are its
    share of the batch (see :func:`loss_and_grads`); tp is the model's."""
    model = state.model
    with metrics.span("train_step"):
        loss = loss_and_grads(model, tokens, dp_group=dp_group)
        with metrics.span("clip", device=True):
            grads = [p.grad for p in state.params]
            names = {id(p): n for n, p in model.named_parameters()}
            sharded = [sharding.tp_dim(names[id(p)]) is not None
                       for p in state.params]
            gnorm = _global_norm(grads, sharded, model.tp_group)
        with metrics.span("optimizer", device=True):
            _apply_adamw(state, grads, gnorm)
        state.step += 1
    return {"loss": loss, "grad_norm": gnorm}
