"""Numerical-sanity guards for training and serving loops.

Port of ``mfa_tpu/utils/sanity.py`` over named tensors instead of
pytrees: an ``nn.Module`` (its named parameters) or a mapping of names to
tensors, such as a model's gradients.
"""

from __future__ import annotations

import torch
from torch import nn


class NonFiniteError(RuntimeError):
    pass


def _named(tensors):
    if isinstance(tensors, nn.Module):
        return list(tensors.named_parameters())
    return list(tensors.items())


def nonfinite_leaves(tensors) -> list:
    """Names of the floating tensors that hold NaN or Inf (synchronizes
    with the device; use sparingly)."""
    return [name for name, t in _named(tensors)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def check_finite(tensors, what: str = "tensors"):
    bad = nonfinite_leaves(tensors)
    if bad:
        raise NonFiniteError(
            f"non-finite values in {what}: {', '.join(bad[:10])}"
            + (f" (+{len(bad) - 10} more)" if len(bad) > 10 else ""))


def finite_or_skip(grads: dict):
    """(ok, grads'): ``ok`` a 0-dim bool tensor, ``grads'`` the gradients
    zeroed everywhere when any is non-finite, the 'skip a bad step' recipe
    (no host synchronization)."""
    flags = [torch.isfinite(g).all() for g in grads.values()]
    ok = torch.stack(flags).all() if flags else torch.tensor(True)
    return ok, {n: torch.where(ok, g, torch.zeros_like(g))
                for n, g in grads.items()}
