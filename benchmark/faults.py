"""Faults planted underneath the timed path, for the checks' own tests
and for reading a fault on the card (``control.py --faults``).

- ``altered_token``: the paged scheduler's decode step hands back each
  sampled token plus one;
- ``half_batch``: the training loss is the mean over the first half of
  the positions only;
- ``state_unchanged``: the training step leaves the parameters and the
  optimizer's moments as they were.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def altered_token():
    from mfa_tpu_torch.serving import paged_scheduler
    sample = paged_scheduler.sample

    def altered(logits, *args, **kw):
        toks = sample(logits, *args, **kw)
        if logits.shape[0] > 1:              # the decode step's batch
            toks = (toks + 1) % logits.shape[-1]
        return toks

    return _patched(paged_scheduler, "sample", altered)


def half_batch():
    from mfa_tpu_torch.models import training
    loss = training.cross_entropy_loss

    def half(logits, targets, *args, **kw):
        t = logits.shape[1] // 2
        return loss(logits[:, :t], targets[:, :t], *args, **kw)

    return _patched(training, "cross_entropy_loss", half)


def state_unchanged():
    from mfa_tpu_torch.models import training
    return _patched(training, "_apply_adamw", lambda *a, **k: None)


FAULTS = {"altered_token": altered_token, "half_batch": half_batch,
          "state_unchanged": state_unchanged}
