"""Token sampling: greedy, temperature, top-k, top-p.

Port of ``mfa_tpu/serving/sampling.py``; random draws come from a
``torch.Generator`` on the logits' device.
"""

from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           *, temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits [B, vocab] → tokens [B] int32.

    temperature 0 → greedy. top_k > 0 keeps the k best; top_p < 1 keeps
    the smallest nucleus whose probability mass reaches p (after top_k).
    """
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling with temperature needs a torch.Generator")
    scaled = logits.float() / temperature
    neg_inf = torch.full_like(scaled, float("-inf"))
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled, neg_inf)
    if top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Ranks whose preceding mass already reaches p are cut.
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled >= cutoff, scaled, neg_inf)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
