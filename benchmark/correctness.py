"""What decides ``correct`` for a served model.

Once the window has closed and the program is freed, a sample of the
requests the window finished, drawn from the seed and always holding the
longest, is run through the configuration's plain reference: once over
each prompt followed by its served tokens. For every served token the
reading is how far its reference logit lies below the reference's best
at that position. The numbers a cell compares (its ``limits``) are taken
from these gaps over the sample: the widest, the mean, or the share of
tokens that are not the reference's first choice. Greedy serving of a sound program reads near 0 (it differs only
where rounding reorders near ties); a token altered where it is produced,
or arithmetic in a lower precision, reads far higher.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from benchmark import weights

# A reading that fails any limit: nothing was served to judge.
NOTHING = 1e30


def sample_requests(done, n: int, seed: int) -> list:
    """Up to n of the finished (prompt, served tokens): the longest one
    and the rest drawn from the seed."""
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda i: (len(done[i][0]) + len(done[i][1]), -i))
    longest = order[-1]
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed), 4])
    picked = rng.choice(len(rest), size=min(n - 1, len(rest)),
                        replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(picked)]


def flat_params(params: dict) -> dict:
    """Name → tensor, the layers' entries as ``layers.<i>.<name>`` (the
    program's parameter names)."""
    out = {n: t for n, t in params.items() if n != "layers"}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{n}": t for n, t in layer.items()})
    return out


def reference(config: dict):
    return importlib.import_module(
        "benchmark.references." + config["reference"])


def reference_rows(ctx, shape, sample, kv_storage: str,
                   fp8: bool = False) -> list:
    """For each sampled request, the reference's float32 logits
    [served, vocab] at the positions its served tokens were drawn from
    (``fp8``: the control's, its projections' operands in FP8)."""
    ref = reference(ctx.config)
    params = weights.make_params(shape, ctx.seed, ctx.device)
    rows = []
    with torch.no_grad():
        for prompt, served in sample:
            if not served:
                rows.append(None)
                continue
            seq = torch.tensor(prompt + served[:-1], device=ctx.device)
            t = len(prompt)
            rows.append(ref.logits(ctx.config, params, seq, t,
                                   list(range(t - 1, t - 1 + len(served))),
                                   kv_storage, fp8=fp8))
    del params
    ctx.free()
    return rows


def gaps(rows, tokens) -> torch.Tensor:
    """How far each token's reference logit lies below the best."""
    idx = torch.as_tensor(tokens, device=rows.device)[:, None]
    return rows.max(-1).values - rows.gather(1, idx)[:, 0]


def readings(rows, tokens) -> dict:
    """Over every served token of the sample (``tokens``, one list a
    request): the widest gap, the mean gap and the share of tokens that
    are not the reference's first choice. NOTHING where the window
    finished no request or a sampled one served nothing."""
    if not tokens or any(r is None or not t for r, t in zip(rows, tokens)):
        return {k: NOTHING for k in ("widest_logit_gap", "mean_logit_gap",
                                     "flip_share")}
    g = torch.cat([gaps(r, t) for r, t in zip(rows, tokens)])
    return {"widest_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "flip_share": float((g > 0).float().mean())}
