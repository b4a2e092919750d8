"""Load ``mfa_tpu``'s Llama parameters into the port's model.

The caller converts ``mfa_tpu``'s parameter pytree to numpy arrays first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX. JAX
stores projections as [d_in, d_out]; they are transposed to the
[d_out, d_in] that ``nn.Linear`` uses. Names are kept. bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) are carried over bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from mfa_tpu_torch.models.llama import Llama, LlamaConfig

_TRANSPOSED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head")


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)            # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: dict, cfg: LlamaConfig, device="cuda",
                      trainable: bool = False) -> Llama:
    """``mfa_tpu`` parameter tree of numpy arrays → :class:`Llama` on
    ``device`` (parameters require grad when ``trainable``). Quantized
    weights are not taken (bf16/fp32 only)."""
    def conv(name, a):
        if not isinstance(a, np.ndarray) and not hasattr(a, "__array__"):
            raise TypeError(f"{name}: expected an array, got {type(a)}")
        t = _tensor(a)
        return t.t().contiguous() if name in _TRANSPOSED else t

    params = {name: conv(name, a) for name, a in tree.items()
              if name != "layers"}
    params["layers"] = [{name: conv(name, a) for name, a in layer.items()}
                        for layer in tree["layers"]]
    return Llama(cfg, params, device=device, trainable=trainable)
