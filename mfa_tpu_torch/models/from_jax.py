"""Load ``mfa_tpu``'s Llama parameters into the port's model.

The caller converts ``mfa_tpu``'s parameter pytree to numpy arrays first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX. JAX
stores projections as [d_in, d_out]; they are transposed to the
[d_out, d_in] that ``nn.Linear`` uses. Names are kept. bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) are carried over bit for bit.

Quantized projections (``mfa_tpu``'s ``QuantizedWeight``, which
``jax.tree.map(np.asarray, ...)`` keeps as an object with numpy ``.w``
and ``.scale`` and its ``.kind``) are read by duck typing and become the
port's ``kernels.quant.QuantizedWeight`` with the same bits: INT8
w [in, out] / scale [1, out] → [out, in] / [out]; INT4 half-split
packed [in/2, out] → [out, in/2], int8 bytes as layout "int4", uint8 as
"int4_biased".
"""

from __future__ import annotations

import numpy as np
import torch

from mfa_tpu_torch.kernels.quant import QuantizedWeight
from mfa_tpu_torch.models.llama import Llama, LlamaConfig

_TRANSPOSED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head")


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)            # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _quantized(name, q) -> QuantizedWeight:
    w = _tensor(q.w)
    scale = _tensor(q.scale).reshape(-1).float()
    if q.kind == "int8":
        layout = "int8"
    elif q.kind == "int4":
        layout = "int4_biased" if w.dtype == torch.uint8 else "int4"
    else:
        raise ValueError(f"{name}: unknown quantized kind {q.kind!r}")
    return QuantizedWeight(w.t().contiguous(), scale.contiguous(), layout)


def params_from_numpy(tree: dict, cfg: LlamaConfig, device="cuda",
                      trainable: bool = False) -> Llama:
    """``mfa_tpu`` parameter tree of numpy arrays (or quantized weights
    holding them) → :class:`Llama` on ``device`` (parameters require grad
    when ``trainable``; quantized weights cannot train)."""
    def conv(name, a):
        if all(hasattr(a, f) for f in ("w", "scale", "kind")):
            return _quantized(name, a)
        if not isinstance(a, np.ndarray) and not hasattr(a, "__array__"):
            raise TypeError(f"{name}: expected an array, got {type(a)}")
        t = _tensor(a)
        return t.t().contiguous() if name in _TRANSPOSED else t

    params = {name: conv(name, a) for name, a in tree.items()
              if name != "layers"}
    params["layers"] = [{name: conv(name, a) for name, a in layer.items()}
                        for layer in tree["layers"]]
    return Llama(cfg, params, device=device, trainable=trainable)
