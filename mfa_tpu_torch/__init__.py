"""mfa_tpu_torch — the PyTorch/CUDA port of ``mfa_tpu`` for NVIDIA Hopper.

Same layout and names as ``mfa_tpu``: ``ops/`` (descriptors, precision
policy, parameter tables, public attention and decode entry points),
``kernels/`` (hand-written CUDA kernels, each beside its plain PyTorch
version), ``models/`` (Llama), ``serving/`` (KV caches, contiguous and
paged; sampling; the continuous-batching and paged schedulers) and
``utils/``. CUDA sources live in ``csrc/`` and are compiled with ``nvcc``
at first use.

The names ``mfa_tpu`` gives at its top level are importable from here
too (``flash_attention``, ``mha``, ``decode_attention``,
``decode_attention_append``, ``paged_decode_attention``, ``gemm``,
``AttentionDescriptor``, ``GEMMDescriptor``); they load on first access
and build no kernel until called on a CUDA tensor.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports neither ``jax`` nor ``mfa_tpu``.
"""

_EXPORTS = {
    "flash_attention": "mfa_tpu_torch.ops.attention",
    "mha": "mfa_tpu_torch.ops.attention",
    "decode_attention": "mfa_tpu_torch.ops.decode",
    "decode_attention_append": "mfa_tpu_torch.ops.decode",
    "paged_decode_attention": "mfa_tpu_torch.ops.decode",
    "gemm": "mfa_tpu_torch.ops.gemm",
    "AttentionDescriptor": "mfa_tpu_torch.ops.descriptors",
    "GEMMDescriptor": "mfa_tpu_torch.ops.descriptors",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'mfa_tpu_torch' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(_EXPORTS[name]), name)
