"""mfa_tpu_torch — the PyTorch/CUDA port of ``mfa_tpu`` for NVIDIA Hopper.

Same layout and names as ``mfa_tpu``: ``ops/`` (descriptors, precision
policy, parameter tables, public attention and decode entry points),
``kernels/`` (hand-written CUDA kernels, each beside its plain PyTorch
version), ``models/`` (Llama), ``serving/`` (KV cache, sampling,
continuous-batching scheduler) and ``utils/``. CUDA sources live in
``csrc/`` and are compiled with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports neither ``jax`` nor ``mfa_tpu``.
"""
