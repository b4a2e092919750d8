"""Tensor and sequence parallelism over ``torch.distributed``."""
