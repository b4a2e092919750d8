"""Token-stream data loading for training.

The port's own copy of ``mfa_tpu/utils/data.py`` (numpy only): a flat
token stream chunked into fixed-length causal-LM batches, shuffled per
epoch. For the same stream and seed its batches equal ``mfa_tpu``'s.
"""

from __future__ import annotations

import numpy as np


class TokenDataset:
    """Fixed-length causal-LM batches over a flat token stream.

    tokens: 1-D int array (numpy or np.memmap — pass a memmap for corpora
    larger than RAM; batches are materialized per epoch step).
    """

    def __init__(self, tokens, seq_len: int, batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        self.tokens = np.asarray(tokens) if not isinstance(
            tokens, np.memmap) else tokens
        if self.tokens.ndim != 1:
            raise ValueError("tokens must be a flat 1-D stream")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        # +1: each sample is seq_len+1 tokens (inputs + shifted targets).
        self.num_samples = (len(self.tokens) - 1) // seq_len
        if self.num_samples < batch_size and drop_last:
            raise ValueError(
                f"stream too short: {self.num_samples} samples < batch "
                f"{batch_size}")
        self.num_batches = self.num_samples // batch_size

    def epoch(self, epoch_idx: int = 0):
        """Yields [batch, seq_len+1] int32 arrays, shuffled per epoch."""
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = rng.permutation(self.num_samples)
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = np.stack([
                self.tokens[i * self.seq_len: i * self.seq_len
                            + self.seq_len + 1]
                for i in idx
            ])
            yield batch.astype(np.int32)

    def __len__(self):
        return self.num_batches
