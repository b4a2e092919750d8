"""Closed-loop traffic from a cell's parameters and a seed.

Each of ``clients`` users waits for its answer and sends its next request
when the last one completes. Requests come in rounds: round k is every
client's k-th request. The sizes of a round are fixed by the cell: the C
midpoints of the log-uniform range's C equal-probability strata (C the
number of clients), for the prompt and for the output alike. The seed only
deals them out, by one permutation per round and per size, and draws the
prompt tokens, uniform over the vocabulary. So every seed runs the same
set of sizes in another order.

Round 0 stands for requests already under way when the window opens: its
output lengths are cut to a residual share (stratified the same way) of
the drawn length, so that the first completions spread over the window
instead of arriving together.
"""

from __future__ import annotations

import numpy as np


def strata(lo: int, hi: int, n: int) -> list[int]:
    """The midpoints of n equal-probability strata of log-uniform[lo, hi]."""
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


class ClosedLoop:
    """The requests of a cell's closed loop: ``request(client, round)``
    gives (prompt tokens, output tokens), the same for the same seed."""

    def __init__(self, cell: dict, seed: int, vocab: int):
        self.clients = cell["clients"]
        self.seed = int(seed)
        self.vocab = vocab
        self.prompt_sizes = strata(*cell["prompt_tokens"], self.clients)
        self.output_sizes = strata(*cell["output_tokens"], self.clients)
        self.residual = [(i + 0.5) / self.clients
                         for i in range(self.clients)]

    def _rng(self, *stream) -> np.random.Generator:
        return np.random.default_rng([self.seed, *stream])

    def _dealt(self, sizes, round_: int, which: int, client: int):
        perm = self._rng(1, round_, which).permutation(len(sizes))
        return sizes[perm[client]]

    def request(self, client: int, round_: int) -> tuple[list, int]:
        t = self._dealt(self.prompt_sizes, round_, 0, client)
        n = self._dealt(self.output_sizes, round_, 1, client)
        if round_ == 0:
            n = max(2, int(round(n * self._dealt(self.residual, 0, 2,
                                                 client))))
        prompt = self._rng(2, client, round_).integers(0, self.vocab, t)
        return prompt.tolist(), n

    def warm_prompt(self, length: int) -> list:
        """A prompt of ``length`` tokens for warming one prefill shape."""
        return self._rng(3, length).integers(0, self.vocab, length).tolist()

    def buckets_used(self, buckets) -> list[int]:
        """The prompt buckets this traffic's sizes fall into, ascending."""
        return sorted({next(b for b in buckets if t <= b)
                       for t in self.prompt_sizes})
