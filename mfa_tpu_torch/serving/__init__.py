"""KV cache, sampling and the continuous-batching scheduler."""
