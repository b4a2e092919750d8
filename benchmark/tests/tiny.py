"""A CPU-sized configuration and cell for the benchmark's own tests."""

import copy

from benchmark import core

CONFIG = {"source": "a tiny Mistral-shaped decoder for CPU tests",
          "reference": "llama_family", "model_type": "mistral",
          "hidden_size": 128, "intermediate_size": 256,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
          "rope_theta": 10000.0, "sliding_window": 48,
          "tie_word_embeddings": False, "vocab_size": 256}

CELL = {"driver": "paged_serving", "clients": 4, "slots": 4,
        "prompt_tokens": [32, 100], "output_tokens": [4, 40],
        "kv_storage": "fp8_e4m3", "page_size": 128, "pages_per_slot": 2,
        "max_len": 256, "prompt_buckets": [64, 128], "trace_seconds": 1,
        "check_requests": 3, "limits": {"widest_logit_gap": 0.5}}

TRAIN_CELL = {"driver": "training", "seq_len": 40, "batch": 1,
              "optimizer": {"lr": 3e-4, "weight_decay": 0.1,
                            "warmup_steps": 1, "total_steps": 10000,
                            "b1": 0.9, "b2": 0.95, "grad_clip": 1.0},
              "trace_seconds": 1,
              "limits": {"loss_gap": 0.01, "first_grad_gap": 0.02,
                         "change_gap": 0.02}}

NAME = "tiny.chat"
TRAIN = "tiny.train"


def spec() -> dict:
    """BENCHMARK.json with the tiny cell added to every serving metric."""
    s = copy.deepcopy(core.benchmark_spec())
    for name in (NAME, TRAIN):
        s["workloads"].append({"name": name, "config": "tiny",
                               "traffic": name, "chips": 1,
                               "why": "CPU test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(
                TRAIN if m["name"].endswith("train") or
                m["name"].startswith("train") else NAME)
    return s


def run(seconds=2.0, trace=False, name=NAME, **over):
    import time
    cell = dict(TRAIN_CELL if name == TRAIN else CELL, **over)
    return core.run_cell(name, seed=2**33 + 7, seconds=seconds, trace=trace,
                         device="cpu", t_start=time.perf_counter(),
                         spec=spec(), cell=cell, config=CONFIG)
