"""End-to-end benchmark of mfa_tpu_torch on an NVIDIA H100.

Run from the repository root:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; each is a file of its own under this folder (``configs/``,
``cells/``, ``metrics/``), found by its name.
"""
