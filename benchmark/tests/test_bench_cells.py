"""The benchmark is driven by data: a new cell, configuration or metric
is a new file and a new entry; and nothing a run imports is JAX's."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

from benchmark import core
from benchmark.tests import tiny

ROOT = core.ROOT
BENCH = core.HERE


def _digest(folder: Path) -> dict:
    return {p.relative_to(folder).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_spec_names_a_file_for_everything():
    spec = core.benchmark_spec()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert core.load_config(c["name"])["source"] == c["source"]
    for w in spec["workloads"]:
        cell = core.load_cell(w["name"])
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
        assert cell["limits"]
    for m in spec["per_layer"]:
        assert callable(core.reader(m["name"]))
    e2e = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        reported = {m["name"] for m in core.metrics_for(
            spec, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert reported <= e2e
        assert core.metrics_for(spec, w["name"], "per_layer")


def test_a_new_cell_config_and_metric_are_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    before = _digest(root / "benchmark")
    (root / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(tiny.CONFIG))
    (root / "benchmark" / "cells" / "tiny.chat.json").write_text(
        json.dumps(tiny.CELL))
    (root / "benchmark" / "metrics" / "tokens_per_tick.decode.py"
     ).write_text("def read(rec):\n"
                  "    t = [x for x in rec['ticks'] if x['in_window']]\n"
                  "    return sum(x['stats']['tokens'] for x in t) / len(t)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "CPU test"})
    spec["workloads"].append({"name": "tiny.chat", "config": "tiny",
                              "traffic": "chat", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        m.setdefault("workloads", []).append("tiny.chat")
    spec["per_layer"].append({"name": "tokens_per_tick.decode",
                              "unit": "tokens", "better": "higher",
                              "source": "program_counter",
                              "layer": "scheduler",
                              "moves": "serve_tokens_per_s",
                              "workloads": ["tiny.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(root / "benchmark")
    assert all(after[k] == v for k, v in before.items())
    t = time.perf_counter()
    out = core.run_cell("tiny.chat", seed=5, seconds=1.5, trace=True,
                        device="cpu", t_start=t, root=root)
    assert out["correct"]
    assert out["metrics"]["tokens_per_tick.decode"]["value"] > 0
    assert set(out["metrics"]) == {"tokens_per_tick.decode"}
    out = core.run_cell("tiny.chat", seed=5, seconds=1.5, trace=False,
                        device="cpu", t_start=t, root=root)
    assert set(out["metrics"]) == {"serve_tokens_per_s", "ttft_p95_ms",
                                   "itl_p95_ms", "setup_s"}


_RUN_TINY = """
import sys, json, time
sys.path.insert(0, {root!r})
from benchmark import core
from benchmark.tests import tiny
out = tiny.run(seconds=1.0)
print(json.dumps({{"correct": out["correct"],
                  "forbidden": core.forbidden_modules(),
                  "port": "mfa_tpu_torch" in sys.modules}}))
"""

_IMPORT_REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.references.llama_family, benchmark.correctness
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _python(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    out = json.loads(_python(_RUN_TINY))
    assert out == {"correct": True, "forbidden": [], "port": True}


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules(["mfa_tpu_torch.models.llama", "numpy",
                                   "jaxtyping", "flax_x"]) == []
    assert core.forbidden_modules(["mfa_tpu.ops", "jaxlib.xla_client",
                                   "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "mfa_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    names = set(ast.literal_eval(_python(_IMPORT_REFERENCE)))
    assert not names & {"mfa_tpu_torch", "mfa_tpu", "jax", "jaxlib", "flax"}
    for path in (BENCH / "references").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] in {"torch", "__future__", "math"}, m
