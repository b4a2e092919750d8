"""One run of one cell: load what its names point at, run, report.

``BENCHMARK.json`` names a cell; the cell names its configuration and
traffic. Each lives in a file of its own, found by name:

- ``configs/<config>.json``: the model's published config.json fields,
  its ``source`` and the plain reference it is judged by
  (``references/<reference>.py``);
- ``cells/<cell>.json``: the deployment (slots, pages, KV storage,
  prompt buckets), the traffic's parameters, the driver that runs it
  (``drivers/<driver>.py``) and the limits of its checks;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(rec)``,
  which returns a number or None when the run has nothing to read.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mfa_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_cell(name: str, here: Path = HERE) -> dict:
    return load_json(here / "cells" / f"{name}.json")


def load_config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def reader(metric: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(spec: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, and those without a list (a per-layer
    one, where the cell reports the end-to-end metric it ``moves``)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def forbidden_modules(names=None) -> list[str]:
    """Of the loaded modules (or ``names``), the top-level names that are
    JAX's or the JAX package's, compared whole: ``mfa_tpu_torch`` is not
    ``mfa_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class RunContext:
    """What a driver is given: the cell, its configuration, the run's
    arguments and the device, with the device's clock and memory."""

    def __init__(self, *, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device, t_start: float):
        self.cell, self.config = cell, config
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.t_window = None            # set by the driver at the window

    def log(self, msg: str):
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {msg}",
              file=sys.stderr, flush=True)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_driver(name: str, *, seed: int, seconds: float, trace: bool,
               device, t_start: float, root: Path = ROOT,
               spec: dict | None = None, cell=None, config=None):
    """Run one cell's driver; returns (its context, its output)."""
    here = root / HERE.name
    spec = spec or benchmark_spec(root)
    w = workload(spec, name)
    cell = cell or load_cell(name, here)
    config = config or load_config(w["config"], here)
    ctx = RunContext(cell=cell, config=config, seed=seed, seconds=seconds,
                     trace=trace, device=device, t_start=t_start)
    driver = importlib.import_module("benchmark.drivers." + cell["driver"])
    return ctx, driver.run(ctx)


def run_cell(name: str, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT, spec: dict | None = None,
             cell=None, config=None) -> dict:
    """Run one cell of the benchmark at ``root``; returns the result
    line's fields, with the numbers compared under ``checks``."""
    here = root / HERE.name
    spec = spec or benchmark_spec(root)
    w = workload(spec, name)
    ctx, out = run_driver(name, seed=seed, seconds=seconds, trace=trace,
                          device=device, t_start=t_start, root=root,
                          spec=spec, cell=cell, config=config)
    config = ctx.config
    e2e = dict(out["e2e"], setup_s=ctx.t_window - t_start)
    metrics = {}
    if trace:
        rec = dict(out["rec"], config=config)
        for m in metrics_for(spec, name, "per_layer"):
            value = reader(m["name"], here)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_for(spec, name, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    checks = out["checks"]
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(ctx, w["chips"], out["memory_peak"])}
    tr = out["rec"].get("trace") if trace else None
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": _top(tr["groups"]),
            "idle_gaps": _top(tr["idle_by_span"])}
    result["checks"] = checks
    return result


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_info(ctx: RunContext, chips: int, memory_peak: int) -> dict:
    if ctx.device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(ctx.device),
                "count": chips, "memory_peak_bytes": memory_peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": memory_peak}

