"""The per-layer readers and the window's tails on a synthetic tick log."""

import pytest

from benchmark import arith, core
from benchmark.drivers import paged_serving as ps
from benchmark.tests import tiny

SHAPE = arith.Shape.from_config(tiny.CONFIG)


def _tick(t0, t1, prefills=(), contexts=(10, 20), profiled=False):
    n = len(contexts)
    return {"t0": t0, "t1": t1, "in_window": True, "profiled": profiled,
            "prefills": list(prefills), "contexts": list(contexts),
            "stats": {"prefills": len(prefills), "decode_steps": 1,
                      "tokens": n + len(prefills)}}


def _rec(trace=None):
    ticks = [_tick(0.0, 0.1), _tick(0.1, 0.4, prefills=[(50, 64)]),
             _tick(0.4, 0.5), _tick(0.5, 0.6, profiled=True),
             _tick(0.6, 0.9, prefills=[(100, 128)], profiled=True)]
    reqs = [{"submit": 0.1, "admit": 0.1, "first": 0.4, "in_window": True},
            {"submit": 0.0, "admit": 0.1, "first": 0.4, "in_window": True},
            {"submit": 0.5, "admit": 0.6, "first": 0.9, "in_window": True},
            {"submit": -1.0, "admit": -1.0, "first": -0.5,
             "in_window": False}]
    return {"shape": SHAPE, "cell": tiny.CELL, "kv_bytes": 1,
            "kv_scaled": True, "ticks": ticks, "t0": 0.0, "t1": 0.9,
            "host_end": 0.5, "requests": reqs, "trace": trace,
            "config": tiny.CONFIG}


def _read(name, rec):
    return core.reader(name)(rec)


def test_host_readers_use_the_ticks_before_the_profiler():
    rec = _rec()
    assert _read("decode_batch_mean.decode", rec) == 2.0
    assert _read("decode_tick_ms.decode", rec) == pytest.approx(100.0)
    # One admitting tick of 300 ms less a 100 ms decode, over 50 tokens.
    assert _read("prefill_ms_per_ktok.prefill", rec) == pytest.approx(
        200.0 / 0.05)
    assert _read("queue_wait_ms.prefill", rec) == pytest.approx(50.0)
    flops = (arith.prefill_flops(SHAPE, 50)
             + 3 * (arith.decode_flops(SHAPE, 10)
                    + arith.decode_flops(SHAPE, 20)))
    assert _read("serve_mfu.decode", rec) == pytest.approx(
        100 * flops / (0.5 * arith.BF16_FLOPS))
    for name in ("k6_roofline.decode", "k1_roofline.prefill",
                 "device_idle_share.decode"):
        assert _read(name, rec) is None


def test_device_readers_use_the_profiled_ticks():
    tr = {"busy_s": 0.3, "window_s": 0.4,
          "groups": {"paged_decode": 1e-3, "flash_fwd": 1e-3},
          "kernels": {}, "idle_by_span": {}}
    rec = _rec(tr)
    assert _read("device_idle_share.prefill", rec) == pytest.approx(25.0)
    k6 = sum(arith.least_seconds(*arith.k6_launch(SHAPE, [10, 20], 1, True))
             for _ in range(2)) * SHAPE.layers
    assert _read("k6_roofline.decode", rec) == pytest.approx(100 * k6 / 1e-3)
    k1 = arith.least_seconds(*arith.k1_launch(SHAPE, 100)) * SHAPE.layers
    assert _read("k1_roofline.prefill", rec) == pytest.approx(100 * k1 / 1e-3)


class _R:
    def __init__(self, submit, times, in_window=True):
        self.submit, self.times, self.in_window = submit, times, in_window


class _L:
    def __init__(self, ticks, reqs):
        self.ticks = ticks
        self.by_id = dict(enumerate(reqs))


def test_tails_and_gaps_of_the_window():
    ticks = [dict(_tick(0, 1), stats={"tokens": 3}),
             dict(_tick(1, 2), stats={"tokens": 5}),
             dict(_tick(2, 3), in_window=False, stats={"tokens": 9})]
    reqs = [_R(0.0, [1.0, 1.0, 2.0]),        # admitted in the first tick
            _R(-5.0, [-1.0, 1.0, 2.0], in_window=False),
            _R(2.0, [3.5])]                  # first token after the window
    e2e = ps._served(_L(ticks, reqs), [r for r in reqs if r.in_window],
                     0.0, 2.0)
    assert e2e["serve_tokens_per_s"] == pytest.approx(8 / 2.0)
    # TTFT of the in-window requests, the late one included: 1.0 and 1.5.
    assert e2e["ttft_p95_ms"] == pytest.approx(1500.0)
    # Gaps inside the window: 0, 1 (first request), 1 (second).
    assert e2e["itl_p95_ms"] == pytest.approx(1000.0)
