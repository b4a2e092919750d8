"""The readers of the program's own spans (``program_spans.py`` and the
eight metrics that use it) on a synthetic span log, on a log some of
whose spans fell out of the ring, on a program without the recorder,
and on tiny CPU runs of a serving and a training cell."""

import contextlib
import sys

import pytest
import torch

from benchmark import core
from benchmark.tests import tiny
from mfa_tpu_torch.utils import tracing

SERVING = ("decode_dispatch_ms.decode", "decode_sync_ms.decode",
           "kv_page_fill.decode", "admit_wait_ms.prefill",
           "prefill_span_ms_per_ktok.prefill", "prefill_pad_share.prefill",
           "first_token_hold_ms.prefill")
TRAIN = "optimizer_ms.train"
REC = {"t0": 10.0, "host_end": 20.0, "t1": 30.0}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Event:
    """A stand-in CUDA event on the fake clock."""

    clock = None

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = self.clock()

    def synchronize(self):
        pass

    def elapsed_time(self, later):
        return 1e3 * (later.t - self.t)


class _Log:
    """Spans recorded into ``m`` at chosen times on the fake clock."""

    def __init__(self, m, clock):
        self.m, self.clock = m, clock

    @contextlib.contextmanager
    def span(self, name, a, b, **kw):
        self.clock.t = a
        with self.m.span(name, **kw):
            yield
            self.clock.t = b

    def event(self, name, t, **kw):
        self.clock.t = t
        self.m.event(name, **kw)

    def tick(self, a, b, parts, prefills=(), **counts):
        """A tick over [a, b]; ``parts`` the (start, end) of retire,
        admit, prepare, decode, sync and emit; ``prefills`` (req, start,
        end, prompt, bucket) inside admit."""
        names = ("retire", "admit", "prepare", "decode", "sync", "emit")
        with self.span("tick", a, b, **counts):
            for name, (s, e) in zip(names, parts):
                with self.span(name, s, e):
                    if name == "admit":
                        for req, ps, pe, prompt, bucket in prefills:
                            with self.span("prefill", ps, pe, req=req,
                                           prompt=prompt, bucket=bucket):
                                pass


def _parts(a, decode, sync):
    """Six consecutive children from ``a``: the decode and sync spans of
    the given lengths, the others 0.01 s."""
    out, t = [], a
    for d in (0.01, 0.01, 0.01, decode, sync, 0.01):
        out.append((t, t + d))
        t += d
    return out


def _serving_log(log):
    for i in range(3):                      # before the window
        with log.span("old", 1.0 + i, 1.5 + i):
            pass
    log.tick(5.0, 6.0, _parts(5.0, 0.5, 0.1), pages=9, tokens=9,
             page_size=512)
    log.event("submit", 9.0, req=1)
    log.event("submit", 10.5, req=2)
    log.event("submit", 11.0, req=3)
    # Tick A admits req 2 (submitted in the window) and req 1 (before).
    log.tick(11.0, 13.0, [(11.0, 11.1), (11.1, 12.2), (12.2, 12.3),
                          (12.3, 12.6), (12.6, 12.9), (12.9, 12.95)],
             prefills=[(2, 11.2, 11.7, 300, 512),
                       (1, 11.7, 12.1, 1000, 1024)],
             pages=3, tokens=1000, page_size=512)
    log.tick(13.0, 14.0, _parts(13.0, 0.4, 0.4), pages=4, tokens=1500,
             page_size=512)
    log.tick(15.0, 16.0, _parts(15.0, 0.2, 0.6), pages=4, tokens=1600,
             page_size=512)
    log.tick(16.0, 17.5, _parts(16.0, 0.1, 0.1),
             prefills=[(3, 16.03, 16.83, 700, 1024)], pages=5,
             tokens=1700, page_size=512)
    log.event("submit", 19.5, req=4)
    # Profiled ticks, after the host part.
    log.tick(21.0, 22.0, _parts(21.0, 0.1, 0.1),
             prefills=[(4, 21.05, 21.5, 100, 512)], pages=6, tokens=1800,
             page_size=512)
    log.tick(22.0, 23.0, _parts(22.0, 0.9, 0.9), pages=6, tokens=1900,
             page_size=512)


WANT = {
    # Plain ticks of the host part: decode 0.4 and 0.2 s, sync 0.4, 0.6.
    "decode_dispatch_ms.decode": 300.0,
    "decode_sync_ms.decode": 500.0,
    # (1000 + 1500 + 1600 + 1700) tokens over (3 + 4 + 4 + 5) pages.
    "kv_page_fill.decode": 100.0 * 5800 / (16 * 512),
    # Requests 2 and 3: waits 11.2 - 10.5 and 16.03 - 11.0.
    "admit_wait_ms.prefill": 1e3 * (0.7 + 5.03) / 2,
    # Their ticks' ends less their prefills' ends: 13 - 11.7, 17.5 - 16.83.
    "first_token_hold_ms.prefill": 1e3 * (1.3 + 0.67) / 2,
    # Prefills 1, 2 and 3: 1.7 s over 2000 tokens.
    "prefill_span_ms_per_ktok.prefill": 1e3 * 1.7 / 2.0,
    # Padding 212 + 24 + 324 of 512 + 1024 + 1024 bucket tokens.
    "prefill_pad_share.prefill": 100.0 * 560 / 2560,
}


def _record(monkeypatch, build, maxlen=None):
    """Run ``build(log)`` into a fresh recorder (holding ``maxlen`` spans;
    by default all of them) that the readers then read."""
    clock = _Clock()
    monkeypatch.setattr(tracing, "perf_counter", clock)
    monkeypatch.setattr(_Event, "clock", clock)
    probe = tracing.Metrics()
    build(_Log(probe, clock))
    monkeypatch.setattr(tracing, "RING", maxlen or len(probe.spans()))
    m = tracing.Metrics()
    monkeypatch.setattr(tracing, "metrics", m)
    build(_Log(m, clock))
    return m


def _read(name, rec):
    return core.reader(name)(rec)


def test_serving_readers_on_a_synthetic_log(monkeypatch):
    n = len(_record(monkeypatch, _serving_log).spans())
    # Two of the three spans before the window fall out of the ring.
    m = _record(monkeypatch, _serving_log, maxlen=n - 2)
    assert m.dropped == 2
    for name, want in WANT.items():
        assert _read(name, REC) == pytest.approx(want), name


def test_serving_readers_give_nothing_if_the_window_lost_spans(monkeypatch):
    n = len(_record(monkeypatch, _serving_log).spans())
    # The three old spans, the tick before the window (7 spans), the
    # submit before it and the window's first submit fall out.
    m = _record(monkeypatch, _serving_log, maxlen=n - 12)
    assert m.lost(REC["t0"])
    for name in WANT:
        assert _read(name, REC) is None, name


def test_serving_readers_give_nothing_outside_their_spans(monkeypatch):
    _record(monkeypatch, _serving_log)
    empty = {"t0": 40.0, "host_end": 50.0, "t1": 60.0}
    for name in WANT:
        assert _read(name, empty) is None, name


def _train_log(log):
    for a, clip, opt in ((10.0, 0.15, 0.2), (11.01, 0.05, 0.2),
                         (12.01, 0.1, 0.3)):
        with log.span("train_step", a, a + 0.9):
            with log.span("forward", a, a + 0.2):
                pass
            with log.span("backward", a + 0.2, a + 0.5):
                pass
            with log.span("clip", a + 0.5, a + 0.5 + clip, device=True):
                pass
            with log.span("optimizer", a + 0.5 + clip, a + 0.5 + clip + opt,
                          device=True):
                pass


TRAIN_REC = {"t0": 10.0, "host_end": 11.0, "t1": 13.0,
             "steps": [{"t0": 10.0, "t1": 11.0, "profiled": False},
                       {"t0": 11.0, "t1": 12.0, "profiled": True},
                       {"t0": 12.0, "t1": 13.0, "profiled": True}]}


def _as_if_profiled(monkeypatch):
    monkeypatch.setattr(tracing, "_profiling", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)


def test_optimizer_reader_on_a_synthetic_log(monkeypatch):
    _as_if_profiled(monkeypatch)
    _record(monkeypatch, _train_log)
    # The profiled steps' clip + optimizer: 0.25 and 0.4 s on the card.
    assert _read(TRAIN, TRAIN_REC) == pytest.approx(325.0)
    assert _read(TRAIN, dict(TRAIN_REC, steps=TRAIN_REC["steps"][:1])) is None


def test_optimizer_reader_needs_the_cards_events(monkeypatch):
    _record(monkeypatch, _train_log)          # no profiler: no events
    assert _read(TRAIN, TRAIN_REC) is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfa_tpu_torch.utils.tracing", None)
    for name in WANT:
        assert _read(name, REC) is None, name
    assert _read(TRAIN, TRAIN_REC) is None


def test_readers_read_a_tiny_traced_run():
    out = tiny.run(seconds=2.0, trace=True)
    assert out["correct"]
    for name in SERVING:
        assert out["metrics"][name]["value"] > 0, name
    fill = out["metrics"]["kv_page_fill.decode"]["value"]
    assert 0 < fill <= 100
    out = tiny.run(seconds=2.0, trace=True, name=tiny.TRAIN)
    assert out["correct"]
    # No CUDA events on the CPU.
    assert TRAIN not in out["metrics"]
    assert "train_mfu.train" in out["metrics"]
