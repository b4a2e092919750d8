"""The port's recorder (utils/tracing.py) and the spans the program
reports into it: PagedScheduler.step()'s tick and its six children,
each prefill with its request, and train_step's four parts; the ring's
bound, the profiler mirror, and mfa_tpu's snapshot() keys."""

import threading

import pytest
import torch

from mfa_tpu.utils import profiling as jax_profiling
from mfa_tpu_torch.models import llama, training
from mfa_tpu_torch.serving.paged_scheduler import PagedScheduler
from mfa_tpu_torch.serving.scheduler import Request, _bucket
from mfa_tpu_torch.utils import profiling, tracing
from mfa_tpu_torch.utils.tracing import Metrics, metrics

# (prompt length, new tokens): more requests than slots, two buckets.
SHAPES = [(3, 4), (11, 3), (2, 5), (9, 2), (7, 4)]
BUCKETS = (8, 16)
TICK = ["retire", "admit", "prepare", "decode", "sync", "emit"]


@pytest.fixture(autouse=True)
def clean():
    metrics.clear()
    yield
    metrics.clear()


@pytest.fixture(scope="module")
def model():
    gen = torch.Generator().manual_seed(0)
    return llama.Llama.init(llama.LlamaConfig.tiny(), generator=gen,
                            dtype=torch.float32, device="cpu")


def _sched(model, **kw):
    return PagedScheduler(model, num_slots=2, num_pages=8, max_len=256,
                          prompt_buckets=BUCKETS, page_size=128,
                          device="cpu", **kw)


def _submit(sched, shapes=SHAPES):
    reqs = [Request(prompt=list(range(1, n + 1)), max_new_tokens=k)
            for n, k in shapes]
    for r in reqs:
        sched.submit(r)
    return reqs


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def test_each_decoding_tick_holds_its_six_children_in_order(model):
    sched = _sched(model)
    _submit(sched)
    sched.run()
    spans = metrics.spans()
    kids = _children(spans)
    ticks = [s for s in spans if s.name == "tick"]
    decoding = [t for t in ticks
                if any(c.name == "decode" for c in kids.get(t, ()))]
    assert len(decoding) == sched.stats["decode_steps"] > 0
    for t in decoding:
        assert t.parent is None
        names = [c.name for c in kids[t]]
        assert names == TICK
        ends = [t.start] + [x for c in kids[t] for x in (c.start, c.end)]
        assert ends == sorted(ends) and ends[-1] <= t.end
    # A tick with nothing left to decode stops after admission.
    for t in ticks:
        if t not in decoding:
            assert [c.name for c in kids[t]] == TICK[:2]


def test_prefill_spans_match_the_admissions_and_their_submits(model):
    sched = _sched(model)
    reqs = _submit(sched)
    sched.run()
    spans = metrics.spans()
    submits = {s.req: s for s in spans if s.name == "submit"}
    prefills = [s for s in spans if s.name == "prefill"]
    assert len(prefills) == sched.stats["prefills"] == len(reqs)
    assert sorted(submits) == sorted(r.id for r in reqs)
    assert all(s.start == s.end for s in submits.values())
    by_id = {r.id: r for r in reqs}
    for p in prefills:
        n = len(by_id[p.req].prompt)
        assert p.counts == {"prompt": n, "bucket": _bucket(n, BUCKETS)}
        assert submits[p.req].counts == {}
        assert submits[p.req].start < p.start
        assert p.parent.name == "admit" and p.parent.parent.name == "tick"
    # FIFO: requests are admitted in the order they were submitted.
    assert [p.req for p in prefills] == [r.id for r in reqs]


def test_tick_counts_hold_the_allocator_state_at_its_start(model):
    sched = _sched(model)
    _submit(sched)
    for _ in range(6):
        cache = sched.cache
        want = {"pages": 7 - sched.free_pages,
                "tokens": int(cache.lengths.sum()), "page_size": 128}
        sched.step()
        tick = [s for s in metrics.spans() if s.name == "tick"][-1]
        assert tick.counts == want
        assert tick.counts["tokens"] <= tick.counts["pages"] * 128


def test_train_step_records_its_four_parts(model):
    gen = torch.Generator().manual_seed(1)
    m = llama.Llama.init(llama.LlamaConfig.tiny(), generator=gen,
                         dtype=torch.float32, device="cpu", trainable=True)
    state = training.create_train_state(
        m, training.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=50))
    tokens = torch.randint(0, 256, (2, 17), generator=gen)
    for _ in range(2):
        training.train_step(state, tokens)
    spans = metrics.spans()
    kids = _children(spans)
    steps = [s for s in spans if s.name == "train_step"]
    assert len(steps) == 2
    for s in steps:
        assert s.parent is None
        assert [c.name for c in kids[s]] == ["forward", "backward", "clip",
                                             "optimizer"]
        # Only clip and the optimizer are timed on the card, under a
        # profiler; with none and no card, nothing was.
        assert [c._device for c in [s] + kids[s]] == [False, False, False,
                                                      True, True]
        assert all(c.device_ms is None for c in kids[s])


def test_ring_keeps_its_maxlen_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 4)
    m = Metrics()
    starts = []
    for i in range(10):
        with m.span("s", i=i):
            pass
        starts.append(m.spans()[-1].start)
    assert len(m.spans()) == 4
    assert m.dropped == 6
    assert [s.counts["i"] for s in m.spans()] == [6, 7, 8, 9]
    # The newest dropped span started at starts[5].
    assert m.lost(starts[5]) and not m.lost(starts[6])
    m.clear()
    assert m.spans() == [] and m.dropped == 0 and not m.lost()


def test_parent_is_the_span_open_on_the_same_thread():
    m = Metrics()
    seen = {}

    def other():
        with m.span("other"):
            pass

    with m.span("outer"):
        with m.span("inner"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        m.event("mark")
    assert not t.is_alive()
    s = {x.name: x for x in m.spans()}
    assert s["inner"].parent is s["outer"] and s["outer"].parent is None
    assert s["other"].parent is None
    assert s["mark"].parent is s["outer"]
    assert s["mark"].start == s["mark"].end


def test_a_span_that_raises_is_still_recorded():
    m = Metrics()
    with pytest.raises(KeyError):
        with m.span("fails"):
            raise KeyError("x")
    (s,) = m.spans()
    assert s.name == "fails" and s.end >= s.start
    assert m._stack() == []


def test_with_no_profiler_a_span_calls_no_torch_function(model,
                                                         monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a torch call with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    with metrics.span("outer", device=True):
        with metrics.span("inner", device=True, n=1):
            pass
    assert [s.device_ms for s in metrics.spans()] == [None, None]
    sched = _sched(model)
    _submit(sched, SHAPES[:2])
    sched.step()
    assert any(s.name == "decode" for s in metrics.spans())


def test_under_the_profiler_spans_appear_in_the_trace(model):
    sched = _sched(model)
    _submit(sched, SHAPES[:2])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sched.step()
        sched.step()
    names = {e.name for e in prof.events()}
    for n in ("tick", "admit", "prefill", "decode", "sync"):
        assert tracing.PREFIX + n in names
    # The host spans are recorded as without the profiler.
    assert [s.name for s in metrics.spans()].count("tick") == 2


class _FakeEvent:
    """A stand-in CUDA event: its time is the host clock's."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = tracing.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, later):
        return 1e3 * (later.t - self.t)


def test_device_spans_record_an_event_pair_read_on_demand(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    m = Metrics()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with m.span("timed", device=True):
            with m.span("host_only"):
                pass
    timed, host = m.spans()
    assert timed._events is not None           # not read yet
    assert 0.0 <= timed.device_ms <= 1e3 * timed.seconds + 1.0
    assert timed._events is None and host.device_ms is None


def test_snapshot_keeps_mfa_tpus_keys_and_reads_the_ring():
    ours, theirs = Metrics(), jax_profiling.Metrics()
    for m in (ours, theirs):
        m.inc("requests")
        m.set("slots", 4)
        for _ in range(3):
            with m.timed("step"):
                pass
    ours.event("submit", req=1)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a.keys() == b.keys()
    assert a["latencies"].keys() == b["latencies"].keys() == {"step"}
    assert a["latencies"]["step"].keys() == b["latencies"]["step"].keys()
    assert a["latencies"]["step"]["count"] == 3
    assert not hasattr(ours, "latencies")
    # profiling's names are the recorder's.
    assert profiling.Metrics is Metrics and profiling.metrics is metrics
    assert profiling.trace is tracing.trace
