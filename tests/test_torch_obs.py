"""The port's observability (`paddle_tpu_torch/obs`, `profiler`,
`resilience.faults`) against the JAX package's: spans from two threads,
the Chrome-trace export and its validator, a disarmed trace that records
nothing, the metrics registry's Prometheus text equal to the JAX
registry's for the same series, the stat timers, and the fault points."""

import json
import threading

import numpy as np
import pytest

from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import trace as jtrace
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import profiler
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.resilience import faults as tfaults


@pytest.fixture
def armed_trace():
    tr = ttrace.arm()
    try:
        yield tr
    finally:
        ttrace.disarm(export=False)


def test_disarmed_trace_records_nothing():
    ttrace.disarm(export=False)
    assert not ttrace.armed()
    assert ttrace.span("x") is ttrace._NULL
    with ttrace.span("x", k=1):
        ttrace.instant("i")
        ttrace.counter("c", 1.0)
        ttrace.set_context(step=3)
    assert ttrace.get_context() == {}
    tr = ttrace.arm()
    try:
        assert tr.event_count() == 0
    finally:
        ttrace.disarm(export=False)


def test_spans_from_two_threads_export_and_validate(armed_trace, tmp_path):
    def worker():
        ttrace.set_context(batch=7)
        with ttrace.span("prefetch.batch", "prefetch"):
            ttrace.counter("depth", 2)

    ttrace.set_context(step=1)
    with ttrace.span("forwardBackward", "timer", extra="a"):
        t = threading.Thread(target=worker, name="producer")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        ttrace.instant("mark")
    path = armed_trace.export(str(tmp_path / "t.json"))
    with open(path) as f:
        doc = json.load(f)
    assert ttrace.validate_chrome_trace(doc) == []
    assert jtrace.validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"forwardBackward", "prefetch.batch"}
    assert len({e["tid"] for e in spans}) == 2
    fb = next(e for e in spans if e["name"] == "forwardBackward")
    assert fb["args"] == {"step": 1, "extra": "a"}
    pf = next(e for e in spans if e["name"] == "prefetch.batch")
    assert pf["args"] == {"batch": 7}
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert "producer" in names


@pytest.mark.parametrize("doc,bad", [
    ({}, "top level"),
    ({"traceEvents": [{"ph": "Q", "name": "x", "pid": 1, "tid": 1}]}, "bad ph"),
    ({"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0, "dur": -1}]},
     "bad dur"),
    ({"traceEvents": [{"ph": "i", "name": "", "pid": 1, "tid": 1, "ts": 0}]}, "missing name"),
])
def test_validator_agrees_with_jax(doc, bad):
    got, want = ttrace.validate_chrome_trace(doc), jtrace.validate_chrome_trace(doc)
    assert got == want and any(bad in p for p in got)


def test_ring_overflow_counts_drops():
    tr = ttrace.arm(ring_size=4)
    try:
        for i in range(10):
            with ttrace.span(f"s{i}"):
                pass
        assert tr.event_count() == 4 and tr.dropped_total() == 6
    finally:
        ttrace.disarm(export=False)
    assert ttrace.dropped_total() >= 6


def _fill(reg, m):
    h = reg.histogram("pt_step_seconds", help="step time")
    for v in (0.0004, 0.003, 0.02, 0.7, 40.0):
        h.observe(v)
    reg.declare_counter("pt_requests_total", help="requests")
    reg.counter_inc("pt_requests_total", 3)
    reg.counter_inc("pt_errors_total", 2, labels={"kind": 'a"b\\c\nd'})
    reg.counter_inc("pt_errors_total", 1, labels={"kind": "x"})
    reg.gauge("pt_trainer_step", lambda: 17, help="global step")
    reg.gauge("pt_dead", lambda: None)
    ss = m.StatSet()
    ss.get("hostSync").add(0.25)
    ss.get("hostSync").add(0.5)
    reg.attach_stat_set(ss)
    reg.add_collector(lambda: [("pt_fault_hits_total", "counter", "hits",
                                [({"point": "ckpt.write"}, 2.0)])])


def test_registry_text_equals_jax():
    from paddle_tpu import profiler as jprofiler

    t, j = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _fill(t, profiler)
    _fill(j, jprofiler)
    text = t.render()
    assert text == j.render()
    assert "# TYPE pt_step_seconds histogram" in text and 'kind="a\\"b\\\\c\\nd"' in text
    assert "pt_dead" not in text


def test_global_registry_collectors(monkeypatch):
    monkeypatch.setattr(profiler.FLAGS, "enable_timers", True)
    profiler.global_stat_set().reset()
    with profiler.timer("prepareBatchData"):
        pass
    text = tmetrics.registry().render()
    assert "pt_timer_prepareBatchData_count 1" in text
    assert "pt_trace_armed 0" in text
    profiler.global_stat_set().reset()


def test_timer_is_off_unless_enabled_or_traced(monkeypatch):
    monkeypatch.setattr(profiler.FLAGS, "enable_timers", False)
    ss = profiler.StatSet()
    with ss.timer("a"):
        pass
    assert ss.as_dict() == {}
    with ss.timer("a", always=True):
        pass
    tr = ttrace.arm()
    try:
        with ss.timer("b"):
            pass
        assert tr.event_count() == 1  # a span, though no stat
    finally:
        ttrace.disarm(export=False)
    assert set(ss.as_dict()) == {"a"} and ss.get("a").count == 1


@pytest.mark.parametrize("spec", ["ckpt.write:hit=2:action=corrupt",
                                  "executor.step:p=0.5:seed=7;ckpt.meta:hits=1,3",
                                  "executor.step:p=0.3:seed=1:times=2"])
def test_faults_fire_as_jax(spec):
    hits = {}
    for mod in (tfaults, jfaults):
        mod.reset()
        mod.arm_from_spec(spec)
        seq = []
        for i in range(12):
            for point in ("ckpt.write", "executor.step", "ckpt.meta"):
                try:
                    seq.append((point, mod.fire(point)))
                except mod.InjectedFault:
                    seq.append((point, "raised"))
        hits[mod] = (seq, {k: (v["hits"], v["fired"]) for k, v in mod.stats().items()})
        mod.reset()
    assert hits[tfaults] == hits[jfaults]
    assert any(v is not None for _, v in hits[tfaults][0])  # something fired


def test_faults_reject_unknown_points_and_bad_specs():
    with pytest.raises(ValueError, match="unknown fault point"):
        tfaults.arm("no.such.point", hit=1)
    with pytest.raises(ValueError, match="expected key=value"):
        tfaults.arm_from_spec("ckpt.write:hit")
    assert tfaults.fire("ckpt.write") is None  # disarmed: a no-op


def test_parameter_stats():
    import paddle_tpu_torch as ptt

    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[3])
        ptt.layers.fc(x, size=2)
    sc = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=sc, seed=0)
    st = profiler.parameter_stats(main, sc)
    for p in main.parameters():
        v = sc.get(p.name).numpy()
        assert st[p.name]["mean"] == pytest.approx(float(v.mean()))
        assert st[p.name]["abs_max"] == pytest.approx(float(np.abs(v).max()))
