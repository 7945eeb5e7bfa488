"""The port's serving stack (paddle_tpu_torch/serving) on the CPU: the
engine's buckets, the micro-batcher, the HTTP front end and the breaker,
against its own exact-shape path and against the JAX package's engine.

Tolerances: the port's bucketed answers against its `bucketed=False` ones
within BUCKET_TOL, a few f32 ulps of these outputs' sums: every op of these
models is row-independent, but the CPU's GEMM picks its blocking by the row
count, so a row's sum may round differently at M=6 than at M=8 (the card's
int8 GEMM is exact, and chip_smoke holds its bucketed answers to bits).
Against the JAX engine, f32 within 1e-5: the two packages' GEMMs reduce in
different orders. Coalesced rows run at another batch size than alone and
are held to the same 1e-5.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import serving as jserving
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (REQUEST_ID_HEADER, BucketPolicy, CircuitBreaker,
                                      CircuitOpenError, DeadlineError, MicroBatcher,
                                      ModelRegistry, ServingEngine, ShedError, make_server)
from paddle_tpu_torch.serving.metrics import MetricSet

TOL = 1e-5
BUCKET_TOL = dict(rtol=1e-6, atol=1e-6)


def _train_dense_model(dirname):
    """tests/test_serving.py's MLP regressor, trained 10 SGD steps and saved
    by the JAX package."""
    pt.reset()
    pt.default_startup_program().random_seed = 3
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.data("y", shape=[1])
    h = pt.layers.fc(x, size=8, act="relu")
    pred = pt.layers.fc(h, size=1)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.optimizer.SGD(learning_rate=0.05).minimize(cost)
    exe = pt.Executor()
    exe.run(pt.default_startup_program())
    rng = np.random.RandomState(0)
    for _ in range(10):
        xv = rng.randn(16, 4).astype(np.float32)
        exe.run(feed={"x": xv, "y": xv.sum(1, keepdims=True)}, fetch_list=[cost])
    pt.io.save_inference_model(dirname, ["x"], [pred])


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tserve_dense"))
    _train_dense_model(d)
    return d


@pytest.fixture(scope="module")
def port_dense_dir(tmp_path_factory):
    """The same MLP built, initialized and saved by the port."""
    d = str(tmp_path_factory.mktemp("tserve_port_dense"))
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[4])
        pred = ptt.layers.fc(ptt.layers.fc(x, size=8, act="relu"), size=1)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    ptt.io.save_inference_model(d, ["x"], [pred], main_program=main, scope=scope)
    return d


def _engine(d, name, max_batch_size=16, **kw):
    return ServingEngine(d, policy=BucketPolicy(max_batch_size=max_batch_size),
                         model_name=name, device="cpu", **kw)


def test_bucketed_equals_exact_shape_and_bounded_shapes(dense_dir):
    """Mixed batch sizes land on at most len(batch_buckets) shapes, each
    answer the exact-shape path's within BUCKET_TOL, the counters
    agreeing."""
    eng = _engine(dense_dir, "acc")
    oracle = _engine(dense_dir, "acc_oracle")
    assert eng.policy.batch_buckets == (1, 2, 4, 8, 16)
    rng = np.random.RandomState(1)
    for n in rng.randint(1, 17, size=40):
        xv = rng.randn(n, 4).astype(np.float32)
        got = eng.predict({"x": xv})[0]
        assert got.shape == (n, 1)
        np.testing.assert_allclose(got, oracle.predict({"x": xv}, bucketed=False)[0],
                                   **BUCKET_TOL)
    s = eng.stats()
    assert s["compiled_programs"] <= len(eng.policy.batch_buckets)
    assert s["cache_hits"] + s["cache_misses"] == 40 and s["hit_rate"] >= 0.85
    assert s["dispatches_total"] == s["syncs_total"] == 40


def test_seq_buckets_equal_exact_shape():
    """Sequence bucketing (zero positions after edge rows) against the
    port's own bucketed=False path, on a position-wise model."""
    import tempfile

    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[8, 6])
        h = ptt.layers.fc(x, size=5, act="tanh", num_flatten_dims=2)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    d = tempfile.mkdtemp()
    ptt.io.save_inference_model(d, ["x"], [h], main_program=main, scope=scope)
    pol = BucketPolicy(max_batch_size=4, seq_len_buckets=(4, 8))
    eng = ServingEngine(d, policy=pol, model_name="seq", device="cpu")
    oracle = ServingEngine(d, model_name="seq_oracle", device="cpu")
    rng = np.random.RandomState(3)
    for _ in range(20):
        xv = rng.randn(int(rng.randint(1, 5)), int(rng.randint(2, 9)), 6).astype(np.float32)
        got = eng.predict({"x": xv})[0]
        assert got.shape == xv.shape[:2] + (5,)
        np.testing.assert_allclose(got, oracle.predict({"x": xv}, bucketed=False)[0],
                                   **BUCKET_TOL)
    assert eng.compiled_programs() <= pol.max_programs()


def test_predict_matches_the_jax_engine_both_ways(dense_dir, port_dense_dir):
    """A JAX-saved artifact served by both engines, and a port-saved one
    loaded by the JAX engine: the same fingerprint, answers within TOL."""
    rng = np.random.RandomState(2)
    for d in (dense_dir, port_dense_dir):
        port = _engine(d, "x_port")
        jax_eng = jserving.ServingEngine(d, policy=jserving.BucketPolicy(max_batch_size=16),
                                         model_name="x_jax")
        assert port.fingerprint == jax_eng.fingerprint
        for n in (1, 3, 8):
            xv = rng.randn(n, 4).astype(np.float32)
            np.testing.assert_allclose(port.predict({"x": xv})[0],
                                       np.asarray(jax_eng.predict({"x": xv})[0]),
                                       rtol=0, atol=TOL)


def test_warmup_counters_and_oversized_batch(dense_dir):
    eng = _engine(dense_dir, "counters", max_batch_size=8)
    warm = eng.warmup()
    assert warm == len(eng.policy.batch_buckets) == eng.compiled_programs()
    assert eng.dispatches_total == eng.syncs_total == warm
    rng = np.random.RandomState(3)
    for k in (1, 3, 8):
        eng.predict({"x": rng.randn(k, 4).astype(np.float32)})
    s = eng.stats()
    assert (s["dispatches_total"], s["syncs_total"], s["cache_misses"]) == (warm + 3, warm + 3,
                                                                          warm)
    rendered = eng.metrics.render()
    assert "ptserving_dispatches_total" in rendered and "ptserving_syncs_total" in rendered
    with pytest.raises(ValueError, match="exceeds the largest"):
        eng.predict({"x": np.zeros((9, 4), np.float32)})
    with pytest.raises(ValueError, match="only 'int8'"):
        _engine(dense_dir, "q", quantize="int4")
    with pytest.raises(ValueError, match="no quant sidecar"):
        _engine(dense_dir, "q", quantize="int8")
    with pytest.raises(NotImplementedError, match="A10"):
        _engine(dense_dir, "mesh", mesh=object())
    with pytest.raises(NotImplementedError, match="A11"):
        eng.tune_coverage()


def test_batcher_coalesces_queued_requests(dense_dir):
    """Requests queued before the worker starts coalesce into ONE engine
    call."""
    eng = _engine(dense_dir, "coal")
    oracle = _engine(dense_dir, "coal_oracle")
    # its own registry: the process-wide one's batch_rows histogram also
    # counts every other batcher this process has run
    b = MicroBatcher(eng, max_wait_ms=10, max_queue=16,
                     metrics=MetricSet(registry=MetricsRegistry()))
    rng = np.random.RandomState(5)
    reqs = [rng.randn(1, 4).astype(np.float32) for _ in range(6)]
    futs = [b.submit({"x": r}) for r in reqs]
    b.start()
    try:
        results = [f.result(timeout=30) for f in futs]
    finally:
        b.stop()
    assert eng.cache_hits + eng.cache_misses == 1
    assert b._batch_hist.count == 1 and b._batch_hist.sum == 6
    for r, xv in zip(results, reqs):
        np.testing.assert_allclose(r[0], oracle.predict({"x": xv}, bucketed=False)[0],
                                   rtol=0, atol=TOL)


def test_batcher_concurrent_clients(dense_dir):
    """8 threads x 3 requests against a running batcher: every answer right,
    fewer engine calls than requests."""
    eng = _engine(dense_dir, "conc", max_batch_size=32)
    eng.warmup()
    calls0 = eng.cache_hits + eng.cache_misses
    oracle = _engine(dense_dir, "conc_oracle")
    b = MicroBatcher(eng, max_wait_ms=30, max_queue=64).start()
    rng = np.random.RandomState(6)
    inputs = [rng.randn(2, 4).astype(np.float32) for _ in range(24)]
    outs, errs = {}, []

    def client(i):
        try:
            for j in range(3):
                outs[i * 3 + j] = b.predict({"x": inputs[i * 3 + j]}, timeout_ms=20000)
        except Exception as e:  # pragma: no cover - diagnostic
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        b.stop()
    assert not errs and len(outs) == 24
    for k, res in outs.items():
        np.testing.assert_allclose(res[0], oracle.predict({"x": inputs[k]}, bucketed=False)[0],
                                   rtol=0, atol=TOL)
    assert eng.cache_hits + eng.cache_misses - calls0 < 24


def test_shed_and_deadline(dense_dir):
    eng = _engine(dense_dir, "shed")
    b = MicroBatcher(eng, max_queue=2)  # worker not started: the queue fills
    b.submit({"x": np.zeros((1, 4), np.float32)})
    b.submit({"x": np.zeros((1, 4), np.float32)})
    with pytest.raises(ShedError, match="queue full"):
        b.submit({"x": np.zeros((1, 4), np.float32)})
    assert b.metrics.counter_value("shed_total") >= 1
    b.stop()
    b = MicroBatcher(eng, max_queue=8)
    fut = b.submit({"x": np.zeros((1, 4), np.float32)}, timeout_ms=10)
    time.sleep(0.05)  # the deadline lapses before the worker starts
    b.start()
    try:
        with pytest.raises(DeadlineError):
            fut.result(timeout=30)
    finally:
        b.stop()


def test_breaker_trips_on_engine_faults(dense_dir):
    """Two injected serving.predict faults open the breaker; the open
    circuit refuses at submit; after the reset timeout a probe closes it."""
    eng = _engine(dense_dir, "brk")
    # a reset timeout far above a loaded host's pauses: the circuit must
    # still read open when the test looks
    breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=0.5)
    b = MicroBatcher(eng, max_queue=8, breaker=breaker).start()
    feed = {"x": np.zeros((1, 4), np.float32)}
    try:
        faults.reset()
        faults.arm("serving.predict", p=1.0, times=2)
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                b.predict(feed, timeout_ms=10000)
        assert breaker.state() == "open"
        with pytest.raises(CircuitOpenError):
            b.submit(feed)
        time.sleep(0.6)
        assert b.predict(feed, timeout_ms=10000)[0].shape == (1, 1)
        assert breaker.state() == "closed" and breaker.stats()["opens"] == 1
    finally:
        faults.reset()
        b.stop()


@pytest.fixture()
def http_stack(dense_dir):
    reg = ModelRegistry()
    eng, _ = reg.add("default", model_dir=dense_dir, policy=BucketPolicy(max_batch_size=16),
                     max_wait_ms=5.0, timeout_ms=20000.0, device="cpu")
    eng.warmup()
    srv = make_server(reg)
    srv.serve_background()
    try:
        yield reg, eng, f"http://127.0.0.1:{srv.port}"
    finally:
        srv.shutdown()
        reg.stop()
        srv.server_close()


def _post(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=60)


def test_stats_reads_launches_and_dispatches_in_one_snapshot(port_dense_dir, monkeypatch):
    """/stats reads the process's kernel launch counts and each engine's
    dispatches with every engine's lock held: a request that runs while
    the counts are read is in neither, not in the dispatches alone (which
    would make launches a request read low)."""
    from paddle_tpu_torch.core import graph

    reg = ModelRegistry()
    eng, _ = reg.add("default", model_dir=port_dense_dir, device="cpu")
    feed = {"x": np.ones((2, 4), np.float32)}
    eng.predict(feed)
    seen, runs = {}, []
    read = graph.counter_state

    def racing_read():
        # a request arrives while the counts are read
        seen["dispatches"] = eng.dispatches_total
        t = threading.Thread(target=eng.predict, args=(feed,))
        t.start()
        t.join(0.5)
        runs.append(t)
        return read()

    monkeypatch.setattr(graph, "counter_state", racing_read)
    s = reg.stats()["default"]
    assert s["dispatches_total"] == seen["dispatches"] == 1
    runs[0].join(30)
    assert eng.dispatches_total == 2


def test_http_predict_healthz_stats_metrics(http_stack, dense_dir):
    reg, eng, url = http_stack
    oracle = _engine(dense_dir, "http_oracle")
    rng = np.random.RandomState(7)
    for n in (1, 3, 8):
        xv = rng.randn(n, 4).astype(np.float32)
        with _post(url + "/predict", {"inputs": {"x": xv.tolist()}}) as r:
            (vals,) = json.load(r)["outputs"].values()
        want = oracle.predict({"x": xv}, bucketed=False)[0]
        np.testing.assert_allclose(np.asarray(vals, np.float32), want, rtol=0, atol=TOL)
        # the npz reply carries the same values, bit for bit
        with _post(url + "/predict", {"inputs": {"x": xv.tolist()}, "format": "npz"}) as r:
            assert r.headers["Content-Type"] == "application/x-npz"
            got = np.load(io.BytesIO(r.read()))[eng.fetch_names[0]]
        np.testing.assert_array_equal(got, np.asarray(vals, np.float32))
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.load(r)
    assert h["status"] == "ok" and h["models"] == ["default"]
    assert h["versions"]["default"] == eng.fingerprint
    for k in ("queue_depth", "queue_age_ms", "active_slots", "max_slots", "slot_occupancy",
              "first_token_p99_ms", "dispatches_total", "syncs_total", "classes", "models"):
        assert k in h["load"], k
    assert h["load"]["dispatches_total"] >= 6 and h["load"]["models"]["default"][
        "slo_class"] == "interactive"
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        assert json.load(r)["default"]["compiled_programs"] <= 5
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        metrics = r.read().decode()
    for needle in ("ptserving_compile_cache_hits_total", "ptserving_engine_run_seconds_bucket",
                   "ptserving_engine_run_seconds_p99", "ptserving_batch_rows",
                   "ptserving_queue_depth", "ptserving_circuit_state_default",
                   'pt_slo_admitted_total{slo="interactive"}'):
        assert needle in metrics, needle
    for line in metrics.splitlines():  # the exposition parses line by line
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            assert name[0].isalpha() or name[0] == "_", line


def test_http_errors_and_request_id(http_stack):
    reg, eng, url = http_stack
    for path, body, code in (("/predict/nope", {"inputs": {"x": [[0, 0, 0, 0]]}}, 404),
                             ("/predict", {"not_inputs": 1}, 400),
                             ("/predict", {"inputs": {"bogus": [1.0]}}, 400),
                             ("/predict", {"inputs": {"x": [[0] * 4]}, "format": "xml"}, 400),
                             ("/nowhere", {}, 404)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + path, body)
        assert ei.value.code == code, path
        ei.value.close()
    body = {"inputs": {"x": [[0.1, 0.2, 0.3, 0.4]]}}
    with _post(url + "/predict", body, {REQUEST_ID_HEADER: "rt-777"}) as r:
        assert r.headers.get(REQUEST_ID_HEADER) == "rt-777"
    with _post(url + "/predict", body) as r:
        assert r.headers.get(REQUEST_ID_HEADER)  # minted


def test_http_shed_and_deadline(dense_dir):
    """A stuck model (worker never started, a queue of 1): the first request
    times out with 504, an overflowing one sheds with 503."""
    reg = ModelRegistry()
    eng = _engine(dense_dir, "stuck", metrics=reg.metrics)
    reg.add("stuck", engine=eng, batcher=MicroBatcher(eng, max_queue=1, metrics=reg.metrics))
    srv = make_server(reg)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.port}/predict/stuck"
    codes = {}

    def post(tag):
        try:
            _post(url, {"inputs": {"x": [[0, 0, 0, 0]]}, "timeout_ms": 1000}).close()
            codes[tag] = 200
        except urllib.error.HTTPError as e:
            codes[tag] = e.code
            e.close()

    ta = threading.Thread(target=post, args=("a",))
    try:
        ta.start()
        time.sleep(0.5)  # the first request holds the only queue slot
        post("b")
        ta.join(timeout=30)
        assert not ta.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert codes == {"a": 504, "b": 503}, codes
