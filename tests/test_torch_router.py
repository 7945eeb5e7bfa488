"""The port's router, fleet and control plane (serving/router.py, fleetctl/,
obs/promparse.py, cli.py) on the CPU.

Held against the JAX package where both can run the same input: trace
generation (events and digest), the Prometheus parser (families of both
packages' /metrics text), the autoscaler's decisions (scripted signals, a
fake clock). The router's contract (JSQ picks, the retry of shed requests,
failover and the breaker, streaming pass-through, request ids) runs over
in-process stub replicas (tests/test_router.py's), a rollout over simulated
replicas, and one subprocess test drives `python -m paddle_tpu_torch serve
--device cpu --replicas 1 --standby 1` through a SIGKILL of its replica.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import paddle_tpu_torch as ptt
from paddle_tpu.fleetctl import autoscaler as jautoscaler
from paddle_tpu.fleetctl import traces as jtraces
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import promparse as jpromparse
from paddle_tpu_torch.fleetctl import (Autoscaler, AutoscalerConfig, RolloutError,
                                       RolloutManager, SimReplica)
from paddle_tpu_torch.fleetctl.traces import TraceSpec, generate_trace, trace_digest
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import promparse
from paddle_tpu_torch.serving import REQUEST_ID_HEADER
from paddle_tpu_torch.serving.router import Fleet, Router, make_router_server
from test_router import StubReplica

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------- traces ------

SPECS = {
    "default": {},
    "flash_mix": {"duration_s": 20.0, "seed": 11, "base_rps": 10.0,
                  "flash_crowds": ((0.5, 3.0, 4.0),),
                  "models": (("chat", 2.0, "interactive"), ("bulk", 1.0, "batch")),
                  "stream_fraction": 0.1},
    "gen_v3": {"duration_s": 30.0, "seed": 17, "base_rps": 4.0, "diurnal_amplitude": 0.3,
               "flash_crowds": (), "shared_prefix_fraction": 0.6, "prefix_groups": 3},
    "disagg": {"duration_s": 10.0, "seed": 5, "base_rps": 6.0, "disagg_fraction": 0.7},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_traces_equal_the_jax_package(name):
    mine = generate_trace(TraceSpec(**SPECS[name]))
    theirs = jtraces.generate_trace(jtraces.TraceSpec(**SPECS[name]))
    assert mine == theirs and len(mine) > 0
    assert trace_digest(mine) == jtraces.trace_digest(theirs)
    assert TraceSpec(**SPECS[name]).describe() == jtraces.TraceSpec(**SPECS[name]).describe()


def test_trace_spec_validation():
    for bad in ({"diurnal_amplitude": 1.5}, {"pareto_alpha": 1.0},
                {"models": (("m", 1.0, "gold"),)}):
        with pytest.raises(ValueError):
            TraceSpec(**bad)
        with pytest.raises(ValueError):
            jtraces.TraceSpec(**bad)


# ----------------------------------------------------------- promparse -----

def _families(fams):
    return {n: (f.type, sorted((s[0], tuple(sorted(s[1].items())), s[2]) for s in f.samples))
            for n, f in fams.items()}


def _scrape_text(pkg_metrics):
    """A /metrics-like exposition from one package's registry: a counter
    with labels, a histogram, a gauge and an escaped label value."""
    reg = pkg_metrics.MetricsRegistry()
    reg.declare_counter("pt_router_routed_total", help="requests routed",
                        labels={"replica": "r0"})
    reg.counter_inc("pt_router_routed_total", by=3.0, labels={"replica": 'r"1\\'})
    h = reg.histogram("ptserving_gen_first_token_seconds", buckets=(0.01, 0.1, 1.0),
                      help="first token")
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    reg.gauge("ptserving_gen_slot_occupancy", lambda: 0.25, help="occupancy")
    return reg.render()


@pytest.mark.parametrize("source", ["jax", "port"])
def test_promparse_equals_the_jax_parser(source):
    text = _scrape_text(jmetrics if source == "jax" else obs_metrics)
    mine, theirs = promparse.parse_text(text), jpromparse.parse_text(text)
    assert _families(mine) == _families(theirs)
    assert mine["pt_router_routed_total"].value({"replica": 'r"1\\'}) == 3.0
    assert mine["ptserving_gen_first_token_seconds"].type == "histogram"


def test_promparse_reads_a_port_server(tmp_path):
    """The port server's /metrics parses the same with both parsers."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        pred = ptt.layers.fc(ptt.layers.data("x", shape=[4]), size=2)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    d = str(tmp_path / "dense")
    ptt.io.save_inference_model(d, ["x"], [pred], main_program=main, scope=scope)
    reg = ptt.serving.ModelRegistry()
    reg.add("default", model_dir=d, device="cpu")
    srv = ptt.serving.make_server(reg)
    srv.serve_background()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        req = urllib.request.Request(url + "/predict", data=json.dumps(
            {"inputs": {"x": [[1, 2, 3, 4]]}}).encode())
        urllib.request.urlopen(req, timeout=30).close()
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        srv.shutdown()
        reg.stop()
        srv.server_close()
    mine = promparse.parse_text(text)
    assert _families(mine) == _families(jpromparse.parse_text(text))
    assert mine["ptserving_requests_total"].value() >= 1


# -------------------------------------------------------------- router -----

@pytest.fixture()
def stubs():
    reps = [StubReplica(f"s{i}") for i in range(3)]
    yield reps
    # each close waits out its server's poll interval: close them together
    closers = [threading.Thread(target=r.close) for r in reps]
    for t in closers:
        t.start()
    for t in closers:
        t.join(10)


@pytest.fixture()
def router(stubs):
    rt = Router(registry=obs_metrics.MetricsRegistry(), probe_interval_s=60.0,
                request_timeout_s=10.0)
    for s in stubs:
        rt.add_replica(s.url, name=s.srv.name)
    yield rt
    rt.close()


def _loads(router, depths):
    for r, d in zip(router.replicas(), depths):
        r.snapshot = {"queue_depth": d, "active_slots": 0, "max_slots": 0}


def test_jsq_pick_and_open_breaker(router, stubs):
    _loads(router, (5, 1, 3))
    r = router.pick()
    assert r.name == "s1"
    router._release(r)
    s1 = router.replicas()[1]
    s1.breaker.trip()
    r = router.pick()
    assert r.name == "s2"
    router._release(r)


def _post(url, body, headers=None, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    return urllib.request.urlopen(req, timeout=timeout)


def test_retry_failover_stream_and_request_ids(router, stubs):
    """Through a RouterServer: a shed replica's 503 is retried on another, a
    dead replica trips its breaker and fails over, streams pass through, and
    the request id is forwarded."""
    _loads(router, (0, 5, 5))
    stubs[0].srv.shed = True
    srv = make_router_server(router)
    srv.serve_background()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        with _post(url + "/predict", {"inputs": {}}, {REQUEST_ID_HEADER: "rid-9"}) as r:
            out = json.load(r)
        assert out["who"] in ("s1", "s2") and out["rid"] == "rid-9"
        assert router.registry.counter_value("pt_router_retried_total") >= 1
        stubs[0].srv.shed = False
        stubs[1].die()
        _loads(router, (5, 0, 5))
        for _ in range(router.replicas()[1].breaker.failure_threshold):
            with _post(url + "/predict", {"inputs": {}}) as r:
                assert json.load(r)["who"] in ("s0", "s2")
        assert router.replicas()[1].breaker.state() == "open"
        with _post(url + "/generate", {"stream": True, "inputs": {}}) as r:
            events = [json.loads(line) for line in r if line.strip()]
        assert [e["event"] for e in events] == ["token"] * 3 + ["done"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_pick_hot_path_has_no_blocking_io():
    """Router.pick reads only in-memory state (the JAX package's lint, on
    the port's source)."""
    import ast
    import inspect
    import textwrap

    from paddle_tpu_torch.serving.router import Router as R

    tree = ast.parse(textwrap.dedent(inspect.getsource(R.pick)))
    names = {n.attr if isinstance(n, ast.Attribute) else getattr(n, "id", "")
             for n in ast.walk(tree) if isinstance(n, (ast.Attribute, ast.Name))}
    assert not names & {"urlopen", "request", "sleep", "HTTPConnection", "getresponse"}


# ---------------------------------------------------------- autoscaler -----

class _FakeRouter:
    def __init__(self, pkg_metrics):
        self.registry = pkg_metrics.MetricsRegistry()

    def replicas(self):
        return []


class _FakeFleet:
    def __init__(self, pkg_metrics, size=2, warm=1):
        self.router = _FakeRouter(pkg_metrics)
        self._size = size
        self.warm_ready = warm
        self.log = []

    def size(self):
        return self._size

    def scale_up(self, n=1):
        if not self.warm_ready:
            return []
        self.warm_ready -= 1
        self._size += 1
        self.log.append(("up", self._size))
        return [f"r{self._size}"]

    def scale_down(self, n=1, drain_timeout_s=30.0):
        if self._size <= 1:
            return []
        self._size -= 1
        self.log.append(("down", self._size))
        return [f"r{self._size + 1}"]


def _sig(replicas, depth=0.0, age=0.0, occ=0.0, p99=0.0):
    return {"replicas": replicas, "queue_depth_per_replica": depth, "queue_age_ms": age,
            "slot_occupancy": occ, "first_token_p99_ms": p99}


# (depth, age, occ, p99) a tick, and standbys warmed at tick index
SCRIPTS = {
    "pressure": ([(10.0, 0, 0, 0)] * 12 + [(0.0, 0, 0, 0)] * 30, {0: 2}),
    "occupancy_and_age": ([(0, 900.0, 0.95, 0)] * 6 + [(0, 0, 0.1, 0)] * 20
                          + [(0, 0, 0, 5000.0)] * 8, {0: 1, 15: 1}),
    "blocked_then_warm": ([(10.0, 0, 0, 0)] * 10, {6: 1}),
}


def _drive(cls, cfg_cls, pkg_metrics, script):
    ticks, warm_at = SCRIPTS[script]
    fleet = _FakeFleet(pkg_metrics, size=2, warm=0)
    cfg = cfg_cls(max_replicas=4, up_stable_ticks=2, down_stable_ticks=3, cooldown_s=2.0)
    clock = {"t": 100.0}
    sc = cls(fleet, cfg, registry=fleet.router.registry, clock=lambda: clock["t"])
    acts = []
    for i, (depth, age, occ, p99) in enumerate(ticks):
        fleet.warm_ready += warm_at.get(i, 0)
        sc.signals = lambda d=depth, a=age, o=occ, p=p99: _sig(float(fleet.size()), d, a, o, p)
        clock["t"] += 0.25
        acts.append(sc.tick())
    reg = fleet.router.registry
    counts = {n: reg.counter_value(f"pt_autoscale_{n}_total") for n in ("up", "down", "blocked")}
    return acts, fleet.log, counts, sc.last_reaction_s


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_autoscaler_decisions_equal_the_jax_package(script):
    mine = _drive(Autoscaler, AutoscalerConfig, obs_metrics, script)
    theirs = _drive(jautoscaler.Autoscaler, jautoscaler.AutoscalerConfig, jmetrics, script)
    assert mine == theirs
    assert any(a is not None for a in mine[0])


# ------------------------------------------------------------- rollout -----

def _sim_spawner(fingerprint, **kw):
    def spawn():
        return SimReplica(service_ms=5.0, fingerprint=fingerprint, **kw)
    return spawn


def _artifact(tmp_path, name, fingerprint):
    d = tmp_path / name
    d.mkdir()
    (d / "meta.json").write_text(json.dumps({"program_fingerprint": fingerprint}))
    return str(d)


def _wait_until(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_rollout_over_a_sim_fleet(tmp_path):
    """warm, verify, flip, drain: afterwards every request lands on the new
    fingerprint; an artifact a replica does not serve aborts before the
    flip."""
    v2 = _artifact(tmp_path, "v2", "fp-v2")
    v3 = _artifact(tmp_path, "v3", "fp-v3")

    def spawn_template(model_dir):
        fp = json.load(open(os.path.join(model_dir, "meta.json")))["program_fingerprint"]
        # v3's replicas serve the wrong bits
        return _sim_spawner("fp-imposter" if fp == "fp-v3" else fp)

    reg = obs_metrics.MetricsRegistry()
    router = Router(probe_interval_s=0.05, registry=reg)
    fleet = Fleet(_sim_spawner("fp-v1"), replicas=2, router=router, supervise_interval_s=0.1,
                  ready_timeout_s=10.0)
    fleet.spawn_template = spawn_template
    fleet.start()
    srv = make_router_server(router, fleet=fleet)
    srv.serve_background()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        with _post(url + "/predict", {"inputs": {}}) as r:
            assert json.load(r)["fingerprint"] == "fp-v1"
        report = RolloutManager(fleet).rollout(v2, drain_timeout_s=10.0)
        assert report["status"] == "ok" and report["fingerprint"] == "fp-v2"
        for _ in range(3):
            with _post(url + "/predict", {"inputs": {}}) as r:
                assert json.load(r)["fingerprint"] == "fp-v2"
        assert {r.versions.get("default") for r in router.replicas()} == {"fp-v2"}
        before = set(fleet._procs)
        with pytest.raises(RolloutError, match="verify failed"):
            RolloutManager(fleet).rollout(v3)
        assert set(fleet._procs) == before
        with urllib.request.urlopen(url + "/admin/fleet", timeout=10) as r:
            doc = json.load(r)
        assert doc["fleet"]["replicas"] == 2
    finally:
        srv.shutdown()
        srv.server_close()
        fleet.stop()


# --------------------------------------------- the serve command, killed ---

def _dense_artifact(d):
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        pred = ptt.layers.fc(ptt.layers.data("x", shape=[4]), size=2)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    ptt.io.save_inference_model(d, ["x"], [pred], main_program=main, scope=scope)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def test_cli_serve_fleet_survives_a_sigkill(tmp_path):
    """`python -m paddle_tpu_torch serve --device cpu --replicas 1
    --standby 1`: a /predict, SIGKILL of the serving replica, the standby
    promoted and answering, then SIGTERM exits 0."""
    d = str(tmp_path / "dense")
    _dense_artifact(d)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--model_dir", d, "--device", "cpu",
         "--replicas", "1", "--standby", "1", "--port", "0", "--probe_interval_ms", "100",
         "--max_batch_size", "4", "--replica_log_dir", str(tmp_path / "logs")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)  # its replicas join its process group
    lines = []
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("routing "):
                url = line.split(" on ")[-1].strip()
        assert url, "".join(lines)
        want = None
        with _post(url + "/predict", {"inputs": {"x": [[1, 2, 3, 4]]}}) as r:
            want = json.load(r)["outputs"]
        _wait_until(lambda: _get(url + "/admin/fleet")["fleet"]["warm_ready"] == 1,
                    timeout=60, msg="the standby warm")
        (name, rep), = _get(url + "/healthz")["replicas"].items()
        os.kill(_get(rep["url"] + "/healthz")["pid"], signal.SIGKILL)

        def promoted():
            reps = _get(url + "/healthz")["replicas"]
            return name not in reps and any(r["up"] for r in reps.values())

        _wait_until(promoted, timeout=60, msg="standby promotion")
        with _post(url + "/predict", {"inputs": {"x": [[1, 2, 3, 4]]}}) as r:
            assert json.load(r)["outputs"] == want
        assert _get(url + "/admin/fleet")["fleet"]["replaced_total"] == 1
        assert sorted(os.listdir(tmp_path / "logs"))[:2] == ["replica-1.log", "replica-2.log"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        try:  # the router and every replica it spawned
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=10)
        proc.stdout.close()


def test_cli_route_and_fleetctl_status(stubs, capsys):
    """`python -m paddle_tpu_torch route` over a running replica relays a
    /predict and exits 0 on SIGTERM; `fleetctl status` reads its
    /admin/fleet; the commands the port leaves out raise."""
    from paddle_tpu_torch import cli

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "route", "--replica", stubs[0].url,
         "--port", "0", "--probe_interval_ms", "100"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("routing 1 replica(s) on "), line
        url = line.split(" on ")[-1].strip()
        with _post(url + "/predict", {"inputs": {}}) as r:
            assert json.load(r)["who"] == "s0"
        assert cli.main(["fleetctl", "status", "--router", url]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert list(doc["router"]["replicas"].values())[0]["url"] == stubs[0].url
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
    for cmd in ("train", "quant", "tune"):
        with pytest.raises(NotImplementedError, match="A1[12]"):
            cli.main([cmd])
    with pytest.raises(NotImplementedError, match="A10"):
        cli.main(["serve", "--model_dir", "x", "--mesh", "dp2"])
