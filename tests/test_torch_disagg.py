"""Disaggregated serving in the port (serving/disagg, the scheduler's prefill
and submit_handoff, the server's /prefill and /admit) on the CPU.

The contract: the PTHO1 payload is the JAX package's byte for byte (f32,
bf16 and int8-packed state), each package unpacks the other's, and both
refuse the same malformed or mismatched payloads. In the port, prefill ->
pack -> unpack -> submit_handoff equals monolithic decoding bit for bit
(int8: within the per-row quantization bound); a payload prefilled by
the JAX scheduler and admitted by the port's decodes to the JAX package's
monolithic ids. /prefill and /admit over two in-process servers, and the
DisaggDispatcher over simulated replicas, complete the path.
"""

import json
import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.serving.disagg import handoff as jhandoff
from paddle_tpu_torch.fleetctl.sim import SimReplica
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import promparse
from paddle_tpu_torch.serving import (BucketPolicy, ContinuousScheduler, ModelRegistry,
                                      ServingEngine, make_server)
from paddle_tpu_torch.serving.disagg import DisaggDispatcher, handoff
from paddle_tpu_torch.serving.router import Router, make_router_server
from test_torch_spec_decode import H, _jax_dir

SCORE_TOL = 1e-5
WAIT_MS = 60000


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    return _jax_dir(str(tmp_path_factory.mktemp("disagg") / "gen"), seed=3)


def _engine(d, name):
    return ServingEngine(d, policy=BucketPolicy(max_batch_size=8), model_name=name,
                         device="cpu")


def _feeds(seed=0):
    rng = np.random.RandomState(seed)
    return [{"h0": rng.randn(n, H).astype(np.float32)} for n in (1, 3, 2)]


SCHEMA = {"schema_version": 1, "state_fingerprint": "fp-test"}


def _state(kind):
    """(port boots, port pes, JAX boots, JAX pes, quant) for one payload
    kind, the same values on both sides."""
    rng = np.random.RandomState(4)
    f32 = rng.randn(3, 2, 5).astype(np.float32) * 3
    ids = rng.randint(0, 50, (3, 4)).astype(np.int32)
    pe = rng.randn(3, 7).astype(np.float32)
    pe[1] = 0.0  # an all-zero row: the 1e-30 scale floor
    if kind.endswith("bf16"):
        t = torch.from_numpy(f32).to(torch.bfloat16)
        port_b, jax_b = (t, ids), (f32.astype(ml_dtypes.bfloat16), ids)
    else:
        port_b, jax_b = (torch.from_numpy(f32), ids), (f32, ids)
    quant = "int8" if kind.startswith("int8") else None
    return port_b, (pe,), jax_b, (pe,), quant


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int8_bf16"])
def test_payload_bytes_equal_and_cross_unpack(kind):
    pb, pp, jb, jp, quant = _state(kind)
    mine = handoff.pack_handoff(pb, pp, SCHEMA, "m", request_id="r1", quant=quant)
    theirs = jhandoff.pack_handoff(jb, jp, SCHEMA, "m", request_id="r1", quant=quant)
    assert mine == theirs
    if quant is None:
        assert len(mine) > len(handoff.pack_handoff(pb, pp, SCHEMA, "m", quant="int8"))
    # each package unpacks the other's bytes to the same values
    h1, b1, p1 = handoff.unpack_handoff(theirs)
    h2, b2, p2 = jhandoff.unpack_handoff(mine)
    assert h1 == h2
    for t, a in zip(b1 + p1, b2 + p2):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    assert b1[0].dtype == (torch.bfloat16 if kind.endswith("bf16") else torch.float32)
    assert b1[1].dtype == torch.int32


def _tamper(kind):
    good = handoff.pack_handoff(*_state("f32")[:2], SCHEMA, "m")
    return {"magic": b"XXXXX" + good[5:], "trailing": good + b"\0",
            "truncated": good[:-3], "header": good[:9] + b"x" + good[10:]}[kind]


@pytest.mark.parametrize("kind", ["magic", "trailing", "truncated", "header"])
def test_malformed_payloads_refused_alike(kind):
    data = _tamper(kind)
    with pytest.raises(handoff.HandoffError):
        handoff.unpack_handoff(data)
    with pytest.raises(jhandoff.HandoffError):
        jhandoff.unpack_handoff(data)


@pytest.mark.parametrize("field", ["schema_version", "state_fingerprint"])
def test_schema_mismatch_refused_alike(gen_dir, field):
    eng = _engine(gen_dir, f"schema_{field}")
    jeng = jserving.ServingEngine(gen_dir, model_name=f"jschema_{field}")
    mine = handoff.payload_schema(eng.generation_meta)
    assert mine == jhandoff.payload_schema(jeng.generation_meta)
    header = dict(mine, **{field: 99 if field == "schema_version" else "other"})
    with pytest.raises(handoff.HandoffSchemaError, match="fleetctl rollout"):
        handoff.validate_handoff(header, eng.generation_meta)
    with pytest.raises(jhandoff.HandoffSchemaError, match="fleetctl rollout"):
        jhandoff.validate_handoff(header, jeng.generation_meta)
    handoff.validate_handoff(dict(mine), eng.generation_meta)
    with pytest.raises(handoff.HandoffError, match="only 'int8'"):
        handoff.pack_handoff(*_state("f32")[:2], SCHEMA, "m", quant="int4")


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_handoff_equals_monolithic(gen_dir, quant):
    """prefill -> pack -> unpack -> submit_handoff on another scheduler:
    monolithic decoding's bits. int8: each float state within half a step
    of its row's scale of the exact state, and a decode of the right
    geometry (on this random tiny model a near tie may flip a beam)."""
    mono = ContinuousScheduler(_engine(gen_dir, f"mono_{quant}"), max_slots=4).start()
    pf = ContinuousScheduler(_engine(gen_dir, f"prefill_{quant}"), max_slots=4)
    de_eng = _engine(gen_dir, f"decode_{quant}")
    de = ContinuousScheduler(de_eng, max_slots=4).start()
    schema = handoff.payload_schema(de_eng.generation_meta)
    try:
        for feed in _feeds():
            want = mono.generate(feed, timeout_ms=WAIT_MS)
            boots, pes = pf.prefill(feed)
            assert all(t.device.type == "cpu" and t.shape[0] == feed["h0"].shape[0]
                       for t in boots + pes)
            header, b, p = handoff.unpack_handoff(
                handoff.pack_handoff(boots, pes, schema, "m", quant=quant))
            handoff.validate_handoff(header, de_eng.generation_meta)
            got = de.submit_handoff(b, p, timeout_ms=WAIT_MS).result(timeout=WAIT_MS / 1e3)
            if quant is None:
                for k in ("ids", "scores", "lengths"):
                    np.testing.assert_array_equal(got[k], want[k])
                continue
            for orig, deq in zip(boots + pes, b + p):
                o, q = orig.float().numpy(), deq.float().numpy()
                scale = np.abs(o.reshape(len(o), -1)).max(axis=1) / 127.0
                assert np.all(np.abs(q - o) <= 0.5 * scale.reshape((-1,) + (1,) * (o.ndim - 1))
                              + 1e-6)
            assert got["ids"].shape == want["ids"].shape and np.all(got["lengths"] >= 1)
        assert pf.prefills_total == 3 and pf.syncs_total == 3 and pf._state is None
        assert de.handoffs_admitted_total == 3
    finally:
        mono.stop()
        de.stop()


def test_jax_prefill_admitted_by_the_port(gen_dir):
    """A payload the JAX scheduler prefilled and packed, admitted by the
    port's: the JAX package's monolithic ids."""
    jeng = jserving.ServingEngine(gen_dir, policy=jserving.BucketPolicy(max_batch_size=8),
                                  model_name="jax_prefill")
    jsched = jeng.scheduler(max_slots=4)
    de_eng = _engine(gen_dir, "port_admit")
    de = ContinuousScheduler(de_eng, max_slots=4).start()
    try:
        for feed in _feeds(seed=1):
            want = jsched.generate(feed, timeout_ms=120000)
            boots, pes = jsched.prefill(feed)
            data = jhandoff.pack_handoff(boots, pes, jhandoff.payload_schema(jeng.generation_meta),
                                         "default")
            header, b, p = handoff.unpack_handoff(data)
            handoff.validate_handoff(header, de_eng.generation_meta)
            got = de.submit_handoff(b, p, timeout_ms=WAIT_MS).result(timeout=WAIT_MS / 1e3)
            np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
            np.testing.assert_array_equal(got["lengths"], np.asarray(want["lengths"]))
            np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), atol=SCORE_TOL)
    finally:
        jsched.stop()
        de.stop()


def test_submit_handoff_refuses_a_draft(gen_dir):
    sched = ContinuousScheduler(_engine(gen_dir, "handoff_draft"), draft_model=gen_dir)
    with pytest.raises(ValueError, match="draft-model state"):
        sched.submit_handoff((np.zeros((1, H), np.float32),), ())


def _post(url, body, headers=None, timeout=60):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {
        "Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


@pytest.fixture(scope="module")
def http_pair(gen_dir):
    """A prefill server and a decode server, each with its own registry."""
    servers = []
    for name in ("pf", "de"):
        reg = ModelRegistry()
        reg.add("default", model_dir=gen_dir, device="cpu",
                policy=BucketPolicy(max_batch_size=8), scheduler_kw={"max_slots": 4})
        srv = make_server(reg)
        srv.serve_background()
        servers.append((reg, srv, f"http://127.0.0.1:{srv.port}"))
    yield servers
    for reg, srv, _ in servers:
        srv.shutdown()
        reg.stop()
        srv.server_close()


def test_http_prefill_admit(http_pair, gen_dir):
    """/prefill on one server, /admit of its bytes on the other, buffered
    and streamed: the monolithic bits; a payload of another schema is a
    409."""
    (_, _, pf_url), (de_reg, _, de_url) = http_pair
    feed = _feeds(seed=2)[1]
    eng = de_reg.get("default")[0]
    want = eng.generate(feed, timeout_ms=WAIT_MS)
    with _post(pf_url + "/prefill", {"inputs": {"h0": feed["h0"].tolist()}}) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        payload = r.read()
    assert payload.startswith(handoff.MAGIC)
    with _post(de_url + "/admit", payload,
               {"Content-Type": "application/octet-stream"}) as r:
        out = json.load(r)["outputs"]
    np.testing.assert_array_equal(np.asarray(out["ids"]), want["ids"])
    np.testing.assert_array_equal(np.asarray(out["scores"], np.float32), want["scores"])
    with _post(de_url + "/admit/default?stream=1&timeout_ms=60000", payload,
               {"Content-Type": "application/octet-stream"}) as r:
        events = [json.loads(line) for line in r if line.strip()]
    assert events[-1]["event"] == "done"
    assert sum(e["event"] == "token" for e in events) > 0
    np.testing.assert_array_equal(np.asarray(events[-1]["outputs"]["ids"]), want["ids"])
    # another decode-state schema: a 409 naming the rollout
    header, b, p = handoff.unpack_handoff(payload)
    bad = handoff.pack_handoff(b, p, {"schema_version": header["schema_version"],
                                      "state_fingerprint": "another"}, "default")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(de_url + "/admit", bad, {"Content-Type": "application/octet-stream"})
    assert ei.value.code == 409
    assert json.load(ei.value)["kind"] == "HandoffSchemaError"
    ei.value.close()
    st = de_reg.stats()["default"]["generation"]
    assert st["handoffs_admitted_total"] == 2


def _wait_until(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_dispatcher_over_sim_replicas():
    """/generate through a router with the DisaggDispatcher: prefill on the
    prefill sim, the payload shipped, decode admitted, buffered and
    streamed; the pt_handoff_* families on the router's registry; a decode
    replica's death re-ships the same payload to its sibling."""
    reg = obs_metrics.MetricsRegistry()
    router = Router(probe_interval_s=0.05, registry=reg).start()
    pf, de0, de1 = (SimReplica(fingerprint="fp-v1") for _ in range(3))
    router.add_replica(pf.url, name="pf0", phase="prefill")
    router.add_replica(de0.url, name="de0", phase="decode")
    router.add_replica(de1.url, name="de1", phase="decode")
    _wait_until(lambda: all(r.up for r in router.replicas()), msg="sims up")
    server = make_router_server(router, disagg=DisaggDispatcher(router))
    server.serve_background()
    url = f"http://127.0.0.1:{server.port}"
    try:
        with _post(url + "/generate", {"sim_prefill_ms": 5, "sim_decode_ms": 5,
                                       "tokens": 3}) as r:
            assert json.load(r)["outputs"]["ids"] == [[3]]
        with _post(url + "/generate", {"stream": True, "tokens": 4, "sim_decode_ms": 10,
                                       "timeout_ms": 30000}) as r:
            kinds = [json.loads(line)["event"] for line in r if line.strip()]
        assert kinds.count("token") == 4 and kinds[-1] == "done"
        assert pf.prefills_total == 2
        assert de0.handoffs_admitted_total + de1.handoffs_admitted_total == 2
        de0.kill()
        for _ in range(2):
            with _post(url + "/generate", {"tokens": 2}) as r:
                assert r.status == 200
        assert pf.prefills_total == 4
        render = reg.render()
        fams = promparse.parse_text(render)
        assert fams["pt_handoff_total"].samples[0][2] == 4.0
        assert fams["pt_handoff_bytes_total"].samples[0][2] > 0
        assert "pt_handoff_seconds_bucket" in render
        assert fams["pt_disagg_reprefills_total"].samples[0][2] == 0.0
    finally:
        server.shutdown()
        server.server_close()
        router.close()
        for s in (pf, de0, de1):
            s.kill()

