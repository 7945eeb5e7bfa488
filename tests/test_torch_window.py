"""The port's scan window (`Trainer.train(scan_window=K)`,
`Executor.run_window`, core/graph.py) against the JAX package's, on the CPU.

bench.py's train_loop model at hidden 32 (16 features, fc tanh, fc to 1,
square_error_cost, mean, SGD(0.01)) with a `pred_mean` metric, over 10
batches of 8 a pass: windows of 4, 4 and a ragged 2. On the CPU the port
runs each step of a window eagerly on the window's buffers, fetches and
accumulator (the card replays a captured step there instead).

- Against the JAX Trainer with the same scan_window, one numpy state (the
  JAX startup's) and feeds, checkpointing every 3 steps: per-step costs,
  EndPass metrics and parameters within 1e-6 relative (f32, the same
  arithmetic in another order, as tests/test_torch_trainer.py holds the
  per-step loop), equal events, dispatches and checkpoint steps; and a
  mid-pass window checkpoint written by either package resumed by the
  other, ending within 1e-6 of the uninterrupted run.
- Inside the port: a window ends on the per-step loop's bits (K of 1 and 4,
  a ragged tail, a feed signature changing mid-pass, a per-step run between
  windows); the StepGuard's cool-down runs windows of 1 and its rollback
  discards a poisoned window; checkpoints fall on window edges and hold
  their step's values; stop() and SIGTERM finish the window in flight;
  show_param_stats_period falls back to the per-step loop with a warning;
  the launch counters' bookkeeping over a capture and its replays, on a
  stub graph.

The JAX side compiles once per Trainer: the module fixture's run serves the
comparison and the JAX-written resume.
"""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import graph
from paddle_tpu_torch.data.feeder import DevicePrefetcher, FeedWindow
from paddle_tpu_torch.resilience import PreemptedError, StepGuard, faults

RTOL = 1e-6
K = 4
BATCH, N_BATCHES = 8, 10


def _build(m, lr=0.01):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 11
    with m.program_guard(prog, startup):
        x = m.layers.data("x", shape=[16])
        y = m.layers.data("y", shape=[1])
        h = m.layers.fc(x, size=32, act="tanh")
        pred = m.layers.fc(h, size=1)
        loss = m.layers.mean(m.layers.square_error_cost(pred, y))
        metrics = {"pred_mean": m.layers.mean(pred)}
        m.optimizer.SGD(learning_rate=lr).minimize(loss)
    return prog, startup, loss, metrics


def _batches(n=N_BATCHES, seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 1)
    out = []
    for _ in range(n):
        x = rng.randn(batch, 16).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.7).astype(np.float32)})
    return out


def _jax_trainer(ckpt=None, **cc):
    prog, startup, loss, metrics = _build(pt)
    cfg = pt.CheckpointConfig(ckpt, **cc) if ckpt else None
    return pt.Trainer(loss, main_program=prog, startup_program=startup,
                      checkpoint_config=cfg), prog, metrics


def _port_trainer(ckpt=None, step_guard=None, **cc):
    prog, startup, loss, metrics = _build(ptt)
    cfg = ptt.CheckpointConfig(ckpt, **cc) if ckpt else None
    t = ptt.Trainer(loss, main_program=prog, startup_program=startup, place="cpu",
                    scope=ptt.Scope(), checkpoint_config=cfg, step_guard=step_guard)
    return t, prog, metrics


def _set_state(t, state):
    t.init()
    tio.params_from_numpy(t.scope, state, "cpu")


def _run(t, metrics, data, num_passes=2, **kw):
    events = []
    out = t.train(lambda: iter(data), num_passes, event_handler=events.append,
                  fetch_metrics=metrics, **kw)
    return out, events


def _params(t, prog):
    get = (lambda n: np.asarray(pt.global_scope().get(n))) if isinstance(t, pt.Trainer) \
        else (lambda n: t.scope.get(n).numpy())
    return {p.name: np.array(get(p.name)) for p in prog.parameters()}


def _costs(events):
    return [float(e.cost) for e in events if type(e).__name__ == "EndIteration"]


def _event_ids(events):
    return [(type(e).__name__, e.pass_id, getattr(e, "batch_id", None), getattr(e, "step", None))
            for e in events]


def _close(got, want, rtol=RTOL):
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        assert float(np.abs(got[n] - want[n]).max()) <= rtol * scale, n


def _same_bits(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _serial_args(d):
    out = {}
    for s in tio._complete_serials(d):
        with open(os.path.join(tio._serial_dir(d, s), tio.META_FILE)) as f:
            out[s] = json.load(f)["trainer_args"]
    return out


CKPT = dict(step_interval=3, max_num_checkpoints=20)


@pytest.fixture(scope="module")
def jax_window(tmp_path_factory):
    """The JAX Trainer with scan_window=K over 2 passes, checkpointing on
    the window edges that cross a multiple of 3 steps, from its startup's
    state."""
    d = str(tmp_path_factory.mktemp("jax_window") / "ck")
    jt, jprog, jmetrics = _jax_trainer(d, **CKPT)
    jt.init()
    sc = pt.global_scope()
    state = {v.name: np.array(np.asarray(sc.get(v.name)))
             for v in jprog.persistables() if sc.has(v.name)}
    m, events = _run(jt, jmetrics, _batches(), log_interval=6, scan_window=K)
    return dict(state=state, metrics=m, events=events, costs=_costs(events),
                params=_params(jt, jprog), dispatches=jt.host_dispatch_count,
                syncs=jt.host_sync_count, ckpt=d)


def _port_window(state, d, **kw):
    t, prog, metrics = _port_trainer(d, **CKPT)
    _set_state(t, state)
    m, events = _run(t, metrics, _batches(), log_interval=6, scan_window=K, **kw)
    return t, prog, m, events


def test_window_equals_jax(jax_window, tmp_path):
    d = str(tmp_path / "ck")
    t, prog, m, events = _port_window(jax_window["state"], d)
    assert _event_ids(events) == _event_ids(jax_window["events"])
    np.testing.assert_allclose(_costs(events), jax_window["costs"], rtol=RTOL)
    assert sorted(m) == sorted(jax_window["metrics"]) == ["cost", "pred_mean"]
    for k, v in jax_window["metrics"].items():
        assert m[k] == pytest.approx(v, rel=RTOL)
    _close(_params(t, prog), jax_window["params"])
    assert t.host_dispatch_count == jax_window["dispatches"] == 2 * 3  # 4 + 4 + 2 a pass
    assert t.host_sync_count == jax_window["syncs"]
    steps = lambda args: [(a["step"], a.get("batch_id")) for _, a in sorted(args.items())]  # noqa
    assert steps(_serial_args(d)) == steps(_serial_args(jax_window["ckpt"]))
    # the window edges that cross 3, 6, 9, 12, 15 (and each pass's end)
    assert [a["step"] for _, a in sorted(_serial_args(d).items())] == [4, 8, 10, 10, 14, 18, 20]
    assert t.exe.cache_stats["misses"] == 1 and t.exe.cache_stats["eager_steps"] == 20


def _mid_pass_serial(d):
    for s, args in sorted(_serial_args(d).items()):
        if args.get("mid_pass") and args["pass_id"] == 1:
            return s, args
    raise AssertionError("no mid-pass checkpoint in pass 1")


def _keep_upto(src, dst, serial):
    shutil.copytree(src, dst)
    for s in tio._complete_serials(dst):
        if s > serial:
            shutil.rmtree(tio._serial_dir(dst, s))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_resume_from_a_mid_pass_window_checkpoint(jax_window, tmp_path, writer, reader):
    """Pass 1's first window checkpoint (step 14, batch 3) resumes in a
    fresh Trainer of either package, whose windows start at batch 4, and
    ends where the uninterrupted window run ends."""
    if writer == "jax":
        d = jax_window["ckpt"]
        port_full = None
    else:
        d = str(tmp_path / "ck")
        t, prog, _, _ = _port_window(jax_window["state"], d)
        port_full = _params(t, prog)
    serial, args = _mid_pass_serial(d)
    assert (args["step"], args["batch_id"]) == (14, 3)
    r = str(tmp_path / "resume")
    _keep_upto(d, r, serial)
    if reader == "jax":
        t, prog, metrics = _jax_trainer(r, **CKPT)
    else:
        t, prog, metrics = _port_trainer(r, **CKPT)
    t.init()
    assert (t.start_pass, t._resume_batch, t.step) == (1, 4, 14)
    _, events = _run(t, metrics, _batches(), log_interval=6, scan_window=K)
    assert [e.step for e in events if type(e).__name__ == "EndIteration"] == list(range(15, 21))
    got = _params(t, prog)
    _close(got, jax_window["params"])
    if port_full is not None:
        _close(got, port_full)
        if reader == "port":
            _same_bits(got, port_full)


# ------------------------------------------------- inside the port


def _port_run(data, state=None, num_passes=2, **kw):
    t, prog, metrics = _port_trainer()
    if state is not None:
        _set_state(t, state)
    m, events = _run(t, metrics, data, num_passes=num_passes, **kw)
    return t, _params(t, prog), m, events


@pytest.mark.parametrize("k", [1, 4])
def test_window_bits_equal_per_step(k, monkeypatch):
    """Windows of k (k=4 from FLAGS.scan_window) end on the per-step
    synchronous loop's bits: parameters, EndPass metrics, per-step costs;
    one dispatch a window and syncs only at window edges."""
    data = _batches()
    ts, ps, ms, es = _port_run(data, log_interval=1)
    if k == 4:
        monkeypatch.setattr(ptt.FLAGS, "scan_window", 4)
        tw, pw, mw, ew = _port_run(data, log_interval=100)
    else:
        tw, pw, mw, ew = _port_run(data, log_interval=100, scan_window=k)
    _same_bits(pw, ps)
    assert mw == ms
    assert _costs(ew) == _costs(es)
    assert _event_ids(ew) == _event_ids(es) if k == 1 else len(ew) == len(es)
    assert tw.host_dispatch_count == (2 * N_BATCHES if k == 1 else 2 * 3)
    assert tw.host_sync_count == 2 + 2 * N_BATCHES  # a pass end each, and the cost reads


def test_ragged_tail_and_signature_change():
    """A pass of 5 batches of 8 rows, then 3 of 4: the prefetcher's windows
    of 4 flush at the signature change ([4, 1, 3]); two keys, each warmed
    once; the per-step loop's bits."""
    data = _batches(5) + _batches(3, seed=1, batch=4)
    wins = list(DevicePrefetcher(lambda: iter(data), device="cpu", window=K))
    assert all(isinstance(w, FeedWindow) for w in wins)
    assert [w.k for w in wins] == [4, 1, 3]
    assert wins[0].feed["x"].shape == (4, 8, 16) and wins[2].feed["x"].shape == (3, 4, 16)
    np.testing.assert_array_equal(wins[0].slice(2)["x"].numpy(), data[2]["x"][None])
    _, ps, ms, _ = _port_run(data, log_interval=1)
    tw, pw, mw, _ = _port_run(data, log_interval=100, scan_window=K)
    _same_bits(pw, ps)
    assert mw == ms
    assert tw.host_dispatch_count == 2 * 3
    assert (tw.exe.cache_stats["misses"], len(tw.exe._windows)) == (2, 2)


def test_lod_feeds_stack_leaf_by_leaf():
    lod = lambda n, s: ptt.LoDArray.from_sequences(  # noqa: E731
        [np.arange(s, s + n, dtype=np.int32), np.arange(2, dtype=np.int32)], bucket=8)
    feeds = [{"w": lod(3, 0), "x": np.full((2, 3), 1.0, np.float32)},
             {"w": lod(5, 10), "x": np.full((2, 3), 2.0, np.float32)}]
    (win,) = list(DevicePrefetcher(lambda: iter(feeds), device="cpu", window=K))
    w = win.feed["w"]
    assert win.k == 2
    assert [tuple(t.shape) for t in w.leaves()] == [(2, 8), (2, 8), (2, 2), (2,)]
    one = win.slice(1)["w"]
    for got, want in zip(one.leaves(), feeds[1]["w"].leaves()):
        np.testing.assert_array_equal(got[0].numpy(), want.numpy())
    assert one.data.shape == (1, 8)


def test_per_step_run_between_windows():
    """The scope identity: an Executor.run between two windows replaces
    scope entries, which the next window copies into its buffers."""
    data = _batches(5)
    _, ps, _, _ = _port_run(data, num_passes=1, log_interval=1)
    t, prog, _ = _port_trainer()
    t.init()
    exe, loss = t.exe, t.cost
    stack = lambda ds: {k: np.stack([d[k] for d in ds]) for k in ds[0]}  # noqa: E731
    exe.run_window(prog, stack(data[:2]), [loss], scope=t.scope)
    bufs = {n: t.scope.get(n) for n in ps}
    exe.run(prog, data[2], [loss], scope=t.scope)
    assert all(t.scope.get(n) is not bufs[n] for n in ps)
    ys, _ = exe.run_window(prog, stack(data[3:]), [loss], scope=t.scope)
    assert all(t.scope.get(n) is bufs[n] for n in ps) and ys[0].shape == (2,)
    _same_bits(_params(t, prog), ps)


def test_run_window_rejects_bad_feeds():
    t, prog, _ = _port_trainer()
    t.init()
    with pytest.raises(ValueError, match="feed"):
        t.exe.run_window(prog, {}, [t.cost], scope=t.scope)
    with pytest.raises(ValueError, match="cost"):
        t.exe.run_window(prog, {"x": np.zeros((2, 8, 16), np.float32)}, [], scope=t.scope,
                         acc_state=(0, 0, [], 0))
    with pytest.raises(ValueError, match="leading"):
        t.exe.run_window(prog, {"x": np.zeros((2, 8, 16), np.float32),
                                "y": np.zeros((3, 8, 1), np.float32)}, [t.cost], scope=t.scope)


def _guard_run(tmp_path, hit, cooldown=2):
    d = str(tmp_path / "ck")
    guard = StepGuard(max_consecutive=1, cooldown_steps=cooldown, lr_factor=0.5)
    t, prog, metrics = _port_trainer(d, step_guard=guard, epoch_interval=0, step_interval=4,
                                     max_num_checkpoints=100)
    ks, orig = [], t.exe.run_window

    def run_window(program, feed, *a, **kw):
        ks.append(int(next(iter(feed.values())).shape[0]))
        return orig(program, feed, *a, **kw)

    t.exe.run_window = run_window
    rolled = []

    def watch(e):
        if type(e).__name__ == "EndIteration" and guard.rollbacks:
            rolled.append(e.step)

    faults.reset()
    faults.arm("executor.step", hit=hit, action="corrupt")
    try:
        m = t.train(lambda: iter(_batches(12)), 1, event_handler=watch, fetch_metrics=metrics,
                    log_interval=4, scan_window=K)
        fired = faults.stats()["executor.step"]["fired"]
    finally:
        faults.reset()
    return d, t, prog, m, guard, fired, ks, rolled


def test_step_guard_degrades_to_windows_of_one_and_rolls_back(tmp_path):
    """A NaN in step 6 (window 5-8): the window's edge sync sees it, the
    guard rolls back to the step-4 checkpoint (the whole window
    discarded), and its cool-down runs the next window as windows of 1."""
    d, t, prog, m, guard, fired, ks, rolled = _guard_run(tmp_path, hit=6)
    assert fired == 1
    st = guard.stats()
    assert st["skipped"] >= 1 and st["rollbacks"] >= 1, st
    assert rolled and min(rolled) <= 9, rolled
    assert t.step == 8  # 12 batches consumed, the poisoned window's 4 steps discarded
    assert ks == [4, 4, 1, 1, 1, 1], ks  # the cool-down's window as four windows of 1
    assert np.isfinite(m["cost"])
    for n, w in _params(t, prog).items():
        assert np.isfinite(w).all(), n
    for s in tio._complete_serials(d):  # nothing poisoned was checkpointed
        sc = ptt.Scope()
        tio.load_vars(tio._serial_dir(d, s), sc, device="cpu")
        for n in sc.keys():
            assert torch.isfinite(sc.get(n)).all(), (s, n)


def test_step_guard_armed_clean_run_bits(tmp_path):
    data = _batches(8)
    ts, prog, _ = _port_trainer(str(tmp_path / "a"), step_guard=StepGuard())
    _run(ts, None, data, log_interval=1)
    tw, _, _ = _port_trainer(str(tmp_path / "b"), step_guard=StepGuard())
    _run(tw, None, data, log_interval=4, scan_window=K)
    _same_bits(_params(tw, prog), _params(ts, prog))


def test_checkpoints_on_window_edges_hold_their_steps(tmp_path):
    """step_interval=3 with windows of 4: one save a window that crosses a
    multiple of 3, at its edge (steps 4 and 8), each holding that step's
    values although the next window writes the same buffers again."""
    d = str(tmp_path / "ck")
    t, prog, metrics = _port_trainer(d, epoch_interval=0, step_interval=3,
                                     max_num_checkpoints=100)
    snaps = {}

    def grab(e):
        if type(e).__name__ == "EndIteration" and e.step % 4 == 0:
            snaps[e.step] = {p.name: t.scope.get(p.name).numpy().copy()
                             for p in prog.parameters()}

    t.train(lambda: iter(_batches(8)), 1, event_handler=grab, log_interval=16, scan_window=K)
    args = _serial_args(d)
    assert [a["step"] for _, a in sorted(args.items())] == [4, 8]
    for s, a in args.items():
        sd = tio._serial_dir(d, s)
        tio.verify_checkpoint(sd)
        sc = ptt.Scope()
        tio.load_vars(sd, sc, device="cpu")
        for n, want in snaps[a["step"]].items():
            np.testing.assert_array_equal(sc.get(n).numpy(), want)


@pytest.mark.parametrize("how", ["stop", "sigterm"])
def test_stop_finishes_the_window_in_flight(tmp_path, how):
    """stop() or SIGTERM at batch 5's BeginIteration (window 4-7 being
    assembled): the window runs to its end, the emergency checkpoint lands
    on its edge (step 8, batch 7), and a resume re-enters at batch 8."""
    d = str(tmp_path / "ck")
    t, prog, metrics = _port_trainer(d, epoch_interval=0, step_interval=0)

    def handler(e):
        if type(e).__name__ == "BeginIteration" and e.batch_id == 5:
            if how == "stop":
                t.stop()
            else:
                os.kill(os.getpid(), signal.SIGTERM)

    data = _batches(12)
    if how == "stop":
        t.train(lambda: iter(data), 2, event_handler=handler, log_interval=16, scan_window=K)
    else:
        with pytest.raises(PreemptedError):
            t.train(lambda: iter(data), 2, event_handler=handler, log_interval=16,
                    scan_window=K)
    assert t.step == 8
    (args,) = _serial_args(d).values()
    assert (args["step"], args["mid_pass"], args["batch_id"]) == (8, True, 7)
    t2, _, _ = _port_trainer(d, epoch_interval=0, step_interval=0)
    t2.init()
    assert (t2.step, t2._resume_batch, t2.start_pass) == (8, 8, 0)
    _same_bits(_params(t2, prog), _params(t, prog))


def test_param_stats_fall_back_to_the_per_step_loop(monkeypatch, caplog):
    monkeypatch.setattr(ptt.FLAGS, "show_param_stats_period", 100)
    t, prog, metrics = _port_trainer()
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        _run(t, metrics, _batches(6), num_passes=1, log_interval=100, scan_window=K)
    assert any("scan_window disabled" in r.getMessage() for r in caplog.records)
    assert t.host_dispatch_count == 6 and not t.exe._windows


def test_launch_counter_bookkeeping_on_a_stub(monkeypatch):
    """A step whose stub kernels bump the launch counters: the warm-up step
    counts once, the capture's counts are taken back, and every replay
    adds one step's counts, a dict-valued counter by route too; a failed
    capture leaves the counters as they were and names the op."""
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import lstm_kernels as lk

    monkeypatch.setattr(lk, "lstm_fwd_launches", 0)
    monkeypatch.setattr(ak, "attn_fwd_paths", {k: 0 for k in ak.attn_fwd_paths})
    path = next(iter(ak.attn_fwd_paths))

    def body():
        lk.lstm_fwd_launches += 2
        ak.attn_fwd_paths[path] += 50

    class StubGraph:
        replays = 0

        def replay(self):
            StubGraph.replays += 1

    def record():
        body()  # a capture runs the Python once, the card nothing
        return StubGraph()

    t, prog, _ = _port_trainer()
    sg = graph._StepGraph(t.exe, prog, [], False, False)
    sg.cuda = True
    sg._on_stream = lambda fn: fn()
    sg._body = body
    sg._record = record
    for _ in range(5):  # warm-up, capture + replay, 3 replays
        sg.step()
    assert StubGraph.replays == 4 and t.exe.cache_stats["captures"] == 1
    assert lk.lstm_fwd_launches == 5 * 2 and ak.attn_fwd_paths[path] == 5 * 50
    assert sg.delta == {("paddle_tpu_torch.ops.lstm_kernels", "lstm_fwd_launches"): 2,
                        ("paddle_tpu_torch.ops.attention_kernels", "attn_fwd_paths"):
                        {path: 50}}

    def broken():
        body()
        raise RuntimeError("while executing op #3 'stacked_lstm2'")

    sg2 = graph._StepGraph(t.exe, prog, [], False, False)
    sg2.cuda, sg2.warm = True, True
    sg2._record = broken
    with pytest.raises(RuntimeError, match="capturing the training step.*stacked_lstm2"):
        sg2.step()
    assert lk.lstm_fwd_launches == 10 and ak.attn_fwd_paths[path] == 250
    assert sg2.graph is None


def test_traced_window_one_span_a_window():
    """Traced, a window is one forwardBackward span carrying its window
    context (the first batch, its k); the prefetcher stacks each window in
    a prefetch.window span on its own thread."""
    from paddle_tpu_torch.obs import trace as ttrace

    t, prog, metrics = _port_trainer()
    tr = ttrace.arm()
    try:
        _run(t, metrics, _batches(), num_passes=1, log_interval=100, scan_window=K)
        doc = tr.to_chrome()
    finally:
        ttrace.disarm(export=False)
    assert not ttrace.validate_chrome_trace(doc)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    fb = [e for e in spans if e["name"] == "forwardBackward"]
    assert [(e["args"]["window"], e["args"]["k"], e["args"]["step"]) for e in fb] == \
        [(0, 4, 1), (4, 4, 5), (8, 2, 9)]
    stacks = [e for e in spans if e["name"] == "prefetch.window"]
    assert len(stacks) == 3 and {e["tid"] for e in stacks} != {e["tid"] for e in fb}
