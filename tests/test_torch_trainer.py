"""The port's Trainer (`paddle_tpu_torch/trainer.py`) and checkpoints
(`io.save_checkpoint`/`load_checkpoint`) against the JAX package's, on the
CPU.

Two programs, each built by both front ends with equal dicts:
tests/test_io_trainer.py's `_build_regression` (fc to 1 output,
square_error_cost, mean) and bench.py's train_loop model (`run_train_loop`,
bench.py:910-1070: 16 features, fc tanh, fc to 1, square_error_cost, mean,
SGD(0.01)) at hidden 32. Both packages' Trainers train them from one numpy
state (the JAX startup's) for 2 passes. Per-step costs, EndPass metrics
(the test program's among them) and final parameters agree within 1e-6
relative (f32; the same f32 arithmetic in another order: measured to
1e-7), and the event sequences, with their pass, batch and step ids, are
equal.

Inside the port, what tests/test_async_trainer.py:84-263 proves of the JAX
Trainer: sync and async cadences give bit-identical parameters and
metrics with fewer syncs; the lazy cost defers its sync; the StepGuard
catches a NaN injected through `faults` within the cadence and never
checkpoints poison; the background writer surfaces failures; its
snapshot holds its step's values. Checkpoints: rotation, mid-pass resume
equal to the uninterrupted run, a corrupt serial quarantined, the JAX
package's checkpoints resuming in the port and the port's in the JAX
package (within 1e-6 of the other package's uninterrupted run), and
SIGTERM's emergency checkpoint with PreemptedError.
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
from paddle_tpu import io as jio
from paddle_tpu.resilience import PreemptedError as JaxPreempted
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.resilience import PreemptedError, StepGuard, faults
from paddle_tpu_torch.trainer import _CheckpointWriter

RTOL = 1e-6
BATCH, N_BATCHES = 8, 4


def _model(m, which):
    if which == "regression":  # tests/test_io_trainer.py:15
        x = m.layers.data("x", shape=[4])
        y = m.layers.data("y", shape=[1])
        pred = m.layers.fc(x, size=1)
    else:  # bench.py run_train_loop, hidden 32
        x = m.layers.data("x", shape=[16])
        y = m.layers.data("y", shape=[1])
        h = m.layers.fc(x, size=32, act="tanh")
        pred = m.layers.fc(h, size=1)
    loss = m.layers.mean(m.layers.square_error_cost(pred, y))
    return [x, y], loss, {"pred_mean": m.layers.mean(pred)}


def _build(m, which, lr=0.01):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 11
    with m.program_guard(prog, startup):
        feeds, loss, metrics = _model(m, which)
        m.optimizer.SGD(learning_rate=lr).minimize(loss)
    return prog, startup, feeds, loss, metrics


def _data(which, seed=0):
    rng = np.random.RandomState(seed)
    dim = 4 if which == "regression" else 16
    xs = rng.randn(N_BATCHES * BATCH, dim).astype(np.float32)
    ys = (xs @ rng.randn(dim, 1) + 0.7).astype(np.float32)
    return xs, ys


def _reader(which):
    """regression: batches of (x, y) samples through a DataFeeder;
    train_loop: ready feed dicts, as bench.py's reader."""
    xs, ys = _data(which)
    if which == "regression":
        samples = list(zip(xs, ys))
        return ptt.data.batch(lambda: iter(samples), BATCH), True

    def reader():
        for i in range(N_BATCHES):
            yield {"x": xs[i * BATCH:(i + 1) * BATCH], "y": ys[i * BATCH:(i + 1) * BATCH]}
    return reader, False


def _jax_trainer(which, ckpt=None, **cc):
    prog, startup, feeds, loss, metrics = _build(pt, which)
    cfg = pt.CheckpointConfig(ckpt, **cc) if ckpt else None
    return pt.Trainer(loss, main_program=prog, startup_program=startup,
                      checkpoint_config=cfg), prog, feeds, metrics


def _port_trainer(which, ckpt=None, step_guard=None, **cc):
    prog, startup, feeds, loss, metrics = _build(ptt, which)
    cfg = ptt.CheckpointConfig(ckpt, **cc) if ckpt else None
    t = ptt.Trainer(loss, main_program=prog, startup_program=startup, place="cpu",
                    scope=ptt.Scope(), checkpoint_config=cfg, step_guard=step_guard)
    return t, prog, feeds, metrics


def _jax_state(trainer):
    trainer.init()
    sc = pt.global_scope()
    return {v.name: np.array(np.asarray(sc.get(v.name)))
            for v in trainer.main_program.persistables() if sc.has(v.name)}


def _set_state(t, state):
    t.init()
    tio.params_from_numpy(t.scope, state, "cpu")


def _run(t, which, feeds, metrics, num_passes=2, **kw):
    reader, use_feeder = _reader(which)
    events = []
    out = t.train(reader, num_passes, feed_order=feeds if use_feeder else None,
                  event_handler=events.append, fetch_metrics=metrics, **kw)
    return out, events


def _params(t, prog):
    get = (lambda n: np.asarray(pt.global_scope().get(n))) if isinstance(t, pt.Trainer) \
        else (lambda n: t.scope.get(n).numpy())
    return {p.name: np.array(get(p.name)) for p in prog.parameters()}


def _event_ids(events):
    return [(type(e).__name__, e.pass_id, getattr(e, "batch_id", None), getattr(e, "step", None))
            for e in events]


def _close(got, want, rtol=RTOL):
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        assert float(np.abs(got[n] - want[n]).max()) <= rtol * scale, n


@pytest.mark.parametrize("which", ["regression", "train_loop"])
def test_programs_equal_jax(which):
    assert _build(ptt, which)[0].to_dict() == _build(pt, which)[0].to_dict()


@pytest.mark.parametrize("log_interval", [1, 3])
@pytest.mark.parametrize("which", ["regression", "train_loop"])
def test_trainer_equals_jax(which, log_interval):
    """Training, and each pass's evaluation over the test program
    (`Trainer.test`, the test_ metrics of EndPass)."""
    jt, jprog, jfeeds, jmetrics = _jax_trainer(which)
    state = _jax_state(jt)
    test_reader = _reader(which)[0]
    jm, jev = _run(jt, which, jfeeds, jmetrics, log_interval=log_interval,
                   test_reader=test_reader)
    jparams = _params(jt, jprog)
    tt, tprog, tfeeds, tmetrics = _port_trainer(which)
    _set_state(tt, state)
    tm, tev = _run(tt, which, tfeeds, tmetrics, log_interval=log_interval,
                   test_reader=test_reader)
    assert _event_ids(tev) == _event_ids(jev)
    jc = [float(e.cost) for e in jev if isinstance(e, pt.EndIteration)]
    tc = [float(e.cost) for e in tev if isinstance(e, ptt.EndIteration)]
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    assert sorted(tm) == sorted(jm) == ["cost", "pred_mean", "test_cost", "test_pred_mean"]
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=RTOL)
    _close(_params(tt, tprog), jparams)
    assert tt.host_dispatch_count == jt.host_dispatch_count == 2 * N_BATCHES
    assert tt.host_sync_count == jt.host_sync_count


# ------------------------------------------------- inside the port


def test_sync_async_bit_identical_and_fewer_syncs():
    state = _jax_state(_jax_trainer("train_loop")[0])
    runs = {}
    for mode, interval in (("sync", 1), ("async", 100)):
        t, prog, feeds, metrics = _port_trainer("train_loop")
        _set_state(t, state)
        m, _ = _run(t, "train_loop", feeds, metrics, log_interval=interval)
        runs[mode] = (m, _params(t, prog), t.host_sync_count)
    (ms, ps, ns), (ma, pa, na) = runs["sync"], runs["async"]
    assert ms == ma
    for n in ps:
        np.testing.assert_array_equal(ps[n], pa[n])
    assert na < ns and na == 2  # one accumulator read a pass


def test_lazy_cost_defers_the_sync():
    t, prog, feeds, metrics = _port_trainer("train_loop")
    t.init()
    _, events = _run(t, "train_loop", feeds, metrics, num_passes=1, log_interval=64)
    assert t.host_sync_count == 1  # the pass-end read only
    e = [e for e in events if isinstance(e, ptt.EndIteration)][2]
    assert repr(e.cost) == "<lazy device scalar (unread)>"
    assert np.isfinite(e.cost) and f"{e.cost:.4g}" and e.cost + 0.0 >= 0.0
    assert float(e.metrics["pred_mean"]) == float(e.metrics["pred_mean"])
    assert t.host_sync_count == 3  # each read was one sync
    t2, _, _, _ = _port_trainer("train_loop")
    _, events = _run(t2, "train_loop", feeds, metrics, num_passes=1, log_interval=1)
    assert all(isinstance(e.cost, float) for e in events if isinstance(e, ptt.EndIteration))


def _guard_run(tmp_path, hit, interval=4, n_batches=12):
    d = str(tmp_path / "ck")
    rng = np.random.RandomState(5)
    data = [{"x": rng.randn(8, 16).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)} for _ in range(n_batches)]
    guard = StepGuard(max_consecutive=1, cooldown_steps=2, lr_factor=0.5)
    t, prog, feeds, metrics = _port_trainer("train_loop", ckpt=d, step_guard=guard,
                                            epoch_interval=0, step_interval=2,
                                            max_num_checkpoints=100)
    faults.reset()
    faults.arm("executor.step", hit=hit, action="corrupt")
    try:
        m = t.train(lambda: iter(data), 1, log_interval=interval)
        fired = faults.stats()["executor.step"]["fired"]
    finally:
        faults.reset()
    return d, t, prog, m, guard, fired


def test_step_guard_catches_injected_nan_within_cadence(tmp_path):
    _, t, prog, m, guard, fired = _guard_run(tmp_path, hit=5)
    assert fired == 1
    st = guard.stats()
    assert st["skipped"] >= 1 and st["rollbacks"] >= 1, st
    assert np.isfinite(m["cost"])
    for n, w in _params(t, prog).items():
        assert np.isfinite(w).all(), n


def test_step_guard_never_checkpoints_poison(tmp_path):
    d, _, _, _, _, fired = _guard_run(tmp_path, hit=4, interval=3, n_batches=10)
    assert fired == 1
    serials = tio._complete_serials(d)
    assert serials
    for s in serials:
        sc = ptt.Scope()
        tio.load_vars(tio._serial_dir(d, s), sc, device="cpu")
        for n in sc.keys():
            assert torch.isfinite(sc.get(n)).all(), (s, n)


def test_background_writer_surfaces_failures():
    w = _CheckpointWriter()
    w.submit(lambda: None)
    w.drain()

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        w.drain()
    w.submit(lambda: None)  # a drained failure is consumed
    w.drain()
    assert (w.commits, w.failures) == (2, 1)


def test_background_snapshot_is_the_steps(tmp_path):
    d = str(tmp_path / "ck")
    t, prog, feeds, metrics = _port_trainer("train_loop", ckpt=d, epoch_interval=0,
                                            step_interval=2, max_num_checkpoints=100)
    snaps = {}

    def grab(e):
        if isinstance(e, ptt.EndIteration) and e.step % 2 == 0:
            snaps[e.step] = {p.name: t.scope.get(p.name).numpy().copy()
                             for p in prog.parameters()}

    reader, _ = _reader("train_loop")
    t.train(reader, 2, event_handler=grab, log_interval=100)
    serials = tio._complete_serials(d)
    assert len(serials) == 4
    for s in serials:
        sd = tio._serial_dir(d, s)
        tio.verify_checkpoint(sd)
        with open(os.path.join(sd, tio.META_FILE)) as f:
            step = json.load(f)["trainer_args"]["step"]
        sc = ptt.Scope()
        tio.load_vars(sd, sc, device="cpu")
        for n, want in snaps[step].items():
            np.testing.assert_array_equal(sc.get(n).numpy(), want)


# ------------------------------------------------- checkpoints


def test_rotation_keeps_max_num_checkpoints(tmp_path):
    d = str(tmp_path / "ck")
    t, _, feeds, metrics = _port_trainer("regression", ckpt=d, step_interval=1,
                                         max_num_checkpoints=2)
    _run(t, "regression", feeds, metrics)
    # 8 step saves and 2 pass-end saves, serials 0-9: the newest two stay
    assert tio._complete_serials(d) == [8, 9]
    assert tio.get_latest_checkpoint_serial(d, verify=True) == 9
    tio.clean_checkpoint(d)
    assert not os.path.exists(d)


def _keep_upto(src, dst, serial):
    shutil.copytree(src, dst)
    for s in tio._complete_serials(dst):
        if s > serial:
            shutil.rmtree(tio._serial_dir(dst, s))


def _mid_pass_serial(d):
    for s in tio._complete_serials(d):
        with open(os.path.join(tio._serial_dir(d, s), tio.META_FILE)) as f:
            args = json.load(f)["trainer_args"]
        if args.get("mid_pass") and args["pass_id"] == 1:
            return s, args
    raise AssertionError("no mid-pass checkpoint in pass 1")


def _uninterrupted(pkg, which, d, state):
    if pkg is pt:
        t, prog, feeds, metrics = _jax_trainer(which, d, step_interval=3,
                                               max_num_checkpoints=10)
        t.init()
        for n, v in state.items():
            pt.global_scope().set(n, v)
    else:
        t, prog, feeds, metrics = _port_trainer(which, d, step_interval=3,
                                                max_num_checkpoints=10)
        _set_state(t, state)
    _run(t, which, feeds, metrics, log_interval=2)
    return _params(t, prog)


def _resume(pkg, which, d):
    if pkg is pt:
        t, prog, feeds, metrics = _jax_trainer(which, d, step_interval=3,
                                               max_num_checkpoints=10)
    else:
        t, prog, feeds, metrics = _port_trainer(which, d, step_interval=3,
                                                max_num_checkpoints=10)
    t.init()
    assert (t.start_pass, t._resume_batch, t.step) == (1, 2, 6)
    _, events = _run(t, which, feeds, metrics, log_interval=2)
    assert [e.step for e in events if isinstance(e, (pt.EndIteration, ptt.EndIteration))] \
        == [7, 8]
    return _params(t, prog)


@pytest.mark.parametrize("writer,reader_pkg", [("port", "port"), ("jax", "port"),
                                               ("port", "jax")])
def test_mid_pass_resume(tmp_path, writer, reader_pkg):
    """A run checkpointed at step 6 (pass 1, batch 1) resumes in a fresh
    Trainer of either package and ends where the uninterrupted run of
    both packages ends."""
    which = "regression"
    state = _jax_state(_jax_trainer(which)[0])
    pkgs = {"port": ptt, "jax": pt}
    d = str(tmp_path / "ck")
    full = {k: _uninterrupted(p, which, d if k == writer else str(tmp_path / f"o{k}"), state)
            for k, p in pkgs.items()}
    serial, args = _mid_pass_serial(d)
    assert (args["step"], args["batch_id"]) == (6, 1)
    r = str(tmp_path / "resume")
    _keep_upto(d, r, serial)
    got = _resume(pkgs[reader_pkg], which, r)
    if writer == reader_pkg == "port":
        for n in full["port"]:
            np.testing.assert_array_equal(got[n], full["port"][n])
    _close(got, full["port"])
    _close(got, full["jax"])


@pytest.mark.parametrize("how", ["bit_flip", "torn_write"])
def test_corrupt_serial_quarantined(tmp_path, how):
    d = str(tmp_path / "ck")
    t, _, feeds, metrics = _port_trainer("regression", ckpt=d, step_interval=1,
                                         epoch_interval=0, max_num_checkpoints=10)
    if how == "torn_write":
        faults.reset()
        faults.arm("ckpt.write", hit=4, action="corrupt")  # step 4's npz
    try:
        _run(t, "regression", feeds, metrics, num_passes=1)
    finally:
        faults.reset()
    target = tio._serial_dir(d, 3)
    if how == "bit_flip":
        with open(os.path.join(target, tio.PARAMS_FILE), "r+b") as f:
            f.seek(200)
            b = f.read(1)
            f.seek(200)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(tio.CheckpointCorruptError):
            tio.verify_checkpoint(target)
        assert tio.get_latest_checkpoint_serial(d, verify=True) == 2
    else:
        # the torn file was hashed as published: only reading it fails
        tio.verify_checkpoint(target)
    sc = ptt.Scope()
    with pytest.warns(UserWarning, match="quarantined"):
        args = tio.load_checkpoint(d, scope=sc, device="cpu")
    assert args["step"] == 3 and args["batch_id"] == 2
    assert os.path.isdir(target + ".corrupt")
    assert tio._complete_serials(d) == [0, 1, 2]


def test_sigterm_writes_the_emergency_checkpoint(tmp_path):
    which = "regression"
    state = _jax_state(_jax_trainer(which)[0])
    full = _uninterrupted(ptt, which, str(tmp_path / "full"), state)
    d = str(tmp_path / "ck")
    t, prog, feeds, metrics = _port_trainer(which, d, step_interval=0,
                                            max_num_checkpoints=10)
    _set_state(t, state)

    def handler(e):
        if isinstance(e, ptt.EndIteration) and e.step == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    reader, _ = _reader(which)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(PreemptedError, match="SIGTERM") as ei:
        t.train(reader, 2, feed_order=feeds, event_handler=handler, fetch_metrics=metrics,
                log_interval=2)
    assert ei.value.checkpointed and issubclass(PreemptedError, RuntimeError)
    assert JaxPreempted.__name__ == PreemptedError.__name__
    assert signal.getsignal(signal.SIGTERM) is before  # the handler is put back
    serial, args = _mid_pass_serial(d)
    assert (args["step"], args["batch_id"]) == (6, 1)
    got = _resume(ptt, which, d)
    for n in full:
        np.testing.assert_array_equal(got[n], full[n])


def test_not_ported_paths_raise(tmp_path, monkeypatch):
    # sharded checkpoints are ported (tests/test_torch_sharded_checkpoint.py)
    assert ptt.CheckpointConfig(str(tmp_path), sharded=True).sharded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog, startup, _, loss, _ = _build(ptt, "regression")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.Trainer(loss, main_program=prog, startup_program=startup)
    assert jio.CHECKPOINT_PREFIX == tio.CHECKPOINT_PREFIX


@pytest.mark.parametrize("skip_nonfinite", [False, True])
def test_accum_fold_equals_jax(skip_nonfinite):
    from paddle_tpu.core.executor import accum_fold as jfold
    from paddle_tpu_torch.core.executor import accum_fold as tfold

    import jax.numpy as jnp

    costs = [1.5, float("nan"), 2.25, float("inf"), 0.125]
    metrics = [[0.5, 3.0], [1.0, 2.0], [0.25, -1.0], [7.0, 7.0], [2.0, 0.5]]
    js = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32),
          [jnp.zeros((), jnp.float32)] * 2, jnp.zeros((), jnp.int32))
    ts = (torch.zeros((), dtype=torch.int32), torch.zeros(()), [torch.zeros(())] * 2,
          torch.zeros((), dtype=torch.int32))
    for c, m in zip(costs, metrics):
        js = jfold(js, np.float32(c), [np.float32(v) for v in m], skip_nonfinite)
        ts = tfold(ts, torch.tensor([c]), [torch.tensor(v) for v in m], skip_nonfinite)
    flat = lambda s: [float(s[0]), float(s[1]), *map(float, s[2]), float(s[3])]  # noqa: E731
    np.testing.assert_array_equal(flat(ts), flat(js))
    assert ts[0].dtype == ts[3].dtype == torch.int32 and ts[1].dtype == torch.float32
    assert flat(ts)[-1] == 2 and flat(ts)[0] == (3 if skip_nonfinite else 5)


def test_feed_signature_and_global_scope():
    from paddle_tpu_torch.core import executor as tex

    lod = lambda n: ptt.LoDArray.from_sequences(  # noqa: E731
        [np.arange(n, dtype=np.int32)], bucket=8)
    a = {"x": np.zeros((4, 3), np.float32), "w": lod(3)}
    b = {"w": lod(5), "x": torch.zeros(4, 3)}
    assert tex._feed_signature(a) == tex._feed_signature(b)  # same shapes and dtypes
    assert tex._feed_signature(a) != tex._feed_signature({**a, "w": lod(9)})  # capacity
    assert tex._feed_signature(a) != tex._feed_signature({**a, "x": np.zeros((4, 3))})
    old = ptt.global_scope()
    old.set("v", torch.ones(1))
    ptt.reset_global_scope()
    assert ptt.global_scope() is not old and not ptt.global_scope().has("v")


def test_stats_line_and_param_stats(monkeypatch, caplog, capsys):
    """FLAGS.stats_period logs the counters' line (at steps 0 and 2 of 4,
    as the JAX package's cadence); show_param_stats_period prints each
    trained parameter's statistics on its steps, a per-step sync each."""
    monkeypatch.setattr(ptt.FLAGS, "stats_period", 2)
    monkeypatch.setattr(ptt.FLAGS, "show_param_stats_period", 2)
    t, prog, feeds, metrics = _port_trainer("regression")
    with caplog.at_level("INFO", logger="paddle_tpu_torch.stats"):
        _run(t, "regression", feeds, metrics, num_passes=1, log_interval=100)
    lines = [r.getMessage() for r in caplog.records if r.name == "paddle_tpu_torch.stats"]
    assert [m.split()[0] for m in lines] == ["step=0", "step=2"]
    out = capsys.readouterr().out
    assert out.count("  param ") == 2 * len(prog.parameters()) and "grad_abs_max=" in out
    assert t.host_sync_count == 3  # two stats steps and the pass end
