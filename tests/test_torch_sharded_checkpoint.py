"""Sharded checkpoints (paddle_tpu_torch/io.py, pipeline/elastic.py)
against the JAX package's, on the CPU.

- A sharded checkpoint the JAX package saves (ZeRO-1 moments sharded over
  its 8-device CPU mesh) loads in the port with the same values, and one
  the port's two gloo ranks save (their ZeRO-1 slices) loads in the JAX
  package with the same values: the layout, manifests and hashes are the
  JAX package's.
- Resume on another world: the two ranks' checkpoint loads in one process
  (counted in pt_ckpt_reshard_total), and one more step there gives the
  ranks' uninterrupted third step within 1e-6 (f32).
- The Trainer on a ParallelExecutor of two ranks upgrades its checkpoints
  to the sharded format, and a second Trainer resumes from them.
- A torn shard file and a flipped payload byte each cost their serial
  (quarantined; the previous one loads); a manifest naming a member the
  shard file lacks raises CheckpointCorruptError naming it.

The spawned ranks re-import this module, so it imports neither jax nor
paddle_tpu at the top.
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as tio

WORLD = 2


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8])
        y = pkg.layers.data("y", shape=[1])
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _feed(s):
    rng = np.random.RandomState(s)
    return {"x": rng.randn(8, 8).astype(np.float32), "y": rng.randn(8, 1).astype(np.float32)}


def _state():
    ptt.reset_default_programs()
    main, startup, _ = _mlp(ptt)
    sc = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=sc, seed=3)
    return ptt.io.state_to_numpy(sc, [v.name for v in main.persistables()])


def _whole(sc, names, mesh):
    from paddle_tpu_torch.parallel import all_gather

    return {n: (all_gather(sc.get(n), "dp", axis=0, mesh=mesh) if n in sc.shards
                else sc.get(n)).numpy() for n in names}


def _rank_main(rank, init, out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel import ParallelExecutor, distributed, mesh_from_spec

    distributed.init_distributed(init, WORLD, rank, device="cpu")
    try:
        mesh = mesh_from_spec("dp2")
        state = _state()
        ptt.reset_default_programs()
        main, _, loss = _mlp(ptt)
        sc = ptt.Scope()
        ptt.io.params_from_numpy(sc, state, "cpu")
        exe = ParallelExecutor(mesh, shard_optimizer_state=True, device="cpu")
        ck = os.path.join(out_dir, "ckpt")
        for s in range(3):
            exe.run(main, _feed(s), [loss], scope=sc)
            if s < 2:  # serials 0 and 1, after steps 1 and 2
                tio.save_checkpoint(ck, {"step": s + 1}, main, sc, sharded=True)
                if s == 1:
                    saved = _whole(sc, sorted(state), mesh)
        out = {f"saved.{n}": v for n, v in saved.items()}
        out.update({f"step3.{n}": v for n, v in _whole(sc, sorted(state), mesh).items()})
        out["sliced"] = np.array(sorted(sc.shards)).astype(str)
        # the Trainer: a multi-process run upgrades its saves to sharded
        tck = os.path.join(out_dir, "trainer")
        t_sc = ptt.Scope()
        ptt.io.params_from_numpy(t_sc, state, "cpu")
        cfg = ptt.CheckpointConfig(tck, step_interval=2)
        t1 = ptt.Trainer(loss, main_program=main, scope=t_sc, checkpoint_config=cfg,
                         executor=ParallelExecutor(mesh, shard_optimizer_state=True,
                                                   device="cpu"))
        t1._initialized = True
        t1.train(lambda: iter([_feed(10 + i) for i in range(4)]), num_passes=1)
        t1.stop()
        t2_sc = ptt.Scope()
        t2 = ptt.Trainer(loss, main_program=main, scope=t2_sc, checkpoint_config=cfg,
                         executor=ParallelExecutor(mesh, device="cpu"))
        t2.init()
        t2.stop()
        out["trainer.step"] = np.array([t1.step, t2.step])
        t1_whole = _whole(t_sc, sorted(state), mesh)
        for n in sorted(state):
            out[f"trainer.same.{n}"] = np.array(np.array_equal(t1_whole[n],
                                                               t2_sc.get(n).numpy()))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("sharded")
    mp.spawn(_rank_main, args=(f"file://{d / 'rendezvous'}", str(d)), nprocs=WORLD,
             join=True)
    return d, [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _port_program():
    ptt.reset_default_programs()
    return _mlp(ptt)


def test_port_ranks_save_the_jax_layout(saved):
    d, ranks = saved
    serial = os.path.join(d, "ckpt", "checkpoint_1")
    assert sorted(os.listdir(serial)) == ["manifest_p0.json", "manifest_p1.json", "meta.json",
                                          "sharded_meta.json", "shards_p0.npz",
                                          "shards_p1.npz"]
    with open(os.path.join(serial, "sharded_meta.json")) as f:
        meta = json.load(f)
    assert meta["num_processes"] == 2
    moments = [n for n, i in meta["vars"].items() if i["kind"] == "sharded"]
    assert moments == sorted(str(n) for n in ranks[0]["sliced"])
    for n in moments:
        assert sorted(e["process"] for e in meta["vars"][n]["shards"]) == [0, 1]
    with open(os.path.join(serial, "meta.json")) as f:
        assert set(json.load(f)["integrity"]) == {"sharded_meta.json", "shards_p0.npz",
                                                 "shards_p1.npz"}


def test_port_sharded_checkpoint_loads_in_jax(saved):
    import paddle_tpu as pt

    d, ranks = saved
    pt.reset()
    jmain, _, _ = _mlp(pt)
    args = pt.io.load_checkpoint(os.path.join(d, "ckpt"), jmain)
    assert args == {"step": 2}
    for k, v in ranks[0].items():
        if k.startswith("saved."):
            np.testing.assert_array_equal(np.asarray(pt.global_scope().get(k[6:])), v,
                                          err_msg=k)


def test_jax_sharded_checkpoint_loads_in_port(tmp_path):
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu import parallel as jpar

    state = _state()
    pt.reset()
    jmain, _, jloss = _mlp(pt)
    scope = pt.global_scope()
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    exe = jpar.ParallelExecutor(jpar.make_mesh(), shard_optimizer_state=True)
    exe.run(jmain, feed=_feed(0), fetch_list=[jloss])
    sharded = [n for n in state if not scope.get(n).is_fully_replicated]
    assert sharded  # the ZeRO-1 moments over the 8 devices
    pt.io.save_checkpoint(str(tmp_path), {"step": 1}, jmain, sharded=True)
    want = {n: np.asarray(scope.get(n)) for n in state}
    pmain, _, _ = _port_program()
    sc = ptt.Scope()
    from paddle_tpu_torch.obs.metrics import registry

    before = registry().counter_value("pt_ckpt_reshard_total")
    assert tio.load_checkpoint(str(tmp_path), pmain, sc, device="cpu") == {"step": 1}
    assert registry().counter_value("pt_ckpt_reshard_total") == before + 1  # 8 devices, 1
    for n in state:
        np.testing.assert_array_equal(sc.get(n).numpy(), want[n], err_msg=n)


def test_resume_on_one_process_gives_the_ranks_next_step(saved):
    from paddle_tpu_torch.obs.metrics import registry

    d, ranks = saved
    pmain, _, loss = _port_program()
    sc = ptt.Scope()
    before = registry().counter_value("pt_ckpt_reshard_total")
    args = ptt.pipeline.load_checkpoint_resharded(os.path.join(d, "ckpt"), pmain, sc,
                                                 device="cpu")
    assert args == {"step": 2}
    assert registry().counter_value("pt_ckpt_reshard_total") == before + 1
    assert not sc.shards  # whole values
    ptt.Executor(device="cpu").run(pmain, _feed(2), [loss], scope=sc)
    for k, v in ranks[0].items():
        if k.startswith("step3."):
            np.testing.assert_allclose(sc.get(k[6:]).numpy(), v, atol=1e-6, rtol=0,
                                       err_msg=k)


def test_trainer_on_parallel_executor_resumes(saved):
    d, ranks = saved
    for r in ranks:
        np.testing.assert_array_equal(r["trainer.step"], [4, 4])
        assert all(bool(v) for k, v in r.items() if k.startswith("trainer.same."))
    serials = sorted(os.listdir(os.path.join(d, "trainer")))
    assert serials == ["checkpoint_0", "checkpoint_1", "checkpoint_2"]  # steps 2, 4, the pass
    assert all(os.path.exists(os.path.join(d, "trainer", s, "sharded_meta.json"))
               for s in serials)


def _copy(saved, tmp_path):
    d, _ = saved
    dst = tmp_path / "ckpt"
    shutil.copytree(os.path.join(d, "ckpt"), dst)
    return str(dst)


@pytest.mark.parametrize("damage", ["torn", "flipped"])
def test_damaged_shard_costs_its_serial(saved, tmp_path, damage):
    ck = _copy(saved, tmp_path)
    path = os.path.join(ck, "checkpoint_1", "shards_p1.npz")
    if damage == "torn":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
    pmain, _, _ = _port_program()
    sc = ptt.Scope()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        args = tio.load_checkpoint(ck, pmain, sc, device="cpu")
    assert args == {"step": 1}  # the previous serial
    assert any("quarantined" in str(x.message) for x in w)
    assert os.path.isdir(os.path.join(ck, "checkpoint_1.corrupt"))


def test_missing_member_is_a_typed_error(saved, tmp_path):
    ck = _copy(saved, tmp_path)
    serial = os.path.join(ck, "checkpoint_1")
    with open(os.path.join(serial, "sharded_meta.json")) as f:
        meta = json.load(f)
    name = next(n for n, i in meta["vars"].items() if i["kind"] == "sharded")
    meta["vars"][name]["shards"][0]["key"] = name + "::7"
    with open(os.path.join(serial, "sharded_meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(tio.CheckpointCorruptError, match="does not match"):
        tio.verify_checkpoint(serial)  # the manifest's hash
    with pytest.raises(tio.CheckpointCorruptError, match="missing member"):
        tio.load_sharded_checkpoint(serial, device="cpu")
    # a save without hashes is still checked for the shard files it names
    with open(os.path.join(serial, "meta.json")) as f:
        m = json.load(f)
    del m["integrity"]
    with open(os.path.join(serial, "meta.json"), "w") as f:
        json.dump(m, f)
    tio.verify_checkpoint(serial)
    os.remove(os.path.join(serial, "shards_p1.npz"))
    with pytest.raises(tio.CheckpointCorruptError, match="shards_p1.npz referenced"):
        tio.verify_checkpoint(serial)


def test_single_process_sharded_trainer_round_trip(tmp_path):
    """One process, CheckpointConfig(sharded=True): the writer thread
    commits the sharded layout (every value whole, the chief's), and a
    second Trainer resumes from it with the same values."""
    main, startup, loss = _port_program()
    sc = ptt.Scope()
    cfg = ptt.CheckpointConfig(str(tmp_path), step_interval=2, sharded=True)
    t1 = ptt.Trainer(loss, main_program=main, startup_program=startup, place="cpu", scope=sc,
                     checkpoint_config=cfg)
    t1.train(lambda: iter([_feed(i) for i in range(4)]), num_passes=1)
    t1.stop()
    newest = sorted(os.listdir(tmp_path))[-1]
    with open(os.path.join(tmp_path, newest, "sharded_meta.json")) as f:
        assert {i["kind"] for i in json.load(f)["vars"].values()} == {"replicated"}
    sc2 = ptt.Scope()
    t2 = ptt.Trainer(loss, main_program=main, startup_program=startup, place="cpu", scope=sc2,
                     checkpoint_config=cfg)
    t2.init()
    t2.stop()
    assert t2.step == t1.step == 4
    for v in main.persistables():
        assert torch.equal(sc2.get(v.name), sc.get(v.name)), v.name


# ------------------------------------------- the background commit --
def _trained_scope():
    main, startup, loss = _port_program()
    sc = ptt.Scope()
    exe = ptt.Executor(device="cpu")
    exe.run(startup, scope=sc, seed=3)
    exe.run(main, _feed(0), [loss], scope=sc)
    return main, sc


def test_submit_blocks_only_on_inflight_commit(tmp_path, monkeypatch):
    """A submit returns at once with a slow commit enqueued (references,
    no host copy, no disk); the next submit waits for it first."""
    import time

    from paddle_tpu_torch.pipeline import elastic
    from paddle_tpu_torch.trainer import _CheckpointWriter

    main, sc = _trained_scope()
    real_save, delay = tio.save_checkpoint, 0.4

    def slow_save(*a, **kw):
        time.sleep(delay)
        return real_save(*a, **kw)

    monkeypatch.setattr(tio, "save_checkpoint", slow_save)
    writer, d = _CheckpointWriter(), str(tmp_path / "ck")
    t0 = time.monotonic()
    elastic.submit_sharded_save(writer, d, {"step": 1}, main, sc)
    assert time.monotonic() - t0 < delay / 2
    t0 = time.monotonic()
    elastic.submit_sharded_save(writer, d, {"step": 2}, main, sc)
    assert time.monotonic() - t0 >= delay / 2
    writer.drain()
    assert (writer.commits, writer.failures) == (2, 0)
    assert tio.get_latest_checkpoint_serial(d) == 1
    with open(os.path.join(d, "checkpoint_1", "sharded_meta.json")) as f:
        assert json.load(f)["vars"]


def test_snapshot_isolated_from_continued_training(tmp_path):
    """The commit holds the values at submit time, whatever the live scope
    binds after it; the same through the trainer's host reader."""
    from paddle_tpu_torch.pipeline import elastic
    from paddle_tpu_torch.trainer import _CheckpointWriter, _HostReader

    main, sc = _trained_scope()
    names = [v.name for v in main.persistables()]
    at_submit = tio.state_to_numpy(sc, names)
    writer = _CheckpointWriter()
    for i, reader in enumerate((None, _HostReader(torch.device("cpu")))):
        d = str(tmp_path / f"ck{i}")
        elastic.submit_sharded_save(writer, d, {"step": 1}, main, sc, reader=reader)
        w = names[0]
        sc.set(w, torch.zeros_like(sc.get(w)))
        writer.drain()
        sc.set(w, torch.as_tensor(at_submit[w]))
        got = ptt.Scope()
        assert tio.load_checkpoint(d, main, got, device="cpu") == {"step": 1}
        for n, v in at_submit.items():
            np.testing.assert_array_equal(got.get(n).numpy(), v, err_msg=n)


def test_submit_refuses_multiprocess(monkeypatch):
    from paddle_tpu_torch.parallel import distributed
    from paddle_tpu_torch.pipeline import elastic
    from paddle_tpu_torch.trainer import _CheckpointWriter

    main, sc = _trained_scope()
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        elastic.submit_sharded_save(_CheckpointWriter(), "/nonexistent", main_program=main,
                                    scope=sc)


@pytest.mark.parametrize("sharded", [False, True])
def test_trainer_background_save_is_submit_sharded_save(tmp_path, monkeypatch, sharded):
    """The Trainer's background saves, gathered or sharded, go through
    elastic.submit_sharded_save with its writer and host reader."""
    from paddle_tpu_torch.pipeline import elastic

    calls = []
    real = elastic.submit_sharded_save

    def spy(writer, d, *a, **kw):
        calls.append((kw["sharded"], kw["reader"] is not None))
        return real(writer, d, *a, **kw)

    monkeypatch.setattr(elastic, "submit_sharded_save", spy)
    main, startup, loss = _port_program()
    cfg = ptt.CheckpointConfig(str(tmp_path), step_interval=2, sharded=sharded)
    t = ptt.Trainer(loss, main_program=main, startup_program=startup, place="cpu",
                    scope=ptt.Scope(), checkpoint_config=cfg)
    t.train(lambda: iter([_feed(i) for i in range(4)]), num_passes=1)
    t.stop()
    assert calls and set(calls) == {(sharded, True)}
    newest = os.path.join(tmp_path, sorted(os.listdir(tmp_path))[-1])
    assert os.path.exists(os.path.join(newest, "sharded_meta.json")) == sharded
