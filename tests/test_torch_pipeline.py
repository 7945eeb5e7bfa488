"""The port's pipeline (paddle_tpu_torch/pipeline) against the JAX
package's, on the CPU.

- Cut parity: `split_program` gives the JAX package's stages op for op
  (op types, boundary, feed and state names, costs) for auto-balanced
  cuts, marker cuts and the transformer's narrowed cut.
- The refusals: oversplit, sparse_update, train-mode BN, a batch the
  micro-batch count does not divide, a LoD feed.
- The determinism contract in the port: parameters after two steps are
  bit-identical for K in {1, 2, 4} at fixed M, under gpipe and 1f1b, on
  the MLP and on a 2-layer transformer (with dropout too: draws are keyed
  by micro-batch), and on a pp mesh of CPU devices.
- The staged step against the JAX PipelineExecutor on the MLP, from one
  state: losses within 1e-6 relative and parameters within 1e-6 absolute
  (f32; measured 1.3e-7 and 8.9e-8), under Adam and under SGD, whose step
  shows a gradient scaled wrong. The transformer autocut is not used
  for this: its JAX reference test fails on this tree.
- The Trainer on a PipelineExecutor, per step and through scan_window
  (on the CPU a window runs its steps eagerly on its buffers): the same
  parameter bits. The pipeline metrics are declared at 0, then live; an
  AST lint keeps host reads out of the tick loop.

torch runs on one thread here: its multi-threaded CPU reductions may
differ run to run.
"""

import ast
import gc
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.pipeline import PipelineExecutor, split_program
from paddle_tpu_torch.pipeline import schedule as psched

torch.set_num_threads(1)


def _pkg(name):
    if name == "jax":
        import paddle_tpu as pt
        import paddle_tpu.models  # noqa: F401
        import paddle_tpu.pipeline  # noqa: F401

        pt.reset()
        return pt
    ptt.reset_default_programs()
    return ptt


def _mlp(pkg, depth=4, dim=16, markers=False, seed=7, opt="adam"):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[dim])
        y = pkg.layers.data("y", shape=[1])
        h = x
        for i in range(depth):
            if markers and i == depth // 2:
                pkg.pipeline.stage_boundary()
            h = pkg.layers.fc(h, size=dim, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        if opt == "sgd":
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        else:
            pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _mlp_feed(batch=8, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, dim).astype(np.float32),
            "y": rng.randn(batch, 1).astype(np.float32)}


def _residual(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8])
        y = pkg.layers.data("y", shape=[1])
        h = x
        for _ in range(4):
            b = pkg.layers.fc(h, size=8, act="relu")
            b = pkg.layers.fc(b, size=8)
            h = pkg.layers.elementwise_add(h, b)
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _tfm(pkg, dropout=0.0, seed=11, dim=32, depth=2, seqlen=8, vocab=50, heads=1):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        toks = pkg.layers.data("toks", shape=[seqlen], dtype=np.int32)
        labels = pkg.layers.data("labels", shape=[seqlen, 1], dtype=np.int32)
        logits = pkg.models.transformer_lm(toks, vocab_size=vocab, dim=dim, num_heads=heads,
                                           num_layers=depth, max_len=seqlen,
                                           dropout_prob=dropout)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, labels))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _tfm_feed(batch=8, seqlen=8, vocab=50, seed=0):
    rng = np.random.RandomState(seed)
    return {"toks": rng.randint(0, vocab, (batch, seqlen)).astype(np.int32),
            "labels": rng.randint(0, vocab, (batch, seqlen, 1)).astype(np.int32)}


def _stages(staged):
    return [([o.type for o in s.ops], s.in_names, s.out_names, s.feed_names, s.state_names,
             s.cost) for s in staged.stages]


# ------------------------------------------------------------ cut parity --
@pytest.mark.parametrize("case", ["mlp-k2", "mlp-k3", "mlp-markers", "residual-k2",
                                  "tfm-k2", "tfm-k4", "tfm-k3"])
def test_split_matches_jax_op_for_op(case):
    kind, k = case.split("-")
    build = {"mlp": lambda p: _mlp(p, depth=6, markers=k == "markers"), "residual": _residual,
             "tfm": lambda p: _tfm(p, depth=4)}[kind]
    cuts = None if k == "markers" else int(k[1:])
    import paddle_tpu.pipeline as jpipe

    jmain = build(_pkg("jax"))[0]
    want = jpipe.split_program(jmain, num_stages=cuts)
    pmain = build(_pkg("port"))[0]
    got = split_program(pmain, num_stages=cuts)
    assert _stages(got) == _stages(want)
    assert (got.loss_name, got.param_names, got.tail_fwd_names) == \
        (want.loss_name, want.param_names, want.tail_fwd_names)
    assert [o.type for o in got.tail_ops] == [o.type for o in want.tail_ops]
    if kind in ("residual", "tfm"):  # narrowed onto the residual stream
        assert all(len(s.out_names) == 1 for s in got.stages[:-1])


# ------------------------------------------------------------- refusals --
def test_refusals():
    main, _, _ = _mlp(_pkg("port"), depth=2)
    with pytest.raises(ValueError, match="exceeds"):
        split_program(main, num_stages=10_000)
    with pytest.raises(ValueError, match="num_stages"):
        split_program(main)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        toks = ptt.layers.data("t", shape=[4], dtype=np.int32)
        y = ptt.layers.data("y", shape=[1])
        emb = ptt.layers.embedding(toks, size=[16, 8], is_sparse=True)
        pred = ptt.layers.fc(ptt.layers.reduce_mean(emb, dim=1), size=1)
        ptt.optimizer.SGD(learning_rate=0.1).minimize(
            ptt.layers.mean(ptt.layers.square_error_cost(pred, y)))
    with pytest.raises(NotImplementedError, match="sparse"):
        split_program(main, num_stages=2)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[8])
        y = ptt.layers.data("y", shape=[1])
        h = ptt.layers.batch_norm(ptt.layers.fc(x, size=8))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(
            ptt.layers.mean(ptt.layers.square_error_cost(ptt.layers.fc(h, size=1), y)))
    with pytest.raises(NotImplementedError, match="persistable"):
        split_program(main, num_stages=2)
    main, startup, loss = _mlp(_pkg("port"))
    sc = ptt.Scope()
    exe = PipelineExecutor("cpu", num_stages=2, num_microbatches=3)
    exe.run(startup, scope=sc)
    with pytest.raises(ValueError, match="divisible by microbatches"):
        exe.run(main, _mlp_feed(batch=8), [loss], scope=sc)
    with pytest.raises(ValueError, match="pp"):
        PipelineExecutor("cpu", num_stages=3, num_microbatches=4,
                         mesh=ptt.parallel.mesh_from_spec("pp2", devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="schedule"):
        PipelineExecutor("cpu", schedule="interleaved")


def test_lod_feed_refused():
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        w = ptt.layers.data("w", shape=[1], dtype=np.int32, lod_level=1)
        y = ptt.layers.data("y", shape=[1])
        emb = ptt.layers.embedding(w, size=[10, 4])
        pred = ptt.layers.fc(ptt.layers.sequence_pool(emb, "sum"), size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    sc = ptt.Scope()
    exe = PipelineExecutor("cpu", num_stages=2, num_microbatches=2)
    exe.run(startup, scope=sc)
    lod = ptt.LoDArray.from_sequences([np.array([[1], [2]]), np.array([[3]])], bucket=4)
    with pytest.raises(NotImplementedError, match="LoD feed"):
        exe.run(main, {"w": lod, "y": np.zeros((2, 1), np.float32)}, [loss], scope=sc)


# ------------------------------------------------------ the bits across K --
def _steps(build, feed, K, M, schedule="gpipe", steps=2, mesh=None, seed=5):
    main, startup, loss = build(_pkg("port"))
    sc = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=sc, seed=3)
    exe = PipelineExecutor("cpu", num_stages=K, num_microbatches=M, schedule=schedule,
                           mesh=mesh)
    losses = [float(exe.run(main, feed(seed=s), [loss], scope=sc, seed=seed + s)[0])
              for s in range(steps)]
    return losses, {p.name: sc.get(p.name).clone() for p in main.persistables()}


@pytest.mark.parametrize("model", ["mlp", "tfm", "tfm-dropout", "mlp-markers"])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bits_identical_for_every_stage_count(model, schedule):
    build, feed = {"mlp": (_mlp, _mlp_feed), "tfm": (_tfm, _tfm_feed),
                   "tfm-dropout": (lambda p: _tfm(p, dropout=0.2), _tfm_feed),
                   "mlp-markers": (lambda p: _mlp(p, markers=True), _mlp_feed)}[model]
    ks = (1, 2) if model == "mlp-markers" else (1, 2, 4)
    ref_losses, ref = _steps(build, feed, 1, 4, schedule)
    for K in ks[1:]:
        losses, got = _steps(build, feed, K, 4, schedule)
        assert losses == ref_losses, (K, losses, ref_losses)
        bad = [n for n in ref if not torch.equal(ref[n], got[n])]
        assert not bad, f"K={K} {schedule}: diverged {bad[:6]}"
    if schedule == "1f1b":  # the recompute gives gpipe's bits too
        g_losses, g = _steps(build, feed, 2, 4, "gpipe")
        assert g_losses == ref_losses
        assert all(torch.equal(g[n], ref[n]) for n in ref)


def test_pp_mesh_of_devices_gives_the_meshless_bits():
    mesh = ptt.parallel.mesh_from_spec("pp2", devices=["cpu", "cpu"])
    assert mesh.pp_devices == [torch.device("cpu")] * 2
    ref_losses, ref = _steps(_mlp, _mlp_feed, 4, 4)
    losses, got = _steps(_mlp, _mlp_feed, 4, 4, mesh=mesh)
    assert losses == ref_losses
    assert all(torch.equal(got[n], ref[n]) for n in ref)


def _against_jax_pipeline(opt, schedule="gpipe"):
    import paddle_tpu as pt

    jmain, jstartup, jloss = _mlp(_pkg("jax"), opt=opt)
    pt.Executor().run(jstartup)
    state = {v.name: np.array(pt.global_scope().get(v.name)) for v in jmain.persistables()}
    jexe = pt.pipeline.PipelineExecutor(num_stages=2, num_microbatches=4)
    jl = [float(np.asarray(jexe.run(jmain, feed=_mlp_feed(seed=s), fetch_list=[jloss])[0]))
          for s in range(2)]
    want = {n: np.asarray(pt.global_scope().get(n), np.float32) for n in state}
    pmain, _, ploss = _mlp(_pkg("port"), opt=opt)
    sc = ptt.Scope()
    ptt.io.params_from_numpy(sc, state, "cpu")
    exe = PipelineExecutor("cpu", num_stages=2, num_microbatches=4, schedule=schedule)
    pl = [float(exe.run(pmain, _mlp_feed(seed=s), [ploss], scope=sc)[0]) for s in range(2)]
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    got = ptt.io.state_to_numpy(sc, list(state))
    for n in state:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6, err_msg=n)
    return max(float(np.abs(want[n] - state[n]).max()) for n in state)


def test_staged_step_matches_jax_pipeline_executor():
    _against_jax_pipeline("adam")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_staged_sgd_step_matches_jax_pipeline_executor(schedule):
    """SGD's step is the gradient times the rate, so a micro-batch's loss
    seeded 1 instead of 1/M (gradients M times too large) fails here as it
    would not under Adam; the same bounds."""
    moved = _against_jax_pipeline("sgd", schedule)
    assert moved > 1e-4, moved  # the steps move the parameters well past the bound


# ------------------------------------------------------- the Trainer --
def test_trainer_on_pipeline_executor_with_a_window():
    def run(window):
        main, startup, loss = _mlp(_pkg("port"))
        sc = ptt.Scope()
        ptt.Executor(device="cpu").run(startup, scope=sc, seed=3)
        t = ptt.Trainer(loss, main_program=main, startup_program=startup, scope=sc,
                        executor=PipelineExecutor("cpu", num_stages=2, num_microbatches=4))
        t._initialized = True

        def reader():
            for i in range(8):
                yield _mlp_feed(seed=i)

        m = t.train(reader, num_passes=1, log_interval=4, scan_window=window)
        return m, {p.name: sc.get(p.name).clone() for p in main.persistables()}

    m0, per_step = run(None)
    m4, windowed = run(4)
    assert np.isfinite(m0["cost"]) and m4["cost"] == m0["cost"]
    assert all(torch.equal(per_step[n], windowed[n]) for n in per_step)


def test_metrics_declared_then_live():
    from paddle_tpu_torch.obs import promparse
    from paddle_tpu_torch.obs.metrics import registry

    gc.collect()  # earlier tests' executors: their collectors would answer too
    main, startup, loss = _mlp(_pkg("port"))
    exe = PipelineExecutor("cpu", num_stages=4, num_microbatches=4)
    fams = promparse.parse_text(registry().render())
    assert fams["pt_pipeline_bubble_fraction"].value() == 0.0
    assert "pt_ckpt_reshard_total" in fams
    sc = ptt.Scope()
    exe.run(startup, scope=sc)
    exe.run(main, _mlp_feed(), [loss], scope=sc)
    fams = promparse.parse_text(registry().render())
    np.testing.assert_allclose(fams["pt_pipeline_bubble_fraction"].value(), 3 / 7)
    for s in range(4):
        np.testing.assert_allclose(
            fams["pt_pipeline_stage_occupancy"].value({"stage": str(s)}), 4 / 7)
    del exe
    gc.collect()


def test_tick_loop_has_no_host_reads():
    """No `.item()`, `.cpu()`, `.tolist()`, `.numpy()`, np.asarray or
    synchronize in the staged step: a host read inside the tick loop would
    wait on the card once a stage and break a window's capture."""
    tree = ast.parse(inspect.getsource(psched.PipelineExecutor._staged_step).strip()
                     .replace("\n    ", "\n"))
    banned = {"item", "cpu", "tolist", "numpy", "asarray", "synchronize", "device_get"}
    found = [(n.attr, n.lineno) for n in ast.walk(tree)
             if isinstance(n, ast.Attribute) and n.attr in banned]
    assert not found, found
