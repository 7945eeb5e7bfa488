"""The port's data and tensor parallelism (paddle_tpu_torch/parallel) on
two gloo ranks on the CPU, against numpy, the port's single process and
the JAX package.

One group of 2 ranks (a module fixture) runs every check's port side:
each rank one thread, a `file://` rendezvous under the test's tmp_path (so
parallel test workers never share a port), and the results written to an
npz a rank; the tests read them. The spawned ranks re-import this module,
so it imports neither jax nor paddle_tpu at the top.

Tolerances (f32, three Adam(1e-2) steps from one state; measured on this
container's CPU):
- The collectives against numpy: exact (integer-valued floats).
- dp2 against the port's single process on the whole batch: losses within
  1e-6 relative, parameters within 1e-6 absolute (measured 1.1e-7 and
  3.0e-8); the two ranks' parameters the same bits. ZeRO-1 against dp2
  with replicated state: the same bits.
- dp2 against the JAX ParallelExecutor on the 8-device CPU mesh: the same
  bounds (measured 1.1e-7 and 3.0e-8).
- A ragged (LoD) feed whose ranks hold different token counts: the loss is
  a token mean, so each rank's gradients are weighted by its share; within
  1e-6 of the single process (measured 8.1e-8 and 7.5e-9).
- mp2 (the transformer's mp_axis; the sharded embedding) against the JAX
  package's model from the same state on one device: losses within 1e-5
  relative, parameters within 1e-5 absolute (measured 1.3e-7 and 5.3e-7
  for the transformer, whose row-split products sum two partial products;
  1.1e-7 and 3.0e-8 for the embedding); the key bias and its moments,
  whose gradient is rounding noise, are left out.
- Adam's step hardly changes when a gradient is multiplied by a constant,
  so each of dp2, the ragged dp2, mp2 (both models) and dp2 x pp2 also
  takes three SGD(0.1) steps against the JAX package (its
  ParallelExecutor on the 8-device mesh, its PipelineExecutor, or its
  Executor on the whole batch), within the bounds above (measured: losses
  2.0e-7, 2.4e-7, 1.3e-7, 1.1e-7 and 1.0e-7 relative; parameters 6.0e-8,
  2.3e-10, 4.5e-7, 1.0e-8 and 3.0e-8).
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt

WORLD = 2
STEPS = 3
LR = 1e-2
SGD_LR = 0.1


def _minimize(pkg, loss, opt):
    """Adam(LR), or SGD(SGD_LR): a step proportional to the gradient, so a
    gradient off by a constant factor moves the parameters by as much."""
    if opt == "sgd":
        return pkg.optimizer.SGD(learning_rate=SGD_LR).minimize(loss)
    return pkg.optimizer.Adam(learning_rate=LR).minimize(loss)


# ------------------------------------------------------------- builders --
def _mlp(pkg, dim=8, opt="adam"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[dim])
        y = pkg.layers.data("y", shape=[1])
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        _minimize(pkg, loss, opt)
    return main, startup, loss


def _mlp_feeds():
    rng = np.random.RandomState(0)
    return [{"x": rng.randn(8, 8).astype(np.float32), "y": rng.randn(8, 1).astype(np.float32)}
            for _ in range(STEPS)]


def _ragged(pkg, vocab=20, emb=6, opt="adam"):
    """A token-level loss over a LoD batch: mean over every token row."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        w = pkg.layers.data("w", shape=[1], dtype=np.int32, lod_level=1)
        e = pkg.layers.embedding(w, size=[vocab, emb])
        pred = pkg.layers.fc(e, size=2, act="tanh")
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(pred, pred))
        _minimize(pkg, loss, opt)
    return main, startup, loss


def _ragged_seqs(step):
    rng = np.random.RandomState(10 + step)
    lens = [7, 1, 2, 1] if step % 2 == 0 else [1, 2, 6, 5]  # ranks' token counts differ
    return [rng.randint(0, 20, (n, 1)).astype(np.int32) for n in lens]


def _tfm(pkg, mp_axis=None, opt="adam"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        toks = pkg.layers.data("toks", shape=[8], dtype=np.int32)
        labels = pkg.layers.data("labels", shape=[8, 1], dtype=np.int32)
        logits = pkg.models.transformer_lm(toks, vocab_size=16, dim=16, num_heads=4,
                                           num_layers=2, max_len=8, mp_axis=mp_axis)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, labels))
        _minimize(pkg, loss, opt)
    return main, startup, loss


def _tfm_feeds():
    rng = np.random.RandomState(1)
    return [{"toks": rng.randint(0, 16, (4, 8)).astype(np.int32),
             "labels": rng.randint(0, 16, (4, 8, 1)).astype(np.int32)} for _ in range(STEPS)]


def _emb(pkg, sharded_axis=None, opt="adam"):
    """The sharded embedding: ids -> table (rows striped over mp) -> pool ->
    fc -> cross entropy."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        w = pkg.layers.data("w", shape=[1], dtype=np.int32, lod_level=1)
        y = pkg.layers.data("y", shape=[1], dtype=np.int64)
        if sharded_axis:
            e = pkg.parallel.sharded_embedding(w, size=[12, 4], mesh_axis=sharded_axis)
        else:
            e = pkg.layers.embedding(w, size=[12, 4])
        pooled = pkg.layers.sequence_pool(e, "sum")
        pred = pkg.layers.fc(pooled, size=3, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, y))
        _minimize(pkg, loss, opt)
    return main, startup, loss


def _emb_feed(step):
    rng = np.random.RandomState(20 + step)
    lens = [3, 1, 4, 2]
    return [rng.randint(0, 12, (n, 1)).astype(np.int32) for n in lens], \
        rng.randint(0, 3, (4, 1)).astype(np.int64)


def _state(main, startup, seed=3):
    sc = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=sc, seed=seed)
    return ptt.io.state_to_numpy(sc, [v.name for v in main.persistables()])


def _lod(seqs, cap=16):
    return ptt.LoDArray.from_sequences(seqs, capacity=cap)


# ------------------------------------------------------ the ranks' side --
def _port_run(main, loss, state, feeds, exe):
    sc = ptt.Scope()
    ptt.io.params_from_numpy(sc, state, "cpu")
    losses = [float(exe.run(main, f, [loss], scope=sc)[0]) for f in feeds]
    return losses, sc


def _gathered(sc, names, mesh):
    """Whole values of a scope some of whose entries are this rank's slices."""
    from paddle_tpu_torch.parallel import all_gather

    out = {}
    for n in names:
        v = sc.get(n)
        info = sc.shards.get(n)
        if info is not None:
            d = next(i for i, (a, b) in enumerate(info["slice"]) if b - a != info["shape"][i])
            ax = "dp" if "dp" in mesh.shape else "mp"
            v = all_gather(v, ax, axis=d, mesh=mesh)
        out[n] = v.numpy()
    return out


def _rank_collectives(rank, mesh):
    from paddle_tpu_torch import parallel as par

    x = torch.arange(8, dtype=torch.float32) + 10 * rank
    out = {"all_reduce": par.all_reduce(x, "dp", mesh), "all_gather": par.all_gather(x, "dp",
                                                                                       mesh=mesh),
           "all_gather_stacked": par.all_gather(x, "dp", tiled=False, mesh=mesh),
           "reduce_scatter": par.reduce_scatter(x, "dp", mesh=mesh),
           "broadcast": par.broadcast(x, "dp", root=1, mesh=mesh),
           "ppermute": par.ppermute_ring(x, "dp", mesh=mesh),
           "ring_all_reduce": par.ring_all_reduce(x.reshape(2, 4), "dp", mesh=mesh),
           "world_all_reduce": par.all_reduce(x, "dp")}
    gx = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    fn = par.shard_map_fn(lambda a: a * (1 + par.process_index()), mesh, [("dp", None)],
                          ("dp", None))
    out["shard_map"] = fn(gx)
    return {f"coll.{k}": v.numpy() for k, v in out.items()}


def _rank_dp(rank, mesh):
    from paddle_tpu_torch.parallel import ParallelExecutor

    out = {}
    ptt.reset_default_programs()
    main, startup, loss = _mlp(ptt)
    state = _state(main, startup)
    names = sorted(state)
    for zero in (False, True):
        exe = ParallelExecutor(mesh, shard_optimizer_state=zero, device="cpu")
        losses, sc = _port_run(main, loss, state, _mlp_feeds(), exe)
        tag = "zero" if zero else "dp"
        out[f"{tag}.losses"] = np.array(losses)
        full = _gathered(sc, names, mesh)
        out.update({f"{tag}.p.{n}": full[n] for n in names})
        if zero:
            out["zero.sliced"] = np.array(sorted(sc.shards), dtype=object).astype(str)
            m = next(n for n in sorted(sc.shards)
                     if ".moment1." in n and sc.shards[n]["shape"] == [8, 16])
            out["zero.local_shape"] = np.array(sc.get(m).shape)
    out["dp.state0"] = np.array(0)
    # a ragged feed whose ranks hold unequal token counts
    ptt.reset_default_programs()
    main, startup, loss = _ragged(ptt)
    state = _state(main, startup)
    feeds = []
    for s in range(STEPS):
        feeds.append({"w": _lod(_ragged_seqs(s))})
    exe = ParallelExecutor(mesh, device="cpu")
    losses, sc = _port_run(main, loss, state, feeds, exe)
    out["ragged.losses"] = np.array(losses)
    out.update({f"ragged.p.{n}": sc.get(n).numpy() for n in sorted(state)})
    return out


def _rank_mp(rank, mesh):
    from paddle_tpu_torch.parallel import ParallelExecutor

    out = {}
    for kind, build, feeds in (
            ("tfm", lambda: _tfm(ptt, mp_axis="mp"), _tfm_feeds()),
            ("emb", lambda: _emb(ptt, sharded_axis="mp"),
             [{"w": _lod(_emb_feed(s)[0]), "y": _emb_feed(s)[1]} for s in range(STEPS)])):
        ptt.reset_default_programs()
        main, startup, loss = build()
        state = _state(main, startup)
        exe = ParallelExecutor(mesh, device="cpu")
        losses, sc = _port_run(main, loss, state, feeds, exe)
        out[f"{kind}.losses"] = np.array(losses)
        out.update({f"{kind}.p.{n}": v for n, v in _gathered(sc, sorted(state), mesh).items()})
        out.update({f"{kind}.s0.{n}": v for n, v in state.items()})
        out[f"{kind}.sliced"] = np.array(sorted(sc.shards)).astype(str)
    return out


def _rank_dp_pp(rank):
    """dp2 x pp2: each rank pipelines its 4 rows in 4 micro-batches over 2
    stages (two CPU devices a rank)."""
    from paddle_tpu_torch.parallel import mesh_from_spec

    ptt.reset_default_programs()
    main, startup, loss = _mlp(ptt)
    state = _state(main, startup)
    exe = ptt.PipelineExecutor("cpu", num_stages=2, num_microbatches=4,
                               mesh=mesh_from_spec("dp2,pp2", devices=["cpu", "cpu"]))
    losses, sc = _port_run(main, loss, state, _mlp_feeds(), exe)
    out = {f"dppp.p.{n}": sc.get(n).numpy() for n in state}
    out["dppp.losses"] = np.array(losses)
    return out


def _sgd_cases():
    """case -> (builder(pkg), the port's feeds, the mesh spec) of the SGD
    checks: dp2, a ragged dp2, mp2 (mp_axis, the sharded embedding) and
    dp2 x pp2."""
    return {
        "dp2": (lambda p: _mlp(p, opt="sgd"), _mlp_feeds(), "dp2"),
        "ragged": (lambda p: _ragged(p, opt="sgd"),
                   [{"w": _lod(_ragged_seqs(s))} for s in range(STEPS)], "dp2"),
        "mp_tfm": (lambda p: _tfm(p, mp_axis="mp", opt="sgd"), _tfm_feeds(), "mp2"),
        "mp_emb": (lambda p: _emb(p, sharded_axis="mp", opt="sgd"),
                   [{"w": _lod(_emb_feed(s)[0]), "y": _emb_feed(s)[1]} for s in range(STEPS)],
                   "mp2"),
        "dp2_pp2": (lambda p: _mlp(p, opt="sgd"), _mlp_feeds(), "dp2,pp2"),
    }


def _rank_sgd(rank):
    from paddle_tpu_torch.parallel import ParallelExecutor, mesh_from_spec

    out = {}
    for case, (build, feeds, spec) in _sgd_cases().items():
        ptt.reset_default_programs()
        main, startup, loss = build(ptt)
        state = _state(main, startup)
        if "pp" in spec:
            mesh = mesh_from_spec(spec, devices=["cpu", "cpu"])
            exe = ptt.PipelineExecutor("cpu", num_stages=2, num_microbatches=4, mesh=mesh)
        else:
            mesh = mesh_from_spec(spec)
            exe = ParallelExecutor(mesh, device="cpu")
        losses, sc = _port_run(main, loss, state, feeds, exe)
        out[f"sgd.{case}.losses"] = np.array(losses)
        out.update({f"sgd.{case}.p.{n}": v for n, v in _gathered(sc, sorted(state),
                                                                   mesh).items()})
        out.update({f"sgd.{case}.s0.{n}": v for n, v in state.items()})
    return out


def _rank_main(rank, init, out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel import distributed, mesh_from_spec

    distributed.init_distributed(init, WORLD, rank, device="cpu")
    try:
        out = {}
        dp = mesh_from_spec("dp2")
        out.update(_rank_collectives(rank, dp))
        out.update(_rank_dp(rank, dp))
        out.update(_rank_mp(rank, mesh_from_spec("mp2")))
        out.update(_rank_dp_pp(rank))
        out.update(_rank_sgd(rank))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("ranks")
    init = f"file://{d / 'rendezvous'}"
    mp.spawn(_rank_main, args=(init, str(d)), nprocs=WORLD, join=True)
    return [dict(np.load(d / f"rank{r}.npz", allow_pickle=False)) for r in range(WORLD)]


# ------------------------------------------------------------- the tests --
def test_collectives_against_numpy(ranks):
    x = [np.arange(8, dtype=np.float32) + 10 * r for r in range(WORLD)]
    total = x[0] + x[1]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["coll.all_reduce"], total)
        np.testing.assert_array_equal(got["coll.world_all_reduce"], total)
        np.testing.assert_array_equal(got["coll.all_gather"], np.concatenate(x))
        np.testing.assert_array_equal(got["coll.all_gather_stacked"], np.stack(x))
        np.testing.assert_array_equal(got["coll.reduce_scatter"], total[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(got["coll.broadcast"], x[1])
        np.testing.assert_array_equal(got["coll.ppermute"], x[(r - 1) % WORLD])
        np.testing.assert_array_equal(got["coll.ring_all_reduce"], total.reshape(2, 4))
        gx = np.arange(16, dtype=np.float32).reshape(4, 4)
        np.testing.assert_array_equal(got["coll.shard_map"],
                                      np.concatenate([gx[:2] * 1, gx[2:] * 2]))


def test_dp2_is_the_whole_batch(ranks):
    ptt.reset_default_programs()
    main, startup, loss = _mlp(ptt)
    state = _state(main, startup)
    want_l, sc = _port_run(main, loss, state, _mlp_feeds(), ptt.Executor(device="cpu"))
    for r in ranks:
        np.testing.assert_allclose(r["dp.losses"], want_l, rtol=1e-6)
        for n in state:
            np.testing.assert_allclose(r[f"dp.p.{n}"], sc.get(n).numpy(), atol=1e-6,
                                       rtol=0, err_msg=n)
    for n in state:
        np.testing.assert_array_equal(ranks[0][f"dp.p.{n}"], ranks[1][f"dp.p.{n}"])


def test_zero1_gives_the_replicated_bits(ranks):
    for r in ranks:
        sliced = list(r["zero.sliced"])
        assert sum(".moment1." in n for n in sliced) == 3, sliced  # fc_1's bias [1] is not
        np.testing.assert_array_equal(r["zero.local_shape"], [4, 16])  # rows 8 / dp2
        np.testing.assert_array_equal(r["zero.losses"], r["dp.losses"])
        for k in r:
            if k.startswith("dp.p."):
                np.testing.assert_array_equal(r["zero." + k[3:]], r[k], err_msg=k)


def test_dp2_against_jax_parallel_executor_on_mesh8(ranks):
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu import parallel as jpar

    ptt.reset_default_programs()
    pmain, pstartup, _ = _mlp(ptt)
    state = _state(pmain, pstartup)
    pt.reset()
    main, _, loss = _mlp(pt)
    scope = pt.global_scope()
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    exe = jpar.ParallelExecutor(jpar.make_mesh())
    jl = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])) for f in _mlp_feeds()]
    for r in ranks:
        np.testing.assert_allclose(r["dp.losses"], jl, rtol=1e-6)
        for n in state:
            np.testing.assert_allclose(r[f"dp.p.{n}"], np.asarray(scope.get(n)), atol=1e-6,
                                       rtol=0, err_msg=n)


def test_ragged_feed_weights_each_rank_by_its_tokens(ranks):
    ptt.reset_default_programs()
    main, startup, loss = _ragged(ptt)
    state = _state(main, startup)
    feeds = []
    for s in range(STEPS):
        feeds.append({"w": _lod(_ragged_seqs(s))})
    want_l, sc = _port_run(main, loss, state, feeds, ptt.Executor(device="cpu"))
    for r in ranks:
        np.testing.assert_allclose(r["ragged.losses"], want_l, rtol=1e-6)
        for n in state:
            np.testing.assert_allclose(r[f"ragged.p.{n}"], sc.get(n).numpy(), atol=1e-6,
                                       rtol=0, err_msg=n)


def _jax_train(build, state, feeds):
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu.models  # noqa: F401
    import paddle_tpu.parallel  # noqa: F401

    pt.reset()
    main, _, loss = build(pt)
    scope = pt.global_scope()
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    exe = pt.Executor()
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])) for f in feeds]
    return losses, {n: np.asarray(scope.get(n)) for n in state}


# the key projection's bias: a per-row shift of the scores leaves softmax
# unchanged, so its gradient is 0 in exact arithmetic and rounding noise in
# both packages, which Adam scales up to steps of about lr
# (tests/test_torch_transformer.py holds it apart too)
_NULL_GRAD = ".attn.wk_b"


def test_mp_axis_transformer_against_jax_unsharded(ranks):
    r0 = ranks[0]
    state = {k[len("tfm.s0."):]: v for k, v in r0.items() if k.startswith("tfm.s0.")}
    want_l, want = _jax_train(_tfm, state, _tfm_feeds())
    assert "tfm.h0.attn.wq" in list(r0["tfm.sliced"])
    assert "tfm.out_w" in list(r0["tfm.sliced"])
    for r in ranks:
        np.testing.assert_allclose(r["tfm.losses"], want_l, rtol=1e-5)
        for n in state:
            if _NULL_GRAD in n:
                continue
            np.testing.assert_allclose(r[f"tfm.p.{n}"], want[n], atol=1e-5, rtol=0, err_msg=n)


def test_sharded_embedding_against_jax_unsharded(ranks):
    import paddle_tpu as pt

    r0 = ranks[0]
    state = {k[len("emb.s0."):]: v for k, v in r0.items() if k.startswith("emb.s0.")}
    feeds = []
    for s in range(STEPS):
        ws, y = _emb_feed(s)
        feeds.append({"w": pt.LoDArray.from_sequences(ws, capacity=16), "y": y})
    # the same program on the JAX package's single-device Executor: the
    # table whole, its placement unused
    want_l, want = _jax_train(lambda p: _emb(p, sharded_axis="mp"), state, feeds)
    # the table and its moments, striped by rows
    assert sorted(n.split(".")[-2] for n in r0["emb.sliced"]) == ["sharded_embedding_0"] * 3
    for r in ranks:
        np.testing.assert_allclose(r["emb.losses"], want_l, rtol=1e-5)
        for n in state:
            np.testing.assert_allclose(r[f"emb.p.{n}"], want[n], atol=1e-5, rtol=0, err_msg=n)


def _jax_sgd_reference(case, state):
    """The JAX package's losses and parameters for an SGD case: dp2 on its
    ParallelExecutor over the 8-device CPU mesh, dp2 x pp2 on its
    PipelineExecutor (2 stages, 8 micro-batches of the 8 rows), the rest on
    its Executor with the whole batch and unsharded tables."""
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu import parallel as jpar

    if case in ("ragged", "mp_emb"):
        build = _ragged if case == "ragged" else (lambda p, opt: _emb(p, "mp", opt))
        feeds = []
        for s in range(STEPS):
            if case == "ragged":
                feeds.append({"w": pt.LoDArray.from_sequences(_ragged_seqs(s), capacity=16)})
            else:
                ws, y = _emb_feed(s)
                feeds.append({"w": pt.LoDArray.from_sequences(ws, capacity=16), "y": y})
        return _jax_train(lambda p: build(p, opt="sgd"), state, feeds)
    if case == "mp_tfm":
        return _jax_train(lambda p: _tfm(p, opt="sgd"), state, _tfm_feeds())
    import paddle_tpu.pipeline  # noqa: F401

    pt.reset()
    main, _, loss = _mlp(pt, opt="sgd")
    scope = pt.global_scope()
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    exe = jpar.ParallelExecutor(jpar.make_mesh()) if case == "dp2" else \
        pt.pipeline.PipelineExecutor(num_stages=2, num_microbatches=8)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0]))
              for f in _mlp_feeds()]
    return losses, {n: np.asarray(scope.get(n)) for n in state}


@pytest.mark.parametrize("case", ["dp2", "ragged", "mp_tfm", "mp_emb", "dp2_pp2"])
def test_sgd_steps_against_jax(ranks, case):
    """Three SGD steps, whose update is the gradient times the rate, so a
    gradient scaled wrong (summed over ranks instead of averaged, a
    micro-batch's loss seeded 1 instead of 1/M, an all-reduce taken twice)
    shows in the parameters as it would not under Adam. The bounds are the
    Adam checks': 1e-6 for dp and the pipeline, 1e-5 for mp."""
    tol = 1e-5 if case.startswith("mp") else 1e-6
    pre = f"sgd.{case}."
    state = {k[len(pre) + 3:]: v for k, v in ranks[0].items() if k.startswith(pre + "s0.")}
    want_l, want = _jax_sgd_reference(case, state)
    for r in ranks:
        np.testing.assert_allclose(r[pre + "losses"], want_l, rtol=tol)
        for n in state:
            np.testing.assert_allclose(r[f"{pre}p.{n}"], want[n], atol=tol, rtol=0,
                                       err_msg=n)
    moved = max(float(np.abs(want[n] - state[n]).max()) for n in state)
    assert moved > 100 * tol, moved  # the steps move the parameters well past the bound


def test_mesh_spec_and_placements():
    from paddle_tpu_torch import parallel as par

    assert par.parse_mesh_spec("dp2,pp2") == (("dp", 2), ("pp", 2))
    for bad, msg in (("ddp8", "unknown mesh axis"), ("dp2,dp2", "duplicate"), ("", "empty"),
                     ("dpx", "bad mesh axis")):
        with pytest.raises(ValueError, match=msg):
            par.parse_mesh_spec(bad)
    mesh = par.mesh_from_spec("dp1")
    assert par.replicated(mesh).spec == ()
    assert par.batch_sharded(mesh, ndim=3).spec == ("dp", None, None)
    assert par.dim_sharded(mesh, 1, "mp", 2).spec == (None, "mp")
    with pytest.raises(ValueError, match="processes"):
        par.mesh_from_spec("dp2")
    assert (par.process_count(), par.process_index(), par.is_chief()) == (1, 0, True)


def test_programs_match_jax_dicts():
    """mp_axis and the sharded embedding build the JAX package's programs."""
    import paddle_tpu as pt
    import paddle_tpu.models  # noqa: F401
    import paddle_tpu.parallel  # noqa: F401

    for build in (lambda p: _tfm(p, mp_axis="mp"), lambda p: _emb(p, sharded_axis="mp")):
        pt.reset()
        jmain = build(pt)[0]
        ptt.reset_default_programs()
        pmain = build(ptt)[0]
        assert pmain.to_dict() == jmain.to_dict()
        jv, pv = jmain.global_block().vars, pmain.global_block().vars
        for n, v in jv.items():
            if getattr(v, "sharding", None) is not None:
                assert pv[n].sharding == tuple(v.sharding), n


def test_dp2_pp2_pipeline_is_the_whole_batch(ranks):
    """Two ranks of 4 rows, each in 4 micro-batches of 1 over 2 stages,
    against one process pipelining the 8 rows in 8 micro-batches: the same
    per-row gradients, averaged in another order (within 1e-6)."""
    ptt.reset_default_programs()
    main, startup, loss = _mlp(ptt)
    state = _state(main, startup)
    exe = ptt.PipelineExecutor("cpu", num_stages=2, num_microbatches=8)
    want_l, sc = _port_run(main, loss, state, _mlp_feeds(), exe)
    for r in ranks:
        np.testing.assert_allclose(r["dppp.losses"], want_l, rtol=1e-6)
        for n in state:
            np.testing.assert_allclose(r[f"dppp.p.{n}"], sc.get(n).numpy(), atol=1e-6,
                                       rtol=0, err_msg=n)
    for n in state:
        np.testing.assert_array_equal(ranks[0][f"dppp.p.{n}"], ranks[1][f"dppp.p.{n}"])


def test_trainer_falls_back_loudly_on_a_mesh_executor(caplog):
    """The Trainer's window fallback names the PipelineExecutor, and
    neither mesh executor is prefetched to one device."""
    import logging

    from paddle_tpu_torch import parallel as par

    ptt.reset_default_programs()
    main, startup, loss = _mlp(ptt)
    sc = ptt.Scope()
    exe = par.ParallelExecutor(par.mesh_from_spec("dp1"), device="cpu")
    assert (exe.prefetch_by_default, exe.device_metric_accumulation,
            exe.scan_window_supported) == (False, False, False)
    pipe = ptt.PipelineExecutor("cpu", mesh=par.mesh_from_spec("pp2", devices=["cpu"] * 2))
    assert not pipe.scan_window_supported and ptt.PipelineExecutor("cpu").scan_window_supported
    t = ptt.Trainer(loss, main_program=main, startup_program=startup, scope=sc, executor=exe)
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.trainer"):
        t.train(lambda: iter(_mlp_feeds()[:2]), num_passes=1, scan_window=2)
    t.stop()
    assert any("PipelineExecutor" in r.message for r in caplog.records)
    assert t.step == 2


def test_handoff_rows_cross_as_host_rows():
    """pipeline's handoff pair is serving's (one implementation): the rows
    cross as host tensors of their own dtype, and a mesh restore raises,
    naming A10b."""
    from paddle_tpu_torch.pipeline import gather_handoff_rows, restore_handoff_rows
    from paddle_tpu_torch.serving.disagg import handoff

    assert (gather_handoff_rows, restore_handoff_rows) == (handoff.gather_handoff_rows,
                                                           handoff.restore_handoff_rows)
    a = [torch.arange(12.).reshape(4, 3).to(torch.bfloat16), torch.arange(4)]
    host = gather_handoff_rows(a, 2)
    assert host[0].dtype == torch.bfloat16 and host[0].device.type == "cpu"
    np.testing.assert_array_equal(host[0].float().numpy(), np.arange(6.).reshape(2, 3))
    np.testing.assert_array_equal(host[1].numpy(), [0, 1])
    back = restore_handoff_rows(host, "cpu")
    assert torch.equal(back[1], torch.tensor([0, 1]))
    with pytest.raises(NotImplementedError, match="A10b"):
        restore_handoff_rows(host, "cpu", mesh=object())


def test_batch_statistics_refused_over_dp():
    """Train-mode batch_norm over a dp axis of 2 raises (no sync BN) before
    anything runs; the JAX package computes it over the global batch."""
    from paddle_tpu_torch import parallel as par

    class Dp2:
        shape = {"dp": 2}
        axis_names = ("dp",)

        def size(self, axis):
            return 2 if axis == "dp" else 1

    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[8])
        h = ptt.layers.batch_norm(ptt.layers.fc(x, size=8))
        ptt.optimizer.SGD(0.1).minimize(ptt.layers.mean(h))
    sc = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=sc)
    exe = par.ParallelExecutor(Dp2(), device="cpu")
    with pytest.raises(NotImplementedError, match="sync batch norm"):
        exe.run(main, {"x": np.zeros((4, 8), np.float32)}, [], scope=sc)
