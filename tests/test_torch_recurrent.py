"""The recurrent groups through the port against the JAX package:
`recurrent_group` (RecurrentGroup / StaticRNN and the functional form) and
`nested_recurrent_group` (NestedRecurrentGroup), built by both front ends
(equal program dicts) and run from one numpy state (the JAX startup's)
on the same seeded feeds.

- Forward, f32, within 1e-5 of each output's scale (the largest |value|,
  at least 1): a forward and a reversed group, a memory booted from a
  variable, an int memory counting the frames (exact), the final memories.
- Training, three Adam steps: the losses and every parameter after each
  step within 1e-5 (f32) of their scale; under bf16 amp within 2e-2 (a
  bf16 ulp at that scale), the JAX side compiled with XLA's excess
  precision off so that it rounds where its ops round.
- The nested group over uneven sub-sequences, some cut by max_subseqs and
  max_sublen, forward and two SGD steps, f32 within 1e-5.
- The port alone: a dropout in the step draws a fresh mask each frame and
  the same masks for the same seed, and under memory_optimize the group
  runs between segments (its `runs_once` rule), the plain step's bits.

The JAX side of each case is run once for the module (`_jax`).
"""

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import registry as treg

TOL = {None: 1e-5, "bfloat16": 2e-2}
D, H, B = 3, 4, 4
LENS = (5, 2, 7, 3)
NESTED = [[3, 1, 5], [2, 4], [6], [1, 2, 3, 2]]  # tokens of each sub-sequence
S_CUT, L_CUT = 3, 4  # the nested group's max_subseqs and max_sublen: both cut


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset(m):
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()


def _group(m, case):
    """x -> RecurrentGroup(h = tanh(fc([x_t, h_prev]))) -> mean of the
    summed sequence; `case` picks the variant."""
    x = m.layers.data("x", shape=[-1, D], lod_level=1, append_batch_size=False)
    boot = m.layers.data("h0", shape=[H]) if case == "boot" else None
    if case == "functional":
        def step(x_t, rnn):
            h_prev = rnn.memory(shape=[H])
            h = m.layers.fc(m.layers.concat([x_t, h_prev], axis=1), size=H, act="tanh")
            rnn.update_memory(h_prev, h)
            return h

        out = m.layers.recurrent_group(step, x, max_len=8)
        finals = []
    else:
        rnn = m.layers.StaticRNN(is_reverse=case == "reverse", max_len=8)
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=boot) if boot is not None else rnn.memory(shape=[H])
            if case == "int_mem":
                count = rnn.memory(shape=[1], dtype=np.int32, init_value=2)
                rnn.update_memory(count, m.layers.increment(count))
            h = m.layers.fc(m.layers.concat([x_t, h_prev], axis=1), size=H, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()
        finals = list(rnn.final_memories)
    loss = m.layers.mean(m.layers.sequence_pool(out, "sum"))
    return out, finals, loss


def _nested(m, _case):
    x = m.layers.data("x", shape=[-1, D], lod_level=2, append_batch_size=False)
    rnn = m.layers.NestedRecurrentGroup(max_subseqs=S_CUT, max_sublen=L_CUT)
    with rnn.step():
        sub, sub_mask = rnn.step_input(x)
        h_prev = rnn.memory(shape=[H])
        mk = m.layers.cast(sub_mask, np.float32)
        summed = m.layers.reduce_sum(m.layers.elementwise_mul(sub, mk, axis=0), dim=1)
        cnt = m.layers.clip(m.layers.reduce_sum(mk, dim=1), 1.0, 1e9)
        mean = m.layers.elementwise_div(summed, cnt, axis=0)
        h = m.layers.fc(m.layers.concat([mean, h_prev], axis=1), size=H, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()
    loss = m.layers.mean(m.layers.sequence_pool(out, "sum"))
    return out, list(rnn.final_memories), loss


def _build(m, model, case, train=None, amp=None):
    _reset(m)
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 11
    with m.program_guard(prog, startup):
        out, finals, loss = model(m, case)
        if train == "adam":
            m.optimizer.Adam(learning_rate=0.01).minimize(loss)
        elif train == "sgd":
            m.optimizer.SGD(learning_rate=0.5).minimize(loss)
    if amp:
        prog.set_amp(amp)
    return prog, startup, [out] + finals + [loss]


def _feed_arrays(model, case, step=0):
    rng = np.random.RandomState(3 + step)
    if model is _nested:
        xs = [[rng.randn(n, D).astype(np.float32) for n in para] for para in NESTED]
        return {"x": xs}
    feed = {"x": [rng.randn(n, D).astype(np.float32) for n in LENS]}
    if case == "boot":
        feed["h0"] = rng.randn(B + 1, H).astype(np.float32)
    return feed


def _feed(pkg, arrays):
    lod = JLoD if pkg is pt else ptt.LoDArray
    out = {}
    for k, v in arrays.items():
        if not isinstance(v, list):
            out[k] = v
        elif isinstance(v[0], list):
            out[k] = lod.from_nested_sequences(v, capacity=32, max_seqs=B + 1)
        else:
            out[k] = lod.from_sequences(v, capacity=32, max_seqs=B + 1)
    return out


def _host(v):
    if hasattr(v, "seq_ids"):  # a LoDArray of either package
        return np.asarray(v.data.float() if isinstance(v.data, torch.Tensor) else v.data)
    return np.asarray(v.float() if isinstance(v, torch.Tensor) else v)


def _jax_exec(amp):
    exe = pt.Executor()
    if amp != "bfloat16":
        return exe, lambda f: f()
    import jax

    def no_excess(f):
        jit = jax.jit
        try:
            jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
            return f()
        finally:
            jax.jit = jit
    return exe, no_excess


@functools.lru_cache(maxsize=None)
def _jax(model, case, train, amp, steps):
    """The JAX side: (program dict, startup state, fetches of each step,
    parameters after each step)."""
    prog, startup, fetch = _build(pt, model, case, train, amp)
    exe, wrap = _jax_exec(amp)
    exe.run(startup)
    sc = pt.global_scope()
    state = {v.name: np.array(np.asarray(sc.get(v.name)))
             for v in prog.persistables() if sc.has(v.name)}
    outs, params = [], []
    for i in range(steps):
        feed = _feed(pt, _feed_arrays(model, case, i))
        got = wrap(lambda: exe.run(prog, feed=feed, fetch_list=fetch, return_numpy=False))
        outs.append([_host(g) for g in got])
        params.append({p.name: np.array(np.asarray(sc.get(p.name))) for p in prog.parameters()})
    return prog.to_dict(), state, outs, params


def _port(model, case, train, amp, steps, state):
    prog, _, fetch = _build(ptt, model, case, train, amp)
    exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
    tio.params_from_numpy(scope, state, "cpu")
    outs, params = [], []
    for i in range(steps):
        got = exe.run(prog, _feed(ptt, _feed_arrays(model, case, i)), fetch, scope=scope,
                      return_numpy=False)
        outs.append([_host(g) for g in got])
        params.append({p.name: scope.get(p.name).float().numpy() for p in prog.parameters()})
    return prog.to_dict(), outs, params


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert got.shape == want.shape and err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("model,case,train,amp,steps", [
    (_group, "forward", None, None, 1),
    (_group, "reverse", None, None, 1),
    (_group, "boot", None, None, 1),
    (_group, "int_mem", None, None, 1),
    (_group, "functional", None, None, 1),
    (_group, "forward", "adam", None, 3),
    (_group, "forward", "adam", "bfloat16", 3),
    (_nested, "nested", None, None, 1),
    (_nested, "nested", "sgd", None, 2),
], ids=["forward", "reverse", "boot", "int_mem", "functional", "adam-f32", "adam-bf16",
        "nested", "nested-sgd"])
def test_group_matches_jax(model, case, train, amp, steps, one_thread):
    jdict, state, jouts, jparams = _jax(model, case, train, amp, steps)
    tdict, touts, tparams = _port(model, case, train, amp, steps, state)
    assert tdict == jdict
    tol = TOL[amp]
    for i, (tout, jout) in enumerate(zip(touts, jouts)):
        for k, (t, j) in enumerate(zip(tout, jout)):
            if j.dtype.kind in "iu":
                np.testing.assert_array_equal(t, j)
            else:
                _close(t, j, tol, f"step {i} fetch {k}")
        for name, want in jparams[i].items():
            _close(tparams[i][name], want, tol, f"step {i} {name}")
    if case == "int_mem":  # the counter froze at each sequence's end: 2 + length
        np.testing.assert_array_equal(touts[0][2][:B, 0], 2 + np.array(LENS))
    if model is _nested:  # one token a sub-sequence, at most S_CUT a sequence
        lens = [min(len(p), S_CUT) for p in NESTED]
        assert touts[0][0].shape[0] == (B + 1) * S_CUT
        assert np.all(touts[0][0][sum(lens):] == 0)


def _dropout_group(m, p=0.5):
    x = m.layers.data("x", shape=[-1, 16], lod_level=1, append_batch_size=False)
    rnn = m.layers.RecurrentGroup(max_len=6)
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[16])
        h = m.layers.elementwise_add(m.layers.dropout(x_t, dropout_prob=p), h_prev)
        rnn.update_memory(h_prev, h)
        rnn.step_output(m.layers.dropout(x_t, dropout_prob=p))
    out = rnn()
    loss = m.layers.mean(m.layers.fc(m.layers.sequence_pool(out, "sum"), size=1))
    return x, out, loss


def test_dropout_in_the_step_draws_once_a_frame(one_thread):
    """A fresh mask each frame, the same masks for the same seed, and under
    memory_optimize the group runs between segments: its rule says it runs
    once, the step's bits are the plain step's."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        _, out, loss = _dropout_group(ptt)
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    feed = {"x": ptt.LoDArray.from_sequences([np.ones((6, 16), np.float32)] * 2, capacity=16)}
    runs = []
    for policy in (None, None, "full"):
        prog.remat_policy = policy
        exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
        exe.run(startup, scope=scope, seed=1)
        got = exe.run(prog, feed, [out, loss], scope=scope, seed=7, return_numpy=False)
        runs.append((got[0].data.clone(), {p.name: scope.get(p.name) for p in
                                           prog.parameters()}))
    frames = runs[0][0][:6]
    assert set(torch.unique(frames).tolist()) == {0.0, 1.0}  # kept or dropped
    assert len({tuple(f.tolist()) for f in frames}) == 6  # a fresh mask each frame
    for data, params in runs[1:]:
        assert torch.equal(data, runs[0][0])
        for n, v in params.items():
            assert torch.equal(v, runs[0][1][n]), n
    group = next(op for op in prog.global_block().ops if op.type == "recurrent_group")
    env = {treg.PROGRAM_KEY: prog}
    assert treg.runs_once(group, env)
    for op in prog.blocks[group.attrs["sub_block"]].ops:
        if op.type == "dropout":
            op.attrs["is_test"] = True
    assert not treg.runs_once(group, env)


# ------------------------------------------------------ the sequence ops

SEQ_LENS = (4, 1, 6, 3)


def _lod(seqs, nested=False):
    """(JAX LoDArray, port LoDArray) of the same numpy sequences, capacity
    32, one absent sequence past them."""
    make = "from_nested_sequences" if nested else "from_sequences"
    return (getattr(JLoD, make)(seqs, capacity=32, max_seqs=len(seqs) + 1),
            getattr(ptt.LoDArray, make)(seqs, capacity=32, max_seqs=len(seqs) + 1))


def _seq_cases():
    rng = np.random.RandomState(9)
    seqs = lambda d, dt=np.float32: [rng.randn(n, d).astype(dt) for n in SEQ_LENS]  # noqa
    ties = [np.round(rng.rand(n, 1) * 2).astype(np.float32) for n in SEQ_LENS]  # 0, 1, 2
    ids = [rng.randint(0, 4, (n, 1)).astype(np.int32) for n in SEQ_LENS]
    nested = [[rng.randn(n, 2).astype(np.float32) for n in para] for para in NESTED]
    dense = lambda *a: (np.asarray(*a), np.asarray(*a))  # noqa: E731
    return [
        ("sequence_softmax", {"X": _lod(seqs(1))}, {}),
        ("sequence_softmax-1d", {"X": _lod([s[:, 0] for s in seqs(1)])}, {}),
        ("sequence_expand", {"X": dense(rng.randn(5, 3).astype(np.float32)),
                             "Y": _lod(seqs(2))}, {}),
        ("sequence_last_step", {"X": _lod(seqs(3))}, {}),
        ("sequence_slice", {"X": _lod(seqs(2)), "Offset": dense(np.array([1, 0, 2, 1], np.int32)),
                            "Length": dense(np.array([2, 3, 9, 1], np.int64))}, {}),
        ("sequence_reshape", {"X": _lod(seqs(4))}, {"new_dim": 2}),
        ("sequence_reverse", {"X": _lod(seqs(3))}, {}),
        ("kmax_seq_score", {"X": _lod(ties)}, {"beam_size": 3}),
        ("sub_nested_seq", {"X": _lod(nested, nested=True),
                            "Selection": dense(np.array([3, 0, -1, 7, 5], np.int32))}, {}),
        ("featmap_expand", {"X": _lod(seqs(2))}, {"num_filters": 3}),
        ("featmap_expand-elem", {"X": _lod(seqs(2))}, {"num_filters": 3,
                                                       "as_row_vector": False}),
        ("eos_id", {"X": _lod(ids)}, {"eos_id": 2}),
        ("eos_id-dense", {"X": dense(np.concatenate(ids))}, {"eos_id": 2}),
    ]


def _bf16(pair):
    import jax.numpy as jnp

    j, t = pair
    if isinstance(t, ptt.LoDArray):
        return j.with_data(j.data.astype(jnp.bfloat16)), t.with_data(t.data.to(torch.bfloat16))
    return pair


@pytest.mark.parametrize("amp", [None, "bfloat16"])
@pytest.mark.parametrize("case", _seq_cases(), ids=lambda c: c[0])
def test_sequence_op_matches_jax(case, amp):
    """Each op on the same inputs in both packages: equal layouts (seq_ids,
    lengths, num_seqs), and data within 1e-6 of its scale in f32 and 2e-2
    in bf16 (sequence_softmax computes; the others move values: equal)."""
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp
    from paddle_tpu_torch.core.program import Operator as TOp

    name, inputs, attrs = case
    op_type = name.split("-")[0]
    if amp:
        inputs = {k: _bf16(v) for k, v in inputs.items()}
    slots = {k: [k] for k in inputs}
    jenv = {k: (j if hasattr(j, "seq_ids") else jnp.asarray(j)) for k, (j, _) in inputs.items()}
    tenv = {k: (t if isinstance(t, ptt.LoDArray) else torch.as_tensor(t))
            for k, (_, t) in inputs.items()}
    jenv["@AMP@"] = tenv["@AMP@"] = amp
    jreg.get_kernel(op_type)(jreg.OpContext(JOp(op_type, slots, {"Out": ["out"]}, attrs), jenv))
    treg.get_kernel(op_type)(treg.OpContext(TOp(op_type, slots, {"Out": ["out"]}, attrs), tenv))
    j, t = jenv["out"], tenv["out"]
    if hasattr(j, "seq_ids"):
        for f in ("seq_ids", "lengths", "num_seqs"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
        j, t = j.data, t.data
    jd, td = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j), t
    td = (td.float() if td.dtype == torch.bfloat16 else td).numpy()
    assert td.shape == jd.shape and (td.dtype == jd.dtype or amp), (td.dtype, jd.dtype)
    if op_type == "sequence_softmax":
        np.testing.assert_allclose(td, jd, rtol=0, atol=(TOL[amp] if amp else 1e-6))
    else:
        np.testing.assert_array_equal(td, jd)


def _seq_layers(m):
    x = m.layers.data("x", shape=[-1, 4], lod_level=1, append_batch_size=False)
    x2 = m.layers.data("x2", shape=[-1, 4], lod_level=2, append_batch_size=False)
    d = m.layers.data("d", shape=[4])
    off = m.layers.data("off", shape=[1], dtype=np.int32)
    sel = m.layers.data("sel", shape=[3], dtype=np.int32, append_batch_size=False)
    s = m.layers.fc(x, size=1)
    return [m.layers.sequence_softmax(s), m.layers.sequence_expand(d, x),
            m.layers.sequence_last_step(x), m.layers.sequence_slice(x, off, off),
            m.layers.sequence_reshape(x, 2), m.layers.sequence_reverse(x),
            m.layers.kmax_seq_score(s, beam_size=2), m.layers.sub_nested_seq(x2, sel),
            m.layers.featmap_expand(x, 3), m.layers.eos_id(off, 1)]


def test_sequence_layers_build_the_jax_program():
    (jprog, _, _), (tprog, _, _) = (_build(m, lambda m, _: (None, _seq_layers(m), None), None)
                                    for m in (pt, ptt))
    assert tprog.to_dict() == jprog.to_dict()


def test_two_level_lod_and_its_artifact(tmp_path):
    """A 2-level batch is the JAX package's leaf for leaf, keeps its
    sub-sequences through to/with_data/from_batch, and a nested-group
    program saved by the JAX package (lod_level 2 feed) loads and runs in
    the port on the JAX side's outputs."""
    seqs = [[np.full((n, 2), 10 * i + j, np.float32) for j, n in enumerate(p)]
            for i, p in enumerate(NESTED)]
    j, t = _lod(seqs, nested=True)
    assert len(t.leaves()) == 5
    for a, b in zip(t.to("cpu").leaves(), (j.data, j.seq_ids, j.lengths, j.num_seqs,
                                           j.sub_seq_ids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dense, mask = t.to_batch(10)
    back = ptt.LoDArray.from_batch(dense, mask, t.with_data(t.data * 0))
    assert back.sub_seq_ids is t.sub_seq_ids and torch.equal(back.data, t.data)
    jprog, jstart, fetch = _build(pt, _nested, "nested")
    exe = pt.Executor()
    exe.run(jstart)
    feed = _feed(pt, _feed_arrays(_nested, "nested"))
    want = np.asarray(exe.run(jprog, feed=feed, fetch_list=[fetch[0]], return_numpy=False)[0].data)
    d = str(tmp_path / "nested")
    pt.io.save_inference_model(d, ["x"], [fetch[0]], main_program=jprog)
    scope = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(d, scope=scope, device="cpu")
    assert prog.global_block().var("x").lod_level == 2 and feeds == ["x"]
    (got,) = ptt.Executor(device="cpu").run(prog, _feed(ptt, _feed_arrays(_nested, "nested")),
                                            fetches, scope=scope, return_numpy=False)
    _close(got.data.numpy(), want, TOL[None], "nested artifact")


def test_group_inside_a_remat_segment(one_thread):
    """Without a draw the group is checkpointed with its neighbours: the
    segment takes the values its step closes over (the fc's parameters),
    and two Adam steps under each policy are the plain steps' bits."""
    state = _jax(_group, "forward", "adam", None, 3)[1]
    runs = {}
    for policy in (None, "full", "dots"):
        prog, _, fetch = _build(ptt, _group, "forward", "adam")
        prog.remat_policy = policy
        exe, scope = ptt.Executor(device="cpu"), ptt.Scope()
        tio.params_from_numpy(scope, state, "cpu")
        losses = [exe.run(prog, _feed(ptt, _feed_arrays(_group, "forward", i)), [fetch[-1]],
                          scope=scope)[0] for i in range(2)]
        runs[policy] = (losses, {p.name: scope.get(p.name) for p in prog.parameters()})
    from paddle_tpu_torch.core import remat

    env = {treg.PROGRAM_KEY: prog}
    fwd = prog.global_block().ops[:[o.type for o in prog.global_block().ops].index("autodiff")]
    assert all(ckpt for a, b, ckpt in remat.segments(fwd, env)
               if any(o.type == "recurrent_group" for o in fwd[a:b]))
    for policy in ("full", "dots"):
        assert runs[policy][0] == runs[None][0]
        for n, v in runs[None][1].items():
            assert torch.equal(runs[policy][1][n], v), (policy, n)
