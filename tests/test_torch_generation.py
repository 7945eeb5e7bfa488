"""Generation in the PyTorch port (ops/generation_ops.py, layers/generation.py)
against the JAX package, on the CPU.

The tiny decoder of tests/test_generation.py (V=12, E=8, H=16, T=6) is built
with both front ends, which must give the same `Program.to_dict()`, and
decoded with both executors from one numpy state. Ids and lengths are equal:
the top-K's tie order rests on `beam_common.topk_lowest_index`, which keeps
`jax.lax.top_k`'s. Scores agree within SCORE_TOL: they sum T f32 log-softmax
values whose products and logsumexp round differently in the two packages,
a few f32 ulps of values below 40 in magnitude.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.ops import generation_ops

V, E, H = 12, 8, 16
BOS, EOS = 0, 1
T = 6
SCORE_TOL = 1e-5


def build(pkg, K, length_normalize=False, per_example=False):
    """The tiny decoder through `pkg`'s front end (names counted from 0):
    (main, startup, (ids, scores, lengths))."""
    if pkg is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        h0 = pkg.layers.data("h0", shape=[-1, H], append_batch_size=False)
        enc = (pkg.layers.data("enc", shape=[-1, H], append_batch_size=False)
               if per_example else None)
        gen = pkg.layers.BeamSearchDecoder(beam_size=K, max_len=T, bos_id=BOS, eos_id=EOS,
                                           length_normalize=length_normalize)
        with gen.step():
            prev = gen.prev_ids()
            h_prev = gen.memory(init=h0)
            emb = pkg.layers.embedding(prev, size=[V, E], param_attr="gen_emb")
            parts = [emb, h_prev] + ([gen.per_example_input(enc)] if per_example else [])
            h = pkg.layers.fc(pkg.layers.concat(parts, axis=1), size=H, act="tanh",
                              param_attr="gen_w", bias_attr=pkg.ParamAttr(name="gen_b"))
            gen.update_memory(h_prev, h)
            gen.output_logits(pkg.layers.fc(h, size=V, param_attr="gen_wout",
                                            bias_attr=pkg.ParamAttr(name="gen_bout")))
        outs = gen()
    return main, startup, outs


def weights(program, seed=0):
    """numpy weights for every parameter of `program`, from `seed`."""
    rng = np.random.RandomState(seed)
    return {p.name: (rng.standard_normal(p.shape) * (0.8 if len(p.shape) == 2 else 0.3))
            .astype(np.float32) for p in program.parameters()}


def decode_both(K, feed, length_normalize=False, per_example=False):
    """The same program and weights decoded by both packages: (jax outputs,
    port outputs), numpy."""
    jm, _, jouts = build(pt, K, length_normalize, per_example)
    pm, _, pouts = build(ptt, K, length_normalize, per_example)
    w = weights(pm)
    jscope, pscope = pt.Scope(), ptt.Scope()
    for n, a in w.items():
        jscope.set(n, jnp.asarray(a))
    ptt.io.params_from_numpy(pscope, w, "cpu")
    j = pt.Executor().run(jm, feed=feed, fetch_list=list(jouts), scope=jscope)
    p = ptt.Executor(device="cpu").run(pm, feed, list(pouts), scope=pscope)
    return [np.asarray(x) for x in j], p, w


def assert_same_decode(j, p):
    np.testing.assert_array_equal(p[0], j[0])  # ids
    np.testing.assert_array_equal(p[2], j[2])  # lengths
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("axis,dtypes", [(1, ("float32", "float32")), (0, ("int32", "int32")),
                                         (-1, ("float32", "bfloat16"))])
def test_concat_op_matches_jax(axis, dtypes):
    """The concat op on both packages' OpContexts, dtypes promoted alike."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (3, 5)] if axis != 0 else [(2, 4), (3, 4)]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(x).astype(d) for x, d in zip(xs, dtypes)]
    tx = [torch.as_tensor(x).to(getattr(torch, d)) for x, d in zip(xs, dtypes)]
    slots = {"X": ["x0", "x1"]}
    jenv, tenv = dict(zip(slots["X"], jx)), dict(zip(slots["X"], tx))
    attrs = {"axis": axis}
    jreg.get_kernel("concat")(jreg.OpContext(JOp("concat", slots, {"Out": ["out"]}, attrs), jenv))
    treg.get_kernel("concat")(treg.OpContext(TOp("concat", slots, {"Out": ["out"]}, attrs), tenv))
    j, t = jenv["out"], tenv["out"]
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("variant", ["plain", "length_normalize", "per_example"])
def test_decoder_program_matches_jax(variant):
    """BeamSearchDecoder builds the JAX front end's program: the sub-block,
    the beam_search_group op's attrs and every name."""
    kw = {"length_normalize": variant == "length_normalize",
          "per_example": variant == "per_example"}
    jm, js, _ = build(pt, 3, **kw)
    pm, ps, _ = build(ptt, 3, **kw)
    for j, p in ((jm, pm), (js, ps)):
        assert json.loads(json.dumps(p.to_dict())) == json.loads(json.dumps(j.to_dict()))
    assert [b.idx for b in pm.blocks] == [0, 1] and pm.blocks[1].parent_idx == 0
    assert ptt.Program.from_dict(pm.to_dict()).to_dict() == pm.to_dict()
    op = generation_ops.find_generation_op(pm)
    spec = generation_ops.gen_spec_from_op(op)
    assert (spec.beam_size, spec.max_len, spec.sub_block) == (3, T, 1)
    assert spec.per_example_names == (("enc",) if kw["per_example"] else ())


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("length_normalize", [False, True])
def test_beam_search_group_matches_jax(K, length_normalize):
    """The op on both packages, B=3: ids and lengths equal, scores within
    SCORE_TOL, ids of shape [B, K, T]."""
    h0 = np.random.RandomState(1).standard_normal((3, H)).astype(np.float32)
    j, p, _ = decode_both(K, {"h0": h0}, length_normalize)
    assert p[0].shape == (3, K, T) and p[0].dtype == np.int32
    assert_same_decode(j, p)


def _argmax_chain(w, h0):
    tok, h, toks = BOS, h0, []
    for _ in range(T):
        x = np.concatenate([w["gen_emb"][tok], h])
        h = np.tanh(x @ w["gen_w"] + w["gen_b"])
        tok = int(np.argmax(h @ w["gen_wout"] + w["gen_bout"]))
        toks.append(tok)
    return toks


def test_greedy_is_an_argmax_chain():
    """Beam 1 is greedy decoding: the op's ids, and `greedy_step` run T
    times on the step sub-block, equal a numpy argmax chain up to the first
    EOS."""
    h0 = np.random.RandomState(2).standard_normal((3, H)).astype(np.float32)
    j, p, w = decode_both(1, {"h0": h0})
    assert_same_decode(j, p)
    pm, _, _ = build(ptt, 1)
    spec = generation_ops.gen_spec_from_op(generation_ops.find_generation_op(pm))
    block = pm.blocks[spec.sub_block]
    runner = ptt.core.executor.BlockRunner(pm)
    env = {n: torch.as_tensor(a) for n, a in w.items()}
    mems, tok, steps = (torch.as_tensor(h0),), torch.full((3,), BOS, dtype=torch.int32), []
    for _ in range(T):
        mems, tok = generation_ops.greedy_step(runner, block, spec, dict(env), mems, tok)
        steps.append(tok.numpy())
    steps = np.stack(steps, axis=1)
    for b in range(3):
        want = _argmax_chain(w, h0[b])
        L = int(p[2][b, 0])
        assert list(p[0][b, 0, :L]) == want[:L]
        assert list(steps[b, :L]) == want[:L]


def test_per_example_inputs_are_tiled_to_the_beam():
    """A per-example closure tensor ([B, H]) is tiled to [B*K, H] for the
    step: the port decodes what the JAX package decodes."""
    rng = np.random.RandomState(3)
    feed = {"h0": rng.standard_normal((2, H)).astype(np.float32),
            "enc": rng.standard_normal((2, H)).astype(np.float32)}
    j, p, _ = decode_both(2, feed, per_example=True)
    assert p[0].shape == (2, 2, T)
    assert_same_decode(j, p)
