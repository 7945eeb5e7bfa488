"""The book's label_semantic_roles (tests/book/test_label_semantic_roles.py)
through the port: the CRF ops and layers, the conll05 loader and the
book's db_lstm + CRF program, on the CPU, against the JAX package.

- `crf_nll` (through the `linear_chain_crf` op) and the gradients of a
  seeded cotangent with respect to the emission and the transition, on
  ragged batches with absent (padded) sequences, a sequence of one token
  and max_len below the longest, f32 within 1e-5 relative: the same
  log-sum-exp recursion in another order (XLA's scan, torch's loop).
- `crf_viterbi` (through `crf_decoding`): tags equal on untied inputs, in
  both of the op's modes (the tags, and 0/1 correctness against a Label);
  an exact tie in every step's scores goes to the lowest tag in both.
- The book's program (8 feature embeddings, fc, a bi-GRU, the emission
  fc, linear_chain_crf and crf_decoding sharing `srl_crf_w`) built by both
  front ends to equal program dicts, at the book test's widths and at the
  reference book's (word_dim 32, hidden 512).
- Three Adam(0.01) steps of the book's program on conll05 batches from
  the port's startup state in both packages, f32: costs within 1e-5 relative, parameters
  within 1e-5 of their largest or 1% of the learning rate a step
  (tests/test_torch_book_text.py's bounds); then the for-test clone's
  decoded tags on a test batch equal.
- `conll05` against the JAX loader.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import FLAGS as JFLAGS
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu.data.datasets import conll05 as jconll05
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.data import batch
from paddle_tpu_torch.data.datasets import conll05
from paddle_tpu_torch.data.feeder import DataFeeder

CRF_TOL = 1e-5
RTOL = 1e-5
ADAM_LR_SHARE = 1e-2
LR = 0.01  # tests/book/test_label_semantic_roles.py
MAX_LEN = 20
FEATS = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "pred", "mark"]


@pytest.fixture
def one_thread():
    """torch on one thread for the training steps, as tests/test_torch_book.py
    runs its own: the suite's workers share the host's cores, and eager
    steps of small ops on every core's thread slow each other many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lods(seqs, cap, max_seqs):
    return (JLoD.from_sequences(seqs, capacity=cap, max_seqs=max_seqs),
            ptt.LoDArray.from_sequences(seqs, capacity=cap, max_seqs=max_seqs))


def _run(reg, op_cls, op, ins, attrs, out):
    env = {"@AMP@": None, **ins}
    names = {slot: [slot] for slot in ins}
    reg.get_kernel(op)(reg.OpContext(op_cls(op, names, {out: [out]}, dict(attrs)), env))
    return env[out]


def _jax_decode(je, trans, attrs, extra):
    """The JAX crf_decoding op, jitted: its ViterbiPath's data."""
    def f(data, tr):
        return _run(jreg, JOp, "crf_decoding", {"Emission": je.with_data(data),
                                                "Transition": tr, **extra},
                    attrs, "ViterbiPath").data

    return jax.jit(f)(je.data, jnp.asarray(trans))


# (lengths, capacity, max_seqs, max_len): absent sequences, a sequence of
# one token, max_len below the longest sequence
CASES = {"ragged": ([4, 1, 6, 3], 20, 6, 7), "full": ([5, 5], 10, 2, 5),
         "cut": ([9, 2, 7], 24, 4, 6), "one": ([1], 4, 3, 1)}


def _crf_inputs(case, D=5, seed=0):
    lens, cap, max_seqs, max_len = CASES[case]
    rng = np.random.RandomState(seed)
    em = [rng.randn(n, D).astype(np.float32) for n in lens]
    lb = [rng.randint(0, D, size=(n, 1)).astype(np.int32) for n in lens]
    lb[0][0] = D + 3  # clipped to D - 1
    trans = (0.5 * rng.randn(D + 2, D)).astype(np.float32)
    return em, lb, trans, cap, max_seqs, max_len, rng


@pytest.mark.parametrize("case", list(CASES))
def test_linear_chain_crf_matches_jax(case):
    em, lb, trans, cap, max_seqs, max_len, rng = _crf_inputs(case)
    je, te = _lods(em, cap, max_seqs)
    jl, tl = _lods(lb, cap, max_seqs)
    attrs = {"max_len": max_len}

    def jf(data, tr):
        return _run(jreg, JOp, "linear_chain_crf", {"Emission": je.with_data(data), "Label": jl,
                                                    "Transition": tr}, attrs, "LogLikelihood")

    cot = rng.randn(max_seqs, 1).astype(np.float32)
    jn, jg = jax.jit(lambda d, tr: (lambda o, f: (o, f(jnp.asarray(cot))))(
        *jax.vjp(jf, d, tr)))(je.data, jnp.asarray(trans))
    data = te.data.clone().requires_grad_(True)
    tr = torch.tensor(trans, requires_grad=True)
    tn = _run(treg, TOp, "linear_chain_crf", {"Emission": te.with_data(data), "Label": tl,
                                              "Transition": tr}, attrs, "LogLikelihood")
    tg = torch.autograd.grad(tn, [data, tr], torch.tensor(cot))
    assert tn.shape == jn.shape == (max_seqs, 1)
    assert (tn.detach().numpy()[len(em):] == 0).all()
    for j, t in [(jn, tn.detach())] + list(zip(jg, tg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=CRF_TOL, atol=CRF_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_crf_decoding_matches_jax(case):
    """Both modes of the op on untied inputs: the tags, then 0/1 against a
    Label; the tags bit for bit."""
    em, lb, trans, cap, max_seqs, max_len, _ = _crf_inputs(case, seed=1)
    je, te = _lods(em, cap, max_seqs)
    jl, tl = _lods(lb, cap, max_seqs)
    attrs = {"max_len": max_len}
    for extra in ({}, {"Label": (jl, tl)}):
        j = _jax_decode(je, trans, attrs, {k: v[0] for k, v in extra.items()})
        t = _run(treg, TOp, "crf_decoding", {"Emission": te, "Transition": torch.tensor(trans),
                                             **{k: v[1] for k, v in extra.items()}},
                 attrs, "ViterbiPath")
        assert t.data.dtype == torch.int32
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j))
        assert t.lengths is te.lengths


def test_crf_viterbi_exact_tie():
    """Every emission 0 and every transition 1 (start and end weights 0):
    each step's scores tie exactly across all previous tags, and the final
    scores across all tags; both packages keep the lowest tag."""
    D = 4
    em = [np.zeros((n, D), np.float32) for n in (3, 5, 1)]
    trans = np.ones((D + 2, D), np.float32)
    trans[:2] = 0.0
    je, te = _lods(em, 12, 4)
    j = _jax_decode(je, trans, {"max_len": 5}, {})
    t = _run(treg, TOp, "crf_decoding", {"Emission": te, "Transition": torch.tensor(trans)},
             {"max_len": 5}, "ViterbiPath")
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j))
    assert (t.data.numpy()[t.token_mask.numpy()] == 0).all()


def test_conll05_equals_jax():
    assert conll05.get_dict() == jconll05.get_dict()
    assert len(conll05.word_dict()) == 3001 and len(conll05.label_dict()) == 9
    np.testing.assert_array_equal(conll05.get_embedding(), jconll05.get_embedding())
    for got, want, n in ((conll05.train(), jconll05.train(), 1500),
                         (conll05.test(), jconll05.test(), 200)):
        g, w = list(got()), list(want())
        assert len(g) == len(w) == n and g == w
    assert {len(s[0]) for s in g} <= set(range(6, 20))


# ------------------------------------------------------------ the program


def db_lstm(m, feats, word_dict_len, pred_dict_len, label_dict_len, word_dim, hidden):
    """tests/book/test_label_semantic_roles.py's db_lstm."""
    word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred, mark = feats
    embs = [m.layers.embedding(w, size=[word_dict_len, word_dim], param_attr="srl_word_emb")
            for w in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
    embs.append(m.layers.embedding(pred, size=[pred_dict_len, word_dim]))
    embs.append(m.layers.embedding(mark, size=[2, word_dim]))
    hidden_0 = m.layers.fc(embs, size=hidden, act="tanh")
    fwd = m.layers.dynamic_gru(m.layers.fc(hidden_0, size=3 * hidden, bias_attr=False),
                               size=hidden, max_len=MAX_LEN)
    bwd = m.layers.dynamic_gru(m.layers.fc(hidden_0, size=3 * hidden, bias_attr=False),
                               size=hidden, is_reverse=True, max_len=MAX_LEN)
    feat = m.layers.sequence_concat([fwd, bwd])
    return m.layers.fc(feat, size=label_dict_len)


def build_srl(m, word_dim=16, hidden=32):
    """The book's program: (main, startup, the for-test clone, cost,
    decoded, the feed variables)."""
    word_dict, verb_dict, label_dict = (conll05 if m is ptt else jconll05).get_dict()
    if m is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    prog, startup = m.Program(), m.Program()
    startup.random_seed = 5
    with m.program_guard(prog, startup):
        feats = [m.layers.data(n, [-1], np.int32, lod_level=1, append_batch_size=False)
                 for n in FEATS]
        label = m.layers.data("label", [-1], np.int32, lod_level=1, append_batch_size=False)
        emission = db_lstm(m, feats, len(word_dict), len(verb_dict), len(label_dict),
                           word_dim, hidden)
        crf_cost = m.layers.linear_chain_crf(emission, label, param_attr="srl_crf_w",
                                             max_len=MAX_LEN)
        cost = m.layers.mean(crf_cost)
        decoded = m.layers.crf_decoding(emission, param_attr="srl_crf_w", max_len=MAX_LEN)
        m.optimizer.Adam(learning_rate=LR).minimize(cost)
    return prog, startup, prog.clone(for_test=True), cost, decoded, feats + [label]


@pytest.mark.parametrize("widths", [(16, 32), (32, 512)], ids=["book_test", "reference_book"])
def test_program_equals_jax(widths):
    tp, _, ttest, *_ = build_srl(ptt, *widths)
    jp, _, jtest, *_ = build_srl(pt, *widths)
    assert tp.to_dict() == jp.to_dict()
    assert ttest.to_dict() == jtest.to_dict()
    ops = [o.type for o in tp.global_block().ops]
    assert ops.count("dynamic_gru") == 2 and ops.count("crf_decoding") == 1
    crf = [o for o in tp.global_block().ops if o.type in ("linear_chain_crf", "crf_decoding")]
    assert {o.inputs["Transition"][0] for o in crf} == {"srl_crf_w"}


def _one_state(tprog, tstartup):
    """The port's startup state (every persistable) in both scopes: the
    JAX side's global scope takes it as it is, so its startup program (a
    compile of every initializer) does not run."""
    texe, tscope = ptt.Executor(device="cpu"), ptt.Scope()
    texe.run(tstartup, scope=tscope)
    state = tio.state_to_numpy(tscope, [v.name for v in tprog.persistables()
                                        if tscope.has(v.name)])
    js = pt.global_scope()
    for name, v in state.items():
        js.set(name, jnp.asarray(v))
    return pt.Executor(), js, texe, tscope


def _to_jax(feed):
    return {k: JLoD.from_sequences(
        [v.data.numpy()[v.offsets.numpy()[i]:v.offsets.numpy()[i + 1]]
         for i in range(int(v.num_seqs))], capacity=v.capacity, max_seqs=v.max_seqs)
        if isinstance(v, ptt.LoDArray) else v for k, v in feed.items()}


def test_three_steps_equal_jax(one_thread, monkeypatch):
    """The book's recipe (B=16, bucket 512): the port's GRUs on its kernel
    route (rnn_kernels.gru_fused, the plain versions on the CPU), the JAX
    side's on its scan (at H=32 its Pallas kernel does not take them)."""
    monkeypatch.setattr(JFLAGS, "use_fused_rnn", False)
    jprog, _, jtest, jcost, jdec, _ = build_srl(pt)
    tprog, tstartup, ttest, _, _, feed_vars = build_srl(ptt)
    jexe, js, texe, tscope = _one_state(tprog, tstartup)
    feeder = DataFeeder(feed_vars, bucket=512, max_seqs=16)
    reader = batch(conll05.train(), 16, drop_last=True)()
    for _ in range(3):
        feed = feeder.feed(next(reader))
        (j,) = jexe.run(jprog, feed=_to_jax(feed), fetch_list=[jcost])
        (t,) = texe.run(tprog, feed, [jcost.name], scope=tscope)
        np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=RTOL * abs(float(j)))
    for p in tprog.parameters():
        want = np.asarray(js.get(p.name))
        got = tscope.get(p.name).numpy()
        bound = max(RTOL * float(np.abs(want).max()), ADAM_LR_SHARE * 3 * LR)
        assert np.abs(got - want).max() <= bound, (p.name, float(np.abs(got - want).max()))
    feed = feeder.feed(next(batch(conll05.test(), 16, drop_last=True)()))
    (jd,) = jexe.run(jtest, feed=_to_jax(feed), fetch_list=[jdec], return_numpy=False)
    (td,) = texe.run(ttest, feed, [jdec.name], scope=tscope, return_numpy=False)
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    np.testing.assert_array_equal(td.lengths.numpy(), np.asarray(jd.lengths))
