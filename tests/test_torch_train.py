"""The training slice end to end: bench.py's NMT training program (the
`nmt` entry of its default sweep, `_build_nmt_train`), written by the JAX
package and run by both packages from the same numpy state and feeds.

Run as a script, this module rewrites the committed training programs
paddle_tpu_torch/artifacts/nmt_train_{wmt,small}/ from the JAX package:

    JAX_PLATFORMS=cpu python tests/test_torch_train.py

Both packages start from one numpy state: the small program's startup
values with its parameters replaced by normal/sqrt(fan_in) values (the
startup's 0.01-scale embeddings leave the attention uniform, and its
gradients rounding noise). The JAX side takes its Pallas kernels in
interpret mode, or with both packages' fused flags off, its scans.

Tolerances, and why:

- f32. The loss within 1e-5 relative, and every gradient within 2e-5 of
  its largest element: the same f32 arithmetic summed in other orders
  (measured: at most 6.7e-6, the attention's tiny WaDec gradient). After
  two Adam steps the parameters within 0.02 lr of each other in all but
  0.5% of the values and every value within 0.05 lr (measured: 6.9e-4 lr
  here, 0.002 lr card against CPU in chip_smoke.py). The moments within
  5e-5 of their largest element.
- bf16 amp. The forward rounds where the JAX package rounds: the encoder
  state, the decoder's initial and hidden states and the logits differ
  in at most 2% of their values, each by at most 4e-3 (one bf16 ulp just
  below 1; measured: identical on the kernel path). On the scans 9.2% of
  the decoder states differ, by one ulp, and the cause lies on the JAX
  side: its Executor jits the step, and XLA's excess precision lets the
  fused softmax sum the f32 exp unrounded where the op-by-op formula
  rounds it to bf16 first. The port's scan decoder gives the JAX op run op
  by op bit for bit, and the jitted op with
  `xla_allow_excess_precision` off gives the port's bits again
  (`test_bf16_scan_decoder_parts_only_under_xla_excess_precision`: 7.6%
  of that case's states differ under XLA's default, by at most 3.9e-3),
  so the share is held on the kernel path only.
  A decoder GRU cell that rounds its sigmoid once, as
  torch.sigmoid does, instead of op by op as the JAX package's lowering
  does, differs in 27% of the decoder's states and fails
  (`test_bf16_bounds_reject_a_sigmoid_rounded_once`). The loss within
  1e-4 relative. Gradients are sums over bf16 activations that either
  side may round one ulp apart, and the difference spreads through the
  recurrences: each within 5% of its largest element, with at most 3%
  of its values more than 1% of that largest apart (measured: 2.5% and
  1.6%, both the 64-value output bias). After two steps at most 3% of
  each parameter's values more than 0.1 lr apart (measured 0.8%). No
  bound holds every value: a step moves a value by at most about lr (the
  first by lr·sign(g)), so a value whose gradient is a rounding away from
  0 may move the other way, and a bound of 4 lr could not fail (measured
  2.7 lr). Instead the values whose first gradient exceeds 5% of the
  parameter's largest, which a gradient within the 5% bound above cannot
  flip (a fifth to half of each parameter), lie within 0.5 lr (measured
  0.055 lr); a row whose gradient is lost fails it
  (`test_state_bounds_reject_a_fault_in_one_row`). The moments within 5%
  of their largest element with at most 10% of their values beyond 1%
  (measured 2.4%, 6.25%). On the scans in bf16 only the forward and the
  loss are held: there the gradient goes through the softmax's backward,
  which autograd rounds at other places than the JAX package's custom
  derivative, and WaDec's small gradient (a sum that nearly cancels)
  moves by 16%.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu as pt  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu import models  # noqa: E402
from paddle_tpu.core.lod import LoDArray as JaxLoD  # noqa: E402
from paddle_tpu.flags import FLAGS  # noqa: E402
from paddle_tpu.ops import bahdanau_kernels, pallas_kernels  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "paddle_tpu_torch", "artifacts")
SOURCE = ("bench.py _build_nmt_train (bench.py:320-375) at BENCH_BATCH=256 "
          "(bench.py:435): models.seq2seq_attention, softmax_with_cross_entropy, "
          "sequence_pool(sum), mean, Adam(5e-4)")
WIDTHS = {
    # bench.py's nmt entry: V=30000, emb = enc = dec hidden = 512, lengths 50
    "nmt_train_wmt": dict(vocab=30000, emb=512, enc_hidden=512, dec_hidden=512,
                          max_len=50, batch=256),
    # the same graph narrowed: the JAX side takes its Pallas kernels (H and
    # C multiples of 128, B a multiple of 8), at lengths up to 6
    "nmt_train_small": dict(vocab=64, emb=32, enc_hidden=128, dec_hidden=128,
                            max_len=6, batch=8),
}
FEEDS = ["src", "trg_in", "label"]


def build_nmt_train(vocab, emb, enc_hidden, dec_hidden, max_len, batch=None):
    """bench.py's _build_nmt_train at the given widths (batch is the feed's,
    not the program's). Returns (main, startup, loss)."""
    pt.reset()
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        src, trg_in, label = (
            pt.layers.data(n, shape=[-1], dtype=np.int32, lod_level=1,
                           append_batch_size=False) for n in FEEDS)
        logits = models.seq2seq_attention(
            src, trg_in, src_vocab=vocab, trg_vocab=vocab, emb_dim=emb,
            enc_hidden=enc_hidden, dec_hidden=dec_hidden, src_max_len=max_len,
            trg_max_len=max_len)
        tok_loss = pt.layers.softmax_with_cross_entropy(logits, label)
        loss = pt.layers.mean(pt.layers.sequence_pool(tok_loss, "sum"))
        pt.optimizer.Adam(learning_rate=5e-4).minimize(loss)
    return prog, startup, loss


def export_nmt_train(dirname, **widths):
    """Write main.json, startup.json and meta.json for one width set."""
    prog, startup, loss = build_nmt_train(**widths)
    meta = {
        "feed_names": FEEDS,
        "loss_name": loss.name,
        "param_names": [v.name for v in prog.parameters()],
        "widths": widths,
        "amp": "bfloat16",
        "source": SOURCE,
    }
    os.makedirs(dirname, exist_ok=True)
    for name, obj in (("main.json", prog.to_dict()), ("startup.json", startup.to_dict()),
                      ("meta.json", meta)):
        with open(os.path.join(dirname, name), "w") as f:
            json.dump(obj, f, indent=1)
    return prog, startup, meta


# ------------------------------------------------------------------ tests --
SMALL = WIDTHS["nmt_train_small"]
LR = 5e-4
_F32 = dict(loss=1e-5, grad=2e-5, grad_share=0.0, close=0.02, share=0.005, far=0.05,
            moment=5e-5, moment_share=0.0)
_BF16 = dict(loss=1e-4, grad=5e-2, grad_share=0.03, close=0.1, share=0.03, robust_grad=0.05,
             robust=0.5, moment=5e-2, moment_share=0.10, act=4e-3, act_share=0.02)
VARIANTS = ["kernels-f32", "kernels-bf16", "scan-f32", "scan-bf16"]


def _forward_names(prog_dict):
    """Encoder state, decoder boot state, decoder hidden states, logits."""
    ops = prog_dict["blocks"][0]["ops"]
    first = lambda t, slot: next(o for o in ops if o["type"] == t)["outputs"][slot][0]  # noqa: E731
    adds = [o["outputs"]["Out"][0] for o in ops if o["type"] == "elementwise_add"]
    return [first("sequence_concat", "Out"), first("tanh", "Out"),
            first("attention_gru_decoder", "Hidden"), adds[-1]]


def make_program_and_state():
    """The small program built by the JAX package, its startup state with
    seeded parameters, and two ragged feed batches (as numpy sequences)."""
    prog, startup, loss = build_nmt_train(**SMALL)
    startup.random_seed = 3
    pt.Executor().run(startup)
    scope = pt.global_scope()
    persist = [v.name for v in prog.persistables()]
    state = {n: np.array(scope.get(n)) for n in persist}
    rng = np.random.RandomState(5)
    for v in prog.parameters():
        shape = state[v.name].shape
        state[v.name] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    B, S, V = SMALL["batch"], SMALL["max_len"], SMALL["vocab"]
    batches = []
    for _ in range(2):
        lens = rng.randint(2, S + 1, size=(2, B))
        lens[:, 0] = S
        batches.append([[rng.randint(2, V, size=n).astype(np.int32) for n in row] for row in lens])
    return prog, loss, state, batches


@pytest.fixture(scope="module")
def program_and_state():
    return make_program_and_state()


def _feed(lod_cls, batch):
    B, S = SMALL["batch"], SMALL["max_len"]
    src, trg = (lod_cls.from_sequences(x, capacity=B * S, max_seqs=B) for x in batch)
    return {"src": src, "trg_in": trg, "label": trg}


def _run_jax(prog, loss, state, batches, amp, fused):
    from jax import numpy as jnp

    saved = {k: getattr(FLAGS, k) for k in ("fused_rnn_interpret", "fused_attention_interpret",
                                            "use_fused_rnn", "use_fused_attention")}
    spy_calls = []
    gru_bwd = pallas_kernels._gru_bwd_pallas

    def spy(*a, **k):
        spy_calls.append(a[0].shape)
        return gru_bwd(*a, **k)

    try:
        for k in saved:
            setattr(FLAGS, k, fused)
        pallas_kernels._gru_bwd_pallas = spy
        bahdanau_kernels.reset_dispatch_stats()
        scope = pt.global_scope()
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        prog.set_amp(amp)
        exe = pt.Executor()
        names = [p.name + "@GRAD" for p in prog.parameters()]
        fetch = [loss.name] + names + _forward_names(prog.to_dict())
        out1 = exe.run(prog, feed=_feed(JaxLoD, batches[0]), fetch_list=fetch)
        out2 = exe.run(prog, feed=_feed(JaxLoD, batches[1]), fetch_list=[loss.name])
        stats = dict(bahdanau_kernels.dispatch_stats)
        final = {n: np.array(scope.get(n), np.float32) for n in state}
    finally:
        for k, v in saved.items():
            setattr(FLAGS, k, v)
        pallas_kernels._gru_bwd_pallas = gru_bwd
        prog.set_amp(None)
    return dict(loss=[float(out1[0]), float(out2[0])],
                grads=dict(zip(names, out1[1:1 + len(names)])),
                acts=out1[1 + len(names):], state=final, stats=stats, gru_bwd=spy_calls)


def _run_port(state, batches, amp, fused, fetch_grads=True):
    main, _, meta = ptt.io.load_train_program(os.path.join(ARTIFACTS, "nmt_train_small"))
    main.set_amp(amp)
    saved = (ptt.FLAGS.use_fused_rnn, ptt.FLAGS.use_fused_attention)
    try:
        ptt.FLAGS.use_fused_rnn = ptt.FLAGS.use_fused_attention = fused
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, "cpu")
        exe = ptt.Executor(device="cpu")
        names = [p + "@GRAD" for p in meta["param_names"]] if fetch_grads else []
        fetch = [meta["loss_name"]] + names + _forward_names(main.to_dict())
        out1 = exe.run(main, _feed(ptt.LoDArray, batches[0]), fetch, scope=scope)
        out2 = exe.run(main, _feed(ptt.LoDArray, batches[1]), [meta["loss_name"]], scope=scope)
    finally:
        ptt.FLAGS.use_fused_rnn, ptt.FLAGS.use_fused_attention = saved
    return dict(loss=[float(out1[0]), float(out2[0])],
                grads=dict(zip(names, out1[1:1 + len(names)])),
                acts=out1[1 + len(names):], state=ptt.io.state_to_numpy(scope, list(state)))


@pytest.fixture(scope="module")
def runs(program_and_state):
    """Both packages' two steps per variant, run once for the module."""
    prog, loss, state, batches = program_and_state
    cache = {}

    def get(variant):
        if variant not in cache:
            path, dt = variant.split("-")
            amp = None if dt == "f32" else "bfloat16"
            fused = path == "kernels"
            cache[variant] = (_run_jax(prog, loss, state, batches, amp, fused),
                              _run_port(state, batches, amp, fused))
        return cache[variant]

    return get


def _act_data(v):
    v = v.data if isinstance(v, (JaxLoD, ptt.LoDArray)) else v
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_matches_jax(runs, variant):
    """The loss of both steps, every P@GRAD of the first (not on the bf16
    scans, see the module docstring), and under bf16 the forward values."""
    j, p = runs(variant)
    tol = _F32 if variant.endswith("f32") else _BF16
    if variant.startswith("kernels"):
        assert j["stats"]["fused_calls"] >= 1 and j["stats"]["scan_bwd"] >= 1, j["stats"]
        assert len(j["gru_bwd"]) >= 2, "the JAX side did not run its GRU backward kernel"
    else:
        assert j["stats"]["fused_calls"] == 0 and not j["gru_bwd"]
    for a, b in zip(j["loss"], p["loss"]):
        assert np.isfinite(b) and abs(a - b) <= tol["loss"] * abs(a), (a, b)
    if variant.endswith("bf16"):
        for name, a, b in zip(["encoder state", "decoder h0", "decoder states", "logits"],
                              j["acts"], p["acts"]):
            a, b = _act_data(a), _act_data(b)
            assert np.abs(a - b).max() <= tol["act"], name
            if variant == "kernels-bf16":
                assert np.mean(a != b) <= tol["act_share"], (name, np.mean(a != b))
    if variant == "scan-bf16":
        return
    assert set(p["grads"]) == set(j["grads"]) and len(p["grads"]) == 18
    for name, a in j["grads"].items():
        a, b = np.asarray(a, np.float32), p["grads"][name]
        assert b.shape == a.shape and b.dtype == np.float32, name
        scale = float(np.abs(a).max())
        d = np.abs(a - b)
        assert d.max() <= tol["grad"] * scale, (name, d.max() / scale)
        assert np.mean(d > 0.01 * scale) <= tol["grad_share"] + (tol is _F32), name


def _assert_state_close(got, want, tol, grads, lr=LR):
    """`grads`: the first step's P@GRAD on the `want` side, which picks the
    values a sound bf16 run cannot flip (see the module docstring); `lr`
    the learning rate the parameter bounds are in units of."""
    for n, w in want.items():
        d = np.abs(got[n] - w)
        if ".moment" in n:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert d.max() <= tol["moment"] * scale, (n, d.max() / scale)
            assert np.mean(d > 0.01 * scale) <= tol["moment_share"], n
        elif "_pow." in n or n.endswith(".lr"):
            np.testing.assert_array_equal(got[n], w, err_msg=n)
        else:
            assert np.mean(d > tol["close"] * lr) <= tol["share"], (n, np.mean(d > tol["close"] * lr))
            if "far" in tol:
                assert d.max() <= tol["far"] * lr, (n, d.max() / lr)
            else:
                g = np.abs(np.asarray(grads[n + "@GRAD"], np.float32))
                robust = g > tol["robust_grad"] * g.max()
                assert d[robust].max() <= tol["robust"] * lr, (n, d[robust].max() / lr)


@pytest.mark.parametrize("variant", ["kernels-f32", "kernels-bf16", "scan-f32"])
def test_two_adam_steps_match_jax(runs, variant):
    """Every parameter, Adam moment, beta power and the learning rate
    after two steps on two batches."""
    j, p = runs(variant)
    assert set(p["state"]) == set(j["state"])
    _assert_state_close(p["state"], j["state"], _F32 if variant.endswith("f32") else _BF16,
                        j["grads"])


@pytest.mark.parametrize("variant", ["kernels-f32", "kernels-bf16"])
def test_state_bounds_reject_a_fault_in_one_row(runs, program_and_state, variant):
    """One embedding row left where it started (its gradient lost) is 1/64
    of the parameter, in bf16 below the share bound, and must still fail."""
    j, p = runs(variant)
    _, _, state, _ = program_and_state
    name = "s2s.trg_emb"
    row = int(np.abs(np.asarray(j["grads"][name + "@GRAD"])).max(1).argmax())
    faulty = dict(p["state"])
    faulty[name] = p["state"][name].copy()
    faulty[name][row] = state[name][row]
    tol = _F32 if variant.endswith("f32") else _BF16
    if tol is _BF16:
        assert np.mean(np.abs(faulty[name] - j["state"][name]) > tol["close"] * LR) <= tol["share"]
    with pytest.raises(AssertionError):
        _assert_state_close(faulty, j["state"], tol, j["grads"])
    b1 = [v for n, v in p["state"].items() if "beta1_pow" in n]
    assert len(b1) == 18 and all(np.allclose(v, 0.9 ** 3, rtol=1e-6) for v in b1)


def test_bf16_bounds_reject_a_sigmoid_rounded_once(runs, program_and_state, monkeypatch):
    """The decoder's GRU cell with torch.sigmoid (one rounding, where the
    JAX package's lowering rounds op by op) breaks the forward bound."""
    from paddle_tpu_torch.ops import attention_kernels

    j, _ = runs("kernels-bf16")
    _, _, state, batches = program_and_state
    monkeypatch.setattr(attention_kernels, "sigmoid", torch.sigmoid)
    p = _run_port(state, batches, "bfloat16", True, fetch_grads=False)
    a, b = _act_data(j["acts"][2]), _act_data(p["acts"][2])
    assert np.mean(a != b) > _BF16["act_share"], np.mean(a != b)


def _decoder_case():
    """Seeded bf16 inputs of one attention_gru_decoder op (B=8, S=T=6,
    E=32, C=256, A=H=128), ragged source and target, as numpy."""
    rng = np.random.RandomState(11)
    B, S, T, E, C, A, H = 8, 6, 6, 32, 256, 128, 128
    src = rng.randint(2, S + 1, size=B)
    trg = rng.randint(2, T + 1, size=B)
    src[0] = trg[0] = S
    f = lambda *shape, sc=1.0: (sc * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    return dict(enc=[f(n, C, sc=0.5) for n in src], trg=[f(n, E) for n in trg],
                H0=f(B, H, sc=0.5), WaEnc=f(C, A, sc=C ** -0.5), WaDec=f(H, A, sc=H ** -0.5),
                Va=f(A, sc=A ** -0.5), Wx=f(E + C, 3 * H, sc=(E + C) ** -0.5),
                Wh=f(H, 3 * H, sc=H ** -0.5), Bias=f(3 * H, sc=0.1), S=S, T=T)


_DEC_SLOTS = ("H0", "WaEnc", "WaDec", "Va", "Wx", "Wh", "Bias")


def _decoder_op(pkg_op, case):
    return pkg_op("attention_gru_decoder",
                  {k: [k] for k in ("EncState", "TrgEmb") + _DEC_SLOTS}, {"Hidden": ["h"]},
                  {"src_max_len": case["S"], "trg_max_len": case["T"]})


def jax_decoder_states(case, jit, excess_precision=True):
    """The JAX package's decoder op on the case, with its fused attention
    off (its scan), jitted as its Executor runs it (with XLA's
    `xla_allow_excess_precision` as given), or op by op (a Python loop
    under jax.disable_jit). Returns Hidden's data as f32 numpy."""
    import jax
    from jax import numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp

    B = len(case["enc"])
    enc = JaxLoD.from_sequences(case["enc"], capacity=B * case["S"], max_seqs=B)
    trg = JaxLoD.from_sequences(case["trg"], capacity=B * case["T"], max_seqs=B)
    trg = trg.with_data(trg.data.astype(jnp.bfloat16))
    weights = {k: jnp.asarray(case[k]) for k in _DEC_SLOTS}

    def run(enc, trg, weights):
        env = {"@AMP@": None, "EncState": enc, "TrgEmb": trg, **weights}
        jreg.get_kernel("attention_gru_decoder")(jreg.OpContext(_decoder_op(JOp, case), env))
        return env["h"].data

    saved = FLAGS.use_fused_attention
    try:
        FLAGS.use_fused_attention = False
        if jit:
            opts = {"xla_allow_excess_precision": excess_precision}
            out = jax.jit(run, compiler_options=opts)(enc, trg, weights)
        else:
            with jax.disable_jit():
                out = run(enc, trg, weights)
    finally:
        FLAGS.use_fused_attention = saved
    return np.asarray(out, np.float32)


def port_decoder_states(case):
    """The port's decoder op on the case, fused attention off (its scan)."""
    from paddle_tpu_torch.core import registry as preg

    B = len(case["enc"])
    enc = ptt.LoDArray.from_sequences(case["enc"], capacity=B * case["S"], max_seqs=B)
    trg = ptt.LoDArray.from_sequences(case["trg"], capacity=B * case["T"], max_seqs=B)
    env = {"EncState": enc, "TrgEmb": trg.with_data(trg.data.bfloat16()),
           **{k: torch.tensor(case[k]) for k in _DEC_SLOTS}}
    saved = ptt.FLAGS.use_fused_attention
    try:
        ptt.FLAGS.use_fused_attention = False
        with torch.no_grad():
            preg.get_kernel("attention_gru_decoder")(
                preg.OpContext(_decoder_op(ptt.core.program.Operator, case), env))
    finally:
        ptt.FLAGS.use_fused_attention = saved
    return env["h"].data.float().numpy()


def test_bf16_scan_decoder_parts_only_under_xla_excess_precision():
    """The bf16 scan decoder's difference from the JAX package lies on the
    JAX side. The port's states are the JAX op's run op by op, bit for
    bit. Jitted, as the JAX Executor runs it, XLA's excess precision lets
    the fused softmax sum the f32 exp unrounded (the first op of a step at
    which the two part: 8.3% of α), and the states differ; compiled with
    `xla_allow_excess_precision` off (jit's compiler_options, as the flag
    --xla_allow_excess_precision=false sets it for a process), the jitted
    op gives the port's bits again."""
    case = _decoder_case()
    port = port_decoder_states(case)
    eager = jax_decoder_states(case, jit=False)
    jitted = jax_decoder_states(case, jit=True)
    np.testing.assert_array_equal(port, eager)
    assert np.mean(jitted != eager) > 0.01, np.mean(jitted != eager)
    np.testing.assert_array_equal(jax_decoder_states(case, jit=True, excess_precision=False),
                                  port)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_committed_program_is_a_fresh_jax_build(tmp_path, name):
    prog, startup, meta = export_nmt_train(tmp_path, **WIDTHS[name])
    for f, fresh in (("main.json", prog.to_dict()), ("startup.json", startup.to_dict()),
                     ("meta.json", meta)):
        with open(os.path.join(ARTIFACTS, name, f)) as fh:
            assert json.load(fh) == json.loads(json.dumps(fresh)), f
    ops = [o.type for o in prog.global_block().ops]
    assert len(ops) == 36 and ops.count("adam") == 18 and ops.count("autodiff") == 1
    st = [o.type for o in startup.global_block().ops]
    assert (st.count("fill_constant"), st.count("uniform_random"), st.count("gaussian_random")) \
        == (78, 11, 2)
    if name == "nmt_train_wmt":
        n = sum(int(np.prod(v.shape)) for v in prog.parameters())
        assert n == 53_455_664
    port_main, port_start, port_meta = ptt.io.load_train_program(os.path.join(ARTIFACTS, name))
    assert port_main.to_dict() == json.loads(json.dumps(prog.to_dict()))
    assert port_main.amp_dtype == "bfloat16" and port_meta["feed_names"] == FEEDS


def test_startup_program_on_the_port():
    """Shapes and dtypes of every persistable, exact constants, uniform
    values inside their bounds with the uniform std, normal values with the
    attr's std (within 10%: 2048 samples give a 1.6% standard error); the
    same seed gives the same values."""
    main, startup, meta = ptt.io.load_train_program(os.path.join(ARTIFACTS, "nmt_train_small"))
    scopes = [ptt.Scope() for _ in range(3)]
    for sc, seed in zip(scopes, (11, 11, 12)):
        ptt.Executor(device="cpu").run(startup, scope=sc, seed=seed)
    sc = scopes[0]
    vars_ = startup.global_block().vars
    for op in startup.global_block().ops:
        name = op.outputs["Out"][0]
        t, a = sc.get(name), op.attrs
        assert list(t.shape) == list(vars_[name].shape) == list(a["shape"]), name
        assert t.dtype == torch.float32
        if op.type == "fill_constant":
            assert torch.all(t == torch.tensor(a["value"], dtype=torch.float32)), name
        elif op.type == "uniform_random":
            assert a["min"] <= float(t.min()) and float(t.max()) <= a["max"], name
            want = (a["max"] - a["min"]) / np.sqrt(12)
            assert abs(float(t.std()) / want - 1) < 0.1, name
        else:
            assert abs(float(t.std()) / a["std"] - 1) < 0.1 and abs(float(t.mean())) < 0.1 * a["std"]
    lr = [n for n in sc.keys() if n.endswith(".lr")]
    assert len(lr) == 1 and float(sc.get(lr[0])) == np.float32(5e-4)
    moments = [n for n in sc.keys() if ".moment" in n]
    assert len(moments) == 36 and all(not sc.get(n).any() for n in moments)
    assert {float(sc.get(n)) for n in sc.keys() if "beta1_pow" in n} == {np.float32(0.9)}
    assert {float(sc.get(n)) for n in sc.keys() if "beta2_pow" in n} == {np.float32(0.999)}
    w = meta["param_names"][0]
    assert torch.equal(scopes[1].get(w), sc.get(w)) and not torch.equal(scopes[2].get(w), sc.get(w))


def test_autodiff_refuses_a_loss_that_is_not_a_scalar():
    prog = ptt.Program()
    blk = prog.global_block()
    blk.create_var("w", (3,), persistable=True, is_parameter=True)
    blk.ops.append(ptt.core.program.Operator("autodiff", {"Loss": ["w"]}, {}, {"params": ["w"]}))
    scope = ptt.Scope()
    scope.set("w", torch.ones(3))
    with pytest.raises(ValueError, match="must be scalar"):
        ptt.Executor(device="cpu").run(prog, {}, [], scope=scope)


@pytest.mark.parametrize("fetch_softmax", [True, False])
def test_softmax_output_only_where_the_run_reads_it(fetch_softmax, monkeypatch):
    """softmax_with_cross_entropy gives the JAX package's Loss, and its
    Softmax too when a fetch (or a later op) reads it; a run that does not
    read it never computes it."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp
    from jax import numpy as jnp

    rng = np.random.RandomState(9)
    logits = rng.randn(5, 7).astype(np.float32)
    label = rng.randint(0, 7, size=(5, 1)).astype(np.int32)
    slots = {"Logits": ["x"], "Label": ["y"]}
    outs = {"Softmax": ["sm"], "Loss": ["l"]}
    jenv = {"@AMP@": None, "x": jnp.asarray(logits), "y": jnp.asarray(label)}
    jreg.get_kernel("softmax_with_cross_entropy")(
        jreg.OpContext(JOp("softmax_with_cross_entropy", slots, outs, {}), jenv))
    prog = ptt.Program()
    blk = prog.global_block()
    for n in ("x", "y", "sm", "l"):
        blk.create_var(n, ())
    blk.ops.append(ptt.core.program.Operator("softmax_with_cross_entropy", slots, outs, {}))
    exps = []
    monkeypatch.setattr(torch.Tensor, "exp", lambda t: exps.append(t.shape) or torch.exp(t))
    fetch = ["l", "sm"] if fetch_softmax else ["l"]
    got = ptt.Executor(device="cpu").run(prog, {"x": logits, "y": label}, fetch,
                                         scope=ptt.Scope())
    np.testing.assert_allclose(got[0], np.asarray(jenv["l"]), rtol=1e-6, atol=1e-6)
    if fetch_softmax:
        np.testing.assert_allclose(got[1], np.asarray(jenv["sm"]), rtol=1e-6, atol=1e-7)
    assert exps == ([(5, 7)] if fetch_softmax else [])


def test_lod_gradients_reach_the_padding_as_zeros():
    """to_batch and from_batch, which only inference had run, carry
    gradients to real tokens and zeros to the padding slots."""
    rng = np.random.RandomState(0)
    lod = ptt.LoDArray.from_sequences([rng.randn(n, 4).astype(np.float32) for n in (3, 1, 2)],
                                      capacity=8, max_seqs=4)
    data = lod.data.clone().requires_grad_(True)
    batched, mask = lod.with_data(data).to_batch(max_len=3)
    (batched * torch.randn(batched.shape)).sum().backward()
    assert torch.all(data.grad[6:] == 0) and torch.all(data.grad[:6] != 0)
    dense = torch.randn(3, 4, 4, requires_grad=True)
    out = ptt.LoDArray.from_batch(dense, mask, lod)
    out.data.sum().backward()
    assert torch.equal(dense.grad, mask.float()[..., None].expand_as(dense))


def test_unported_decoder_flags_refuse_to_turn_on():
    """A decoder flag of the JAX package that the port does not define
    (fused_attention_interpret: Pallas's interpret mode, which a CUDA
    kernel has no counterpart of) refuses to be set or read, as does a
    flag that neither package defines."""
    assert FLAGS.fused_attention_interpret is False
    for flag in ("fused_attention_interpret", "fused_attention_seq_everything"):
        with pytest.raises(AttributeError, match="undefined flag"):
            setattr(ptt.FLAGS, flag, True)
        with pytest.raises(AttributeError, match="undefined flag"):
            getattr(ptt.FLAGS, flag)


def test_decoder_seq_flags_default_off_and_turn_on():
    """The whole-sequence decoder flags are ported (their kernels,
    csrc/decoder_seq.cu, are held to the JAX package's in
    tests/test_torch_seq2seq.py): off by default as in the JAX package,
    and they turn on."""
    for flag in ("fused_attention_seq_fwd", "fused_attention_seq_bwd"):
        assert getattr(ptt.FLAGS, flag) is False and getattr(FLAGS, flag) is False
        try:
            setattr(ptt.FLAGS, flag, 1)
            assert getattr(ptt.FLAGS, flag) is True
        finally:
            setattr(ptt.FLAGS, flag, False)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for _name, _widths in WIDTHS.items():
        export_nmt_train(os.path.join(ARTIFACTS, _name), **_widths)
        print(f"wrote {os.path.join(ARTIFACTS, _name)}")
