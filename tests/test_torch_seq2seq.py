"""The seq2seq front end and the whole-sequence decoder kernels (B9, B10):
bench.py's NMT training program (`_build_nmt_train`, bench.py:320-375)
built by the port's own layer DSL, model zoo and optimizer, and the
decoder's whole-sequence forward and backward (`decoder_seq_fwd_plain`,
`decoder_seq_bwd_plain`, the plain versions of csrc/decoder_seq.cu)
against the JAX package's Pallas kernels in interpret mode.

- The front end: the port's build of `_build_nmt_train` serializes to the
  committed paddle_tpu_torch/artifacts/nmt_train_{wmt,small}/ (which
  tests/test_torch_train.py holds to a fresh JAX build), main and startup,
  at the widths their meta.json records; its `seq2seq_beam_decode`
  program to the JAX package's build of the same program.
- The kernels, on inputs with a ragged source mask, a ragged target mask
  and a batch row whose target steps are all masked, at widths the JAX
  package's `fused_decoder_eligible` and its whole-sequence working-set
  models accept (A and C multiples of 128, B=8; S=10, which the JAX side
  pads to 16 and the port does not). The JAX side is compiled with XLA's
  excess precision off, so its bf16 kernel body rounds where its ops do.
  f32: every output within 1e-5 of its largest element (the same f32
  arithmetic summed in other orders; measured at most 5.3e-7, ddp). bf16:
  the outputs written in the io dtype differ in at most 0.5% of their
  values (measured at most 0.033%, ddp), and beyond one ulp by at most
  1e-5 of the largest element (4.3e-8: ddp is a softmax gradient's sum
  that nearly cancels, whose f32 total may round many of its own ulps
  apart); alpha and dv, written in f32, within 1e-5 (2.9e-7).
- The decoder Function with both seq flags on against jax.vjp of the JAX
  package's `fused_attention_decoder` with the same flags, whose dispatch
  counters show it took both whole-sequence kernels: h_seq and all nine
  gradients at tests/test_torch_attention.py's bounds.
- The model: two Adam steps of the port-built small program with both
  seq flags on, against the JAX package's build with the same flags (its
  GRU and decoder kernels in interpret mode, excess precision off in
  bf16), at tests/test_torch_train.py's bounds; then the trained weights
  re-bound by name into each package's beam program give the same ids.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu as pt  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu import models  # noqa: E402
from paddle_tpu.core.lod import LoDArray as JaxLoD  # noqa: E402
from paddle_tpu.flags import FLAGS  # noqa: E402
from paddle_tpu.ops import bahdanau_kernels as bk  # noqa: E402
from paddle_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from test_torch_attention import _NAMES, _ARGNUMS, _port_args  # noqa: E402
from test_torch_nmt_infer import build_nmt_beam  # noqa: E402
from test_torch_train import (_BF16, _F32, ARTIFACTS, FEEDS, LR, SMALL,  # noqa: E402
                              _assert_state_close, _feed, make_program_and_state)
from test_bahdanau_kernels import _make_inputs  # noqa: E402

_SEQ_FLAGS = ("fused_attention_seq_fwd", "fused_attention_seq_bwd")


def build_port(vocab, emb, enc_hidden, dec_hidden, max_len, batch=None):
    """bench.py's _build_nmt_train through the port's front end, names
    counted from 0 (the batch is the feed's). Returns (main, startup,
    loss)."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        src, trg_in, label = (ptt.layers.data(n, shape=[-1], dtype=np.int32, lod_level=1,
                                              append_batch_size=False) for n in FEEDS)
        logits = ptt.models.seq2seq_attention(
            src, trg_in, src_vocab=vocab, trg_vocab=vocab, emb_dim=emb, enc_hidden=enc_hidden,
            dec_hidden=dec_hidden, src_max_len=max_len, trg_max_len=max_len)
        tok_loss = ptt.layers.softmax_with_cross_entropy(logits, label)
        loss = ptt.layers.mean(ptt.layers.sequence_pool(tok_loss, "sum"))
        ptt.optimizer.Adam(learning_rate=5e-4).minimize(loss)
    return prog, startup, loss


# ----------------------------------------------------------- front end --
@pytest.mark.parametrize("name", ["nmt_train_small", "nmt_train_wmt"])
def test_program_matches_committed_artifact(name):
    """Main and startup equal the committed JSON; the loss and parameter
    names equal meta.json's."""
    d = os.path.join(ARTIFACTS, name)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    main, startup, loss = build_port(**meta["widths"])
    for fname, prog in (("main.json", main), ("startup.json", startup)):
        with open(os.path.join(d, fname)) as f:
            assert json.loads(json.dumps(prog.to_dict())) == json.load(f), fname
    assert loss.name == meta["loss_name"]
    assert [v.name for v in main.parameters()] == meta["param_names"]


def _port_beam(vocab, hidden, src_max_len, beam, max_len):
    """The port's counterpart of test_torch_nmt_infer.build_nmt_beam with
    stand-ins in the global scope for the shared tables: (main, decode
    program, targets)."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        src, trg_in = (ptt.layers.data(n, shape=[-1], dtype=np.int32, lod_level=1,
                                       append_batch_size=False) for n in ("src", "trg_in"))
        ptt.models.seq2seq_attention(src, trg_in, src_vocab=vocab, trg_vocab=vocab,
                                     emb_dim=hidden, enc_hidden=hidden, dec_hidden=hidden,
                                     src_max_len=src_max_len, trg_max_len=src_max_len)
    dprog, dstartup = ptt.Program(), ptt.Program()
    with ptt.program_guard(dprog, dstartup):
        src2 = ptt.layers.data("src", shape=[-1], dtype=np.int32, lod_level=1,
                               append_batch_size=False)
        targets = ptt.models.seq2seq_beam_decode(
            src2, src_vocab=vocab, trg_vocab=vocab, emb_dim=hidden, enc_hidden=hidden,
            dec_hidden=hidden, src_max_len=src_max_len, beam_size=beam, max_len=max_len)
    return prog, dprog, targets


@pytest.mark.parametrize("widths", [
    dict(vocab=1000, hidden=128, src_max_len=12, beam=4, max_len=32),
    dict(vocab=30000, hidden=512, src_max_len=50, beam=4, max_len=32)], ids=["small", "wmt"])
def test_beam_program_matches_jax(widths):
    """seq2seq_beam_decode, after the training program, re-binds the
    shared target embedding and output projection from the global scope
    by name and equals the JAX package's build of the same program."""
    pt.reset()
    jscope = pt.global_scope()
    _, j_dprog, _ = build_nmt_beam(**widths, scope_params=lambda n, shape: jscope.set(
        n, np.broadcast_to(np.zeros((), np.float32), shape)))
    tscope = ptt.global_scope()
    names = ("s2s.trg_emb", "s2s.out_w", "s2s.out_b")
    try:
        for n in names:
            tscope.set(n, torch.zeros(()).expand(tuple(np.shape(jscope.get(n)))))
        _, p_dprog, (ids, scores, lengths) = _port_beam(**widths)
    finally:
        for n in names:
            tscope.vars.pop(n, None)
    assert json.loads(json.dumps(p_dprog.to_dict())) == json.loads(json.dumps(j_dprog.to_dict()))
    assert tuple(ids.shape) == (-1, widths["beam"], widths["max_len"])
    assert [o.type for o in p_dprog.global_block().ops][-1] == "attention_gru_beam_search"


def test_beam_search_without_trained_tables_raises():
    """A beam program whose shared tables are neither declared nor in the
    global scope says so."""
    assert not ptt.global_scope().has("s2s.trg_emb")
    with pytest.raises(KeyError, match="train it first"):
        _port_beam(vocab=32, hidden=16, src_max_len=5, beam=2, max_len=3)


# ------------------------------------------------------------- kernels --
B, S, SP, T, E, C, A, H = 8, 10, 16, 6, 32, 256, 128, 128
_IO_SHARE = 0.005


def _seq_case(dtype, seed=0):
    """Seeded inputs of the whole-sequence kernels in `dtype`, with ragged
    source and target masks and row 3's target steps all masked; and the
    backward's inputs, from the plain forward and the batched recompute."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    lens = rng.randint(1, S + 1, size=B)
    tlens = rng.randint(1, T + 1, size=B)
    lens[0], tlens[0], tlens[3] = S, T, 0
    dt = getattr(torch, dtype)
    p = {k: torch.tensor(v).to(dt) for k, v in dict(
        ep=f(B, S, A), enc=f(B, S, C, sc=0.5), trg=f(T, B, E, sc=0.5), h0=f(B, H, sc=0.5),
        wa_dec=f(H, A, sc=H ** -0.5), v=f(A, sc=A ** -0.5), wx=f(E + C, 3 * H, sc=(E + C) ** -0.5),
        wh=f(H, 3 * H, sc=H ** -0.5), bias=f(3 * H, sc=0.1), g=f(T, B, H, sc=0.1)).items()}
    p["mask"] = torch.tensor((np.arange(S)[None] < lens[:, None]).astype(np.float32))
    p["tmask"] = torch.tensor((np.arange(T)[:, None] < tlens[None]).astype(np.float32))
    p["xpx"] = torch.matmul(p["trg"], p["wx"][:E]) + p["bias"]
    fwd = (p["ep"], p["enc"], p["mask"], p["xpx"], p["tmask"], p["h0"], p["wa_dec"], p["v"],
           p["wx"][E:], p["wh"][:, : 2 * H], p["wh"][:, 2 * H:])
    h_seq, alpha, ctx = ak.decoder_seq_fwd_plain(*fwd)
    hp, dp, _, u, r, _, c = ak.decoder_bwd_inputs(p["trg"], p["h0"], p["wa_dec"], p["wx"], p["wh"],
                                                  p["bias"], h_seq, ctx)
    bwd = (p["ep"], p["enc"], p["mask"], p["g"], p["tmask"], hp, u, r, c, dp, alpha, p["v"],
           p["wh"][:, 2 * H:], p["wh"][:, : 2 * H], p["wx"][E:], p["wa_dec"])
    return fwd, bwd, (h_seq, alpha, ctx)


def _to_jax(args, dtype, padded):
    """torch arguments as the JAX kernels take them: S padded to 16 for the
    tensors at `padded` ({index: axis}), f32 masks and alpha, the rest in
    `dtype`."""
    out = []
    for i, t in enumerate(args):
        a = t.float().numpy()
        if i in padded:
            a = np.pad(a, [(0, SP - S) if k == padded[i] else (0, 0) for k in range(a.ndim)])
        out.append(jnp.asarray(a).astype(jnp.float32 if t.dtype == torch.float32
                                         else jnp.dtype(dtype)))
    return out


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _assert_kernel_close(name, got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    d, scale = np.abs(got - want), float(np.abs(want).max())
    if dtype == "float32" or got.dtype == np.float32 and name in ("alpha", "dv"):
        assert d.max() <= 1e-5 * scale, (name, d.max() / scale)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.mean(got != want) <= _IO_SHARE, (name, np.mean(got != want))
    assert np.maximum(d - ulp, 0.0).max() <= 1e-5 * scale, (name, (d / ulp).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_seq_fwd_plain_matches_pallas(dtype):
    fwd, _, got = _seq_case(dtype)
    want = _jit(lambda *a: bk._decoder_seq_fwd(*a, True))(*_to_jax(fwd, dtype, {0: 1, 1: 1, 2: 1}))
    assert got[0].dtype == fwd[0].dtype and got[1].dtype == torch.float32
    for name, g, w in zip(("h_seq", "alpha", "ctx"), got, want):
        _assert_kernel_close(name, g, np.asarray(w, np.float32)[..., :S] if name == "alpha" else w,
                             dtype)
    assert np.all(np.asarray(want[1])[..., S:] == 0)  # the padding the port leaves out
    # row 3 never steps: its state stays h0
    assert torch.equal(got[0][:, 3], fwd[5][3].expand(T, H))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_seq_bwd_plain_matches_pallas(dtype):
    _, bwd, _ = _seq_case(dtype, seed=1)
    got = ak.decoder_seq_bwd_plain(*bwd)
    want = _jit(lambda *a: bk._decoder_seq_bwd(*a, jnp.dtype(dtype), True))(
        *_to_jax(bwd, dtype, {0: 1, 1: 1, 2: 1, 10: 2}))
    for name, g, w in zip(("dxp", "dctx", "ddp", "dh0", "dep", "dv"), got, want):
        w = np.asarray(w, np.float32)
        _assert_kernel_close(name, g, w[:, :S] if name == "dep" else w.reshape(g.shape), dtype)
    assert got[5].dtype == torch.float32 and got[4].dtype == bwd[0].dtype
    # row 3 never stepped: nothing reaches its cell, so its dxp is 0
    assert torch.all(got[0][:, 3] == 0)


def test_cpu_wrappers_run_plain_and_check_their_inputs():
    fwd, bwd, _ = _seq_case("float32")
    before = (ak.decoder_seq_fwd_launches, ak.decoder_seq_bwd_launches)
    fwd = [t.contiguous() for t in fwd]
    bwd = [t.contiguous() for t in bwd]
    assert all(torch.equal(a, b) for a, b in zip(ak.decoder_seq_fwd(*fwd),
                                                 ak.decoder_seq_fwd_plain(*fwd)))
    assert all(torch.equal(a, b) for a, b in zip(ak.decoder_seq_bwd(*bwd),
                                                 ak.decoder_seq_bwd_plain(*bwd)))
    assert (ak.decoder_seq_fwd_launches, ak.decoder_seq_bwd_launches) == before
    with pytest.raises(TypeError):
        ak.decoder_seq_fwd(*fwd[:3], fwd[3].bfloat16(), *fwd[4:])
    with pytest.raises(ValueError):
        ak.decoder_seq_fwd(*fwd[:8], fwd[8][:-1], *fwd[9:])
    with pytest.raises(TypeError):
        ak.decoder_seq_bwd(*bwd[:10], bwd[10].bfloat16(), *bwd[11:])
    with pytest.raises(ValueError):
        ak.decoder_seq_bwd(*bwd[:3], bwd[3][:-1], *bwd[4:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_function_matches_jax_vjp_whole_sequence(dtype, monkeypatch):
    """The port's decoder Function with both seq flags on (on the CPU the
    plain versions) against jax.vjp of the JAX package's decoder with the
    same flags, which takes both whole-sequence kernels in interpret mode;
    bounds as tests/test_torch_attention.py's."""
    monkeypatch.setattr(FLAGS, "fused_attention_interpret", True)
    for flag in _SEQ_FLAGS:
        monkeypatch.setattr(FLAGS, flag, True)
        monkeypatch.setattr(ptt.FLAGS, flag, True)
    bk.reset_dispatch_stats()
    args = _make_inputs(T=T)
    if dtype == "bfloat16":
        args = tuple(a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a for a in args)
    diff = [args[i] for i in _ARGNUMS]

    def f(*d):
        full = list(args)
        for i, a in zip(_ARGNUMS, d):
            full[i] = a
        return bk.fused_attention_decoder(*full)

    h_j, vjp = jax.vjp(f, *diff)
    r = np.sin(np.arange(np.prod(h_j.shape)).reshape(h_j.shape) * 1e-2).astype(np.float32)
    g_j = vjp(jnp.asarray(r).astype(h_j.dtype))
    assert bk.dispatch_stats["seq_fwd"] >= 1 and bk.dispatch_stats["seq_bwd"] >= 1, \
        bk.dispatch_stats
    assert bk.dispatch_stats["scan_fwd"] == 0 and bk.dispatch_stats["scan_bwd"] == 0

    pa = _port_args(args)
    leaves = [pa[i].requires_grad_(True) for i in _ARGNUMS]
    calls = []
    for name in ("decoder_seq_fwd", "decoder_seq_bwd", "attn_fwd", "attn_bwd_step"):
        fn = getattr(ak, name)
        monkeypatch.setattr(ak, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    h_p = ak.fused_attention_decoder(*pa)
    (h_p.float() * torch.tensor(r)).sum().backward()
    assert calls == ["decoder_seq_fwd", "decoder_seq_bwd"]
    h_j = np.asarray(h_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(h_p.detach().numpy(), h_j, rtol=2e-5, atol=2e-5)
        names = _NAMES
    else:
        np.testing.assert_allclose(h_p.detach().float().numpy(), h_j, rtol=3e-2, atol=3e-2)
        names = ["enc_b", "wx"]
    tol = 5e-4 if dtype == "float32" else 6e-2
    for name, g, leaf in zip(_NAMES, g_j, leaves):
        if name not in names:
            continue
        g = np.asarray(g, np.float32)
        scale = max(1e-3 if dtype == "float32" else 1.0, float(np.abs(g).max()))
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), g, rtol=tol, atol=tol * scale,
                                   err_msg=f"grad {name}")


# --------------------------------------------------------------- model --
def _run_jax(prog, loss, state, batches, amp):
    """Two steps of the JAX package's build with its GRU and decoder
    kernels (interpret mode) and both seq flags; in bf16 every jit compiled
    with XLA's excess precision off."""
    keys = ("fused_rnn_interpret", "fused_attention_interpret", "use_fused_rnn",
            "use_fused_attention") + _SEQ_FLAGS
    saved = {k: getattr(FLAGS, k) for k in keys}
    jit = jax.jit
    try:
        for k in keys:
            setattr(FLAGS, k, True)
        if amp:
            jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        bk.reset_dispatch_stats()
        scope = pt.global_scope()
        for n, v in state.items():
            scope.set(n, jnp.asarray(v))
        prog.set_amp(amp)
        names = [p.name + "@GRAD" for p in prog.parameters()]
        exe = pt.Executor()
        out1 = exe.run(prog, feed=_feed(JaxLoD, batches[0]), fetch_list=[loss.name] + names)
        out2 = exe.run(prog, feed=_feed(JaxLoD, batches[1]), fetch_list=[loss.name])
        stats = dict(bk.dispatch_stats)
        final = {n: np.array(scope.get(n), np.float32) for n in state}
    finally:
        for k, v in saved.items():
            setattr(FLAGS, k, v)
        jax.jit = jit
        prog.set_amp(None)
    return dict(loss=[float(out1[0]), float(out2[0])],
                grads={n: np.asarray(g, np.float32) for n, g in zip(names, out1[1:])},
                state=final, stats=stats)


def _run_port(state, batches, amp):
    main, _, loss = build_port(**SMALL)
    main.set_amp(amp)
    calls = {"decoder_seq_fwd": 0, "decoder_seq_bwd": 0, "attn_fwd": 0, "attn_bwd_step": 0}
    with pytest.MonkeyPatch.context() as mp:
        for flag in _SEQ_FLAGS:
            mp.setattr(ptt.FLAGS, flag, True)
        for name in calls:
            fn = getattr(ak, name)

            def spy(*a, _f=fn, _n=name):
                calls[_n] += 1
                return _f(*a)

            mp.setattr(ak, name, spy)
        scope = ptt.Scope()
        ptt.io.params_from_numpy(scope, state, "cpu")
        exe = ptt.Executor(device="cpu")
        names = [p.name + "@GRAD" for p in main.parameters()]
        out1 = exe.run(main, _feed(ptt.LoDArray, batches[0]), [loss.name] + names, scope=scope)
        out2 = exe.run(main, _feed(ptt.LoDArray, batches[1]), [loss.name], scope=scope)
    return dict(loss=[float(out1[0]), float(out2[0])], grads=dict(zip(names, out1[1:])),
                state=ptt.io.state_to_numpy(scope, list(state)), calls=calls)


@pytest.fixture(scope="module")
def runs():
    prog, loss, state, batches = make_program_and_state()
    return state, batches, {amp: (_run_jax(prog, loss, state, batches, amp),
                                  _run_port(state, batches, amp))
                            for amp in (None, "bfloat16")}


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
def test_two_adam_steps_match_jax_whole_sequence(runs, amp):
    """Both losses, every P@GRAD of the first step and the state after two
    steps (tests/test_torch_train.py's bounds); the JAX side ran both
    whole-sequence kernels each step and the port both plain versions, and
    no per-step attention."""
    _, _, out = runs
    j, p = out[amp]
    assert j["stats"]["seq_fwd"] >= 1 and j["stats"]["seq_bwd"] >= 1, j["stats"]
    assert j["stats"]["scan_fwd"] == 0 and j["stats"]["scan_bwd"] == 0, j["stats"]
    assert p["calls"] == {"decoder_seq_fwd": 2, "decoder_seq_bwd": 2, "attn_fwd": 0,
                          "attn_bwd_step": 0}
    tol = _F32 if amp is None else _BF16
    for a, b in zip(j["loss"], p["loss"]):
        assert np.isfinite(b) and abs(a - b) <= tol["loss"] * abs(a), (j["loss"], p["loss"])
    assert set(p["grads"]) == set(j["grads"]) and len(p["grads"]) == 18
    for name, a in j["grads"].items():
        b = p["grads"][name]
        scale = float(np.abs(a).max())
        d = np.abs(a - b)
        assert d.max() <= tol["grad"] * scale, (name, d.max() / scale)
        assert np.mean(d > 0.01 * scale) <= tol["grad_share"] + (tol is _F32), name
    assert set(p["state"]) == set(j["state"])
    _assert_state_close(p["state"], j["state"], tol, j["grads"], lr=LR)


def test_beam_decode_rebinds_trained_weights(runs):
    """After the f32 steps, each package's beam program (the port's built
    by its own front end) re-binds its trained weights by name from the
    global scope and decodes the same ids and lengths, scores within
    1e-4."""
    state, batches, out = runs
    (j, p) = out[None]
    widths = dict(vocab=SMALL["vocab"], emb_dim=SMALL["emb"], enc_hidden=SMALL["enc_hidden"],
                  dec_hidden=SMALL["dec_hidden"], src_max_len=SMALL["max_len"], beam_size=3,
                  max_len=5)
    srcs = batches[0][0]
    Bf, Sf = SMALL["batch"], SMALL["max_len"]
    pt.reset()
    jscope = pt.global_scope()
    for n, v in j["state"].items():
        jscope.set(n, jnp.asarray(v))
    dprog, dstart = pt.Program(), pt.Program()
    with pt.program_guard(dprog, dstart):
        src = pt.layers.data("src", shape=[-1], dtype=np.int32, lod_level=1,
                             append_batch_size=False)
        targets = models.seq2seq_beam_decode(src, trg_vocab=widths["vocab"], src_vocab=widths[
            "vocab"], **{k: v for k, v in widths.items() if k != "vocab"})
    want = pt.Executor().run(dprog, feed={"src": JaxLoD.from_sequences(
        srcs, capacity=Bf * Sf, max_seqs=Bf)}, fetch_list=list(targets))
    tscope = ptt.global_scope()
    try:
        ptt.io.params_from_numpy(tscope, p["state"], "cpu")
        ptt.reset_default_programs()
        tprog, tstart = ptt.Program(), ptt.Program()
        with ptt.program_guard(tprog, tstart):
            tsrc = ptt.layers.data("src", shape=[-1], dtype=np.int32, lod_level=1,
                                   append_batch_size=False)
            ttargets = ptt.models.seq2seq_beam_decode(
                tsrc, trg_vocab=widths["vocab"], src_vocab=widths["vocab"],
                **{k: v for k, v in widths.items() if k != "vocab"})
        got = ptt.Executor(device="cpu").run(tprog, {"src": ptt.LoDArray.from_sequences(
            srcs, capacity=Bf * Sf, max_seqs=Bf)}, list(ttargets), scope=tscope)
    finally:
        for n in state:
            tscope.vars.pop(n, None)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=1e-4)
