"""bench.py's transformer LM (`_build_transformer_train`, bench.py:378-422)
in the port against the JAX package, on the CPU, at the small width of
tests/test_transformer.py (dim 32, 4 heads, 2 layers, T=16, vocab 32, B=8)
and, for the program alone, at the `all` sweep's full width (dim 2048, 32
heads, 8 layers, T=1024, vocab 32000).

The JAX package runs attention off the TPU through its plain `_reference`
formula (flash_ops.py:35-48), the oracle here: the port's CPU path is the
same formula op by op, and the plain versions of its three flash kernels
(ops/flash_kernels.py) are held to it and to its VJP.

Tolerances, each with its reading:

- The kernels' plain versions in f32 against `_reference` and jax.vjp of
  it: within 2e-6 of each output's largest element (measured at most
  6.2e-7, dQ). In bf16 io, from the same bf16 inputs, against `_reference`
  in f32: within 2e-2 (measured 4.9e-3, dK), the bf16 rounding of P and
  dS and of each output.
- The plain formula (the op's CPU path) in f32: within 2e-6 (measured
  3.8e-7); in bf16 the forward has the same bits as `_reference` in bf16,
  and the gradients, autograd through the op-by-op formula where JAX
  differentiates its softmax by its custom JVP (other roundings), are
  within 5e-2 of their largest element (measured 1.5e-2).
- Ops at the model's shapes: bf16 outputs bit for bit (gelu among them:
  F.gelu(approximate="tanh"), rounded once, differs in 41% of them); f32
  outputs within 1e-6 of their largest element (measured at most
  1.4e-7). layer_norm: XLA sums its statistics in order, torch in
  vectorised partial sums, so f32 outputs are within 1e-6 (measured
  1.6e-7, half of them differing) and in bf16 at most 1% of them differ,
  by one ulp (measured none here; 0.02% of the second block's first
  layer_norm in the model).
- Two Adam(3e-4) steps from the JAX startup's state, with
  test_torch_train's bounds. f32: losses within 1e-5 relative (measured
  1.8e-7), every gradient within 2e-5 of its largest element (9.5e-7),
  every parameter value within 0.05 lr (0.005 lr). bf16, the JAX side
  compiled with XLA's excess precision off: losses within 1e-4 relative
  (8.0e-6, 4.2e-6); weight gradients within 5e-2 of their largest element
  (1.7e-2), at most 3% of a weight's values beyond 0.1 lr, the values
  whose gradient is past 5% of the largest within 0.5 lr (0.17 lr). The
  1-D parameters (biases, layer norms: 32 or 128 values) take
  test_torch_frontend's bias bounds: gradients within 0.1 (2.6e-2), moments
  within 0.2, and at most 10% of the values beyond 0.1 lr (measured 6.25%:
  two of 32), since one gradient near 0 that flips sign moves its value by
  about 2 lr. The key projection's bias is held apart: a per-row shift of
  the scores leaves softmax unchanged, so its gradient is 0 in exact
  arithmetic and rounding noise on both sides, held below 1e-5 (f32,
  measured 3.7e-7) and 5e-2 (bf16, 1.4e-2) of the query bias's largest.
"""

import functools
import json
import math
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
from paddle_tpu.ops import flash_ops as jflash  # noqa: E402
from paddle_tpu_torch.ops import flash_kernels as fk  # noqa: E402
from paddle_tpu_torch.ops import flash_ops  # noqa: E402
from test_torch_ops import Lod, _run  # noqa: E402
from test_torch_train import _BF16, _F32, _assert_state_close  # noqa: E402

WIDTHS = {
    "small": dict(dim=32, heads=4, layers=2, seqlen=16, vocab=32),
    # bench.py's `all` sweep, transformer row (bench.py:445-446)
    "full": dict(dim=2048, heads=32, layers=8, seqlen=1024, vocab=32000),
}
B = 8
LR = 3e-4  # bench.py's Adam(learning_rate=3e-4)
_TO_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def build(pkg, dim, heads, layers, seqlen, vocab):
    """bench.py's _build_transformer_train through `pkg`'s front end, names
    counted from 0, amp left off. Returns (main, startup, loss)."""
    if pkg is pt:
        pt.reset()
        zoo = models
    else:
        ptt.reset_default_programs()
        zoo = ptt.models
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        toks = pkg.layers.data("toks", shape=[seqlen], dtype=np.int32)
        labels = pkg.layers.data("labels", shape=[seqlen, 1], dtype=np.int32)
        logits = zoo.transformer_lm(toks, vocab_size=vocab, dim=dim, num_heads=heads,
                                    num_layers=layers, max_len=seqlen)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, labels))
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return prog, startup, loss


def _qkv(rng, shape, dtype, n=4):
    """n seeded [B,T,H,D] arrays: numpy f32 values already rounded to dtype."""
    out = []
    for _ in range(n):
        a = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        out.append(a.float().numpy())
    return out


def _jax_ref(arrs, causal, jdt):
    """`_reference` and its VJP (cotangent arrs[3]) in the JAX package."""
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in arrs)
    o, vjp = jax.vjp(lambda q, k, v: jflash._reference(q, k, v, causal), q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *vjp(do))]


def _rel(got, want):
    got = got.float().detach().numpy() if torch.is_tensor(got) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------- attention --
@pytest.mark.parametrize("shape", [(2, 37, 2, 64), (1, 20, 3, 128)], ids=["D64", "D128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernel_plain_versions_match_jax_reference(shape, dtype, causal):
    """flash_fwd_plain, flash_bwd_dkv_plain and flash_bwd_dq_plain (the
    functions the three kernels compute), through `flash_fused`, the
    autograd Function the card runs, which on CPU tensors calls them, with
    Di from flash_di: against `_reference` and its VJP in f32 on the same
    (bf16-rounded) values; a ragged T and both head dims."""
    arrs = _qkv(np.random.RandomState(1), shape, dtype)
    want = _jax_ref(arrs, causal, jnp.float32)
    q, k, v, do = (torch.as_tensor(a).to(dtype).requires_grad_(True) for a in arrs)
    o = fk.flash_fused(q, k, v, causal)
    assert o.dtype == dtype and o.shape == q.shape
    grads = torch.autograd.grad(o, (q, k, v), do.detach())
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert got.dtype == dtype, name
        assert _rel(got, w) <= tol, (name, _rel(got, w))
    # LSE from the forward's plain version: log Σ exp(s) of each row
    _, lse = fk.flash_fwd_plain(*(t.detach() for t in (q, k, v)), causal)
    s = np.einsum("bqhd,bkhd->bhqk", arrs[0], arrs[1]) / math.sqrt(shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_formula_matches_jax_reference(dtype, causal):
    """The op's CPU path, the plain formula, against `_reference` in the
    same dtype: the forward and the three gradients."""
    shape = (2, 16, 4, 8)  # the small model's heads: dim 32 over 4
    arrs = _qkv(np.random.RandomState(2), shape, dtype)
    want = _jax_ref(arrs, causal, _TO_JNP[dtype])
    q, k, v, do = (torch.as_tensor(a).to(dtype).requires_grad_(True) for a in arrs)
    o = flash_ops.flash_attention(q, k, v, causal)
    grads = torch.autograd.grad(o, (q, k, v), do.detach())
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(o.float().detach().numpy(), want[0])
    tol = 2e-6 if dtype == torch.float32 else 5e-2
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert got.dtype == dtype, name
        assert _rel(got, w) <= tol, (name, _rel(got, w))


def test_kernel_wrappers_check_their_inputs():
    """Head dims other than 64 and 128, and mismatched inputs, raise on any
    device; the op's CPU path takes the small model's D=8 through the
    plain formula."""
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_fwd(q, q, q, True)
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="k must be"):
        fk.flash_fwd(q, torch.zeros(1, 5, 2, 64), q, True)
    with pytest.raises(TypeError, match="v is"):
        fk.flash_fwd(q, q, q.to(torch.bfloat16), True)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="di must be"):
        fk.flash_bwd_dq(q, q, q, q, lse, torch.zeros(1, 4, 2), True)
    with pytest.raises(ValueError, match="expected"):
        flash_ops.flash_attention(q[0], q[0], q[0], True)
    assert flash_ops.flash_attention(*(torch.ones(1, 4, 2, 8),) * 3, True).shape == (1, 4, 2, 8)


# ------------------------------------------------------------------- ops --
class Cast(Lod):
    """A numpy input cast to one torch dtype (and its jnp twin) on both
    sides; ints stay as they are."""

    def __init__(self, a, dtype):
        self.a, self.dtype = a, dtype

    def jax(self):
        a = jnp.asarray(self.a)
        return a.astype(_TO_JNP[self.dtype]) if a.dtype.kind == "f" else a

    def torch(self):
        t = torch.as_tensor(self.a)
        return t.to(self.dtype) if t.is_floating_point() else t


def _run_op(op_type, inputs, attrs, amp=None, out_slot="Out"):
    """One op in both packages (test_torch_ops._run): `inputs` maps a slot
    to a list of (numpy array, torch dtype). Returns (jax, torch) as f32
    numpy arrays, after checking that their dtypes and shapes agree."""
    other = ("Softmax",) if op_type == "softmax_with_cross_entropy" else ()
    j, t = _run(op_type, {k: [Cast(*v) for v in vals] for k, vals in inputs.items()}, attrs,
                amp, out_slot, other)
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    assert tuple(t.shape) == tuple(j.shape)
    return np.asarray(j, np.float32), t.float().numpy()


F32, BF16 = torch.float32, torch.bfloat16


def _op_cases():
    """(id, op, inputs, attrs, amp, out_slot) at the small model's shapes
    (B=2, T=16, dim 32, vocab 32), each the way the program feeds it."""
    rng = np.random.RandomState(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ids = rng.randint(0, 32, (2, 16)).astype(np.int32)
    return [
        ("mul-3d", "mul", {"X": [(f(2, 16, 32), F32)], "Y": [(f(32, 128) / 6, F32)]},
         {"x_num_col_dims": 2, "y_num_col_dims": 1}, "bfloat16", "Out"),
        ("add-pos-table", "elementwise_add", {"X": [(f(2, 16, 32), F32)], "Y": [(f(16, 32), F32)]},
         {"axis": -1}, "bfloat16", "Out"),
        ("add-residual", "elementwise_add",
         {"X": [(f(2, 16, 32), F32)], "Y": [(f(2, 16, 32), BF16)]}, {"axis": -1}, "bfloat16", "Out"),
        ("lookup-dense", "lookup_table", {"W": [(f(32, 32), F32)], "Ids": [(ids, F32)]},
         {"is_sparse": False, "padding_idx": None}, "bfloat16", "Out"),
        ("crop", "crop", {"X": [(f(32, 32), F32)]}, {"offsets": [0, 0], "shape": [16, 32]},
         "bfloat16", "Out"),
        ("gelu-bf16", "gelu", {"X": [(3 * f(2, 16, 128), BF16)]}, {}, "bfloat16", "Out"),
        ("gelu-f32", "gelu", {"X": [(3 * f(2, 16, 128), F32)]}, {}, None, "Out"),
        ("flash-op-bf16", "flash_attention",
         {s: [(f(2, 16, 32), BF16)] for s in ("Q", "K", "V")}, {"num_heads": 4, "causal": True},
         "bfloat16", "Out"),
        ("flash-op-f32", "flash_attention",
         {s: [(f(2, 16, 32), F32)] for s in ("Q", "K", "V")}, {"num_heads": 4, "causal": True},
         None, "Out"),
        ("swce-dense", "softmax_with_cross_entropy",
         {"Logits": [(f(2, 16, 32), BF16)], "Label": [(ids[..., None], F32)]},
         {"soft_label": False}, "bfloat16", "Loss"),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_op_matches_jax_at_the_model_shapes(case):
    """Bit for bit where the outputs are bf16: the products round once from
    an f32 sum on both sides, and gelu and the plain attention formula
    round op by op as JAX does. An f32 output within 1e-6 of its largest
    element: XLA takes the log-softmax's sum in order and has its own
    tanh and exp."""
    _, op, inputs, attrs, amp, slot = case
    j, t = _run_op(op, inputs, attrs, amp, slot)
    exact = amp is not None and op != "softmax_with_cross_entropy"
    tol = 0 if exact or op in ("crop", "lookup_table") else 1e-6 * np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    """Over the last axis of [B,T,dim] (begin_norm_axis=2), Scale and Bias
    f32 parameters; the output in x's dtype."""
    rng = np.random.RandomState(4)
    x = (2 * rng.standard_normal((8, 16, 64)) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    j, t = _run_op("layer_norm", {"X": [(x, dtype)], "Scale": [(scale, F32)],
                                  "Bias": [(bias, F32)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}, "bfloat16", "Y")
    if dtype == F32:
        assert np.abs(t - j).max() <= 1e-6 * np.abs(j).max()
    else:
        d = t != j
        assert d.mean() <= 0.01
        ulp = 2.0 ** (np.floor(np.log2(np.abs(j[d]))) - 7)
        assert (np.abs(t - j)[d] <= ulp).all()


# --------------------------------------------------------------- program --
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_program_matches_jax(width):
    """Main and startup serialize to the JAX package's dicts, with bench.py's
    ops; at full width about 536 M parameters in 16·8 + 5 variables."""
    j_main, j_start, _ = build(pt, **WIDTHS[width])
    p_main, p_start, _ = build(ptt, **WIDTHS[width])
    for j, p in ((j_main, p_main), (j_start, p_start)):
        assert json.loads(json.dumps(p.to_dict())) == json.loads(json.dumps(j.to_dict()))
    n = WIDTHS[width]["layers"]
    ops = [o.type for o in p_main.global_block().ops]
    counts = {t: ops.count(t) for t in set(ops)}
    params = p_main.parameters()
    assert counts == {"lookup_table": 1, "crop": 1, "elementwise_add": 1 + 8 * n,
                      "layer_norm": 2 * n + 1, "mul": 6 * n + 1, "flash_attention": n,
                      "gelu": n, "softmax_with_cross_entropy": 1, "mean": 1, "autodiff": 1,
                      "adam": len(params)}
    assert len(params) == 16 * n + 5
    if width == "full":
        assert sum(math.prod(p.shape) for p in params) == 536_039_424


def test_model_refuses_what_is_not_ported():
    ptt.reset_default_programs()
    with ptt.program_guard(ptt.Program(), ptt.Program()):
        toks = ptt.layers.data("toks", shape=[8], dtype=np.int32)
        with pytest.raises(NotImplementedError, match="mp_axis"):
            ptt.models.transformer_lm(toks, vocab_size=16, dim=16, num_heads=2, mp_axis="mp")
        # train-mode dropout is ported: two dropout ops a block
        ptt.models.transformer_lm(toks, vocab_size=16, dim=16, num_heads=2, num_layers=2,
                                  dropout_prob=0.1)
        ops = [o.type for o in ptt.default_main_program().global_block().ops]
        assert ops.count("dropout") == 4


# -------------------------------------------------------------- training --
def _jax_state(width="small", seed=3):
    """The JAX startup's state (every persistable) as numpy arrays."""
    prog, startup, _ = build(pt, **WIDTHS[width])
    startup.random_seed = seed
    pt.Executor().run(startup)
    scope = pt.global_scope()
    return {v.name: np.array(scope.get(v.name)) for v in prog.persistables()}


def _feeds():
    rng = np.random.RandomState(0)
    T, V = WIDTHS["small"]["seqlen"], WIDTHS["small"]["vocab"]
    return [{"toks": rng.randint(0, V, (B, T)).astype(np.int32),
             "labels": rng.randint(0, V, (B, T, 1)).astype(np.int32)} for _ in range(2)]


@pytest.fixture(scope="module")
def state():
    return _jax_state()


def _train_jax(state, feeds, amp):
    prog, _, loss = build(pt, **WIDTHS["small"])
    prog.set_amp(amp)
    scope = pt.global_scope()
    for n, v in state.items():
        scope.set(n, jnp.asarray(v))
    grads = [p.name + "@GRAD" for p in prog.parameters()]
    exe = pt.Executor()
    jit = jax.jit
    try:
        if amp:
            jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        first = exe.run(prog, feed=feeds[0], fetch_list=[loss.name] + grads)
        second = exe.run(prog, feed=feeds[1], fetch_list=[loss.name])
    finally:
        jax.jit = jit
    return ([float(first[0]), float(second[0])],
            {g: np.asarray(a, np.float32) for g, a in zip(grads, first[1:])},
            {n: np.array(scope.get(n), np.float32) for n in state})


def _train_port(state, feeds, amp):
    prog, _, loss = build(ptt, **WIDTHS["small"])
    prog.set_amp(amp)
    scope = ptt.Scope()
    ptt.io.params_from_numpy(scope, state, "cpu")
    grads = [p.name + "@GRAD" for p in prog.parameters()]
    exe = ptt.Executor(device="cpu")
    first = exe.run(prog, feeds[0], [loss.name] + grads, scope=scope)
    second = exe.run(prog, feeds[1], [loss.name], scope=scope)
    return ([float(first[0]), float(second[0])], dict(zip(grads, first[1:])),
            ptt.io.state_to_numpy(scope, list(state)))


_NULL_GRAD = ".attn.wk_b"  # the key projection's bias: see the module docstring
_NULL_GRAD_TOL = {None: 1e-5, "bfloat16": 5e-2}
# bf16 bounds for the 1-D parameters (see the module docstring)
_BF16_VECTOR = dict(_BF16, robust_grad=0.1, share=0.1, moment=0.2, moment_share=1.0)
_BF16_VECTOR_GRAD = 0.1


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
def test_two_adam_steps_match_jax(state, amp):
    """Both losses, every P@GRAD of the first step, and every parameter,
    Adam moment, beta power and the learning rate after two steps, from
    the JAX startup's state carried across by params_from_numpy."""
    feeds = _feeds()
    jl, jg, js = _train_jax(state, feeds, amp)
    pl, pg, ps = _train_port(state, feeds, amp)
    tol = _F32 if amp is None else _BF16
    for a, b in zip(jl, pl):
        assert np.isfinite(b) and abs(a - b) <= tol["loss"] * abs(a), (jl, pl)
    assert set(pg) == set(jg) and len(pg) == 16 * WIDTHS["small"]["layers"] + 5
    for name, a in jg.items():
        b = pg[name]
        d, scale = np.abs(a - b), float(np.abs(a).max())
        if _NULL_GRAD in name:
            ref = np.abs(jg[name.replace(_NULL_GRAD, ".attn.wq_b")]).max()
            assert max(scale, np.abs(b).max()) <= _NULL_GRAD_TOL[amp] * ref, name
        elif amp is None or a.ndim == 2:
            assert d.max() <= tol["grad"] * scale, (name, d.max() / scale)
            assert np.mean(d > 0.01 * scale) <= tol["grad_share"] or amp is None, name
        else:
            assert d.max() <= _BF16_VECTOR_GRAD * scale, (name, d.max() / scale)
    held = [n for n in js if _NULL_GRAD not in n]
    if amp is None:
        _assert_state_close({n: ps[n] for n in held}, {n: js[n] for n in held}, tol, jg, lr=LR)
        return
    vector = {n for n in js if n in state and state[n].ndim == 1}
    for subset, t in ((lambda n: not any(v in n for v in vector), _BF16),
                      (lambda n: any(v in n for v in vector), _BF16_VECTOR)):
        keep = [n for n in held if subset(n)]
        _assert_state_close({n: ps[n] for n in keep}, {n: js[n] for n in keep}, t, jg, lr=LR)


def test_causality():
    """A changed last token leaves the logits of every earlier position
    unmoved and moves the last position's (the port's CPU path, f32)."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        toks = ptt.layers.data("toks", shape=[8], dtype=np.int32)
        logits = ptt.models.transformer_lm(toks, vocab_size=16, dim=16, num_heads=2,
                                           num_layers=1, max_len=8, is_test=True)
    scope = ptt.Scope()
    exe = ptt.Executor(device="cpu")
    exe.run(startup, scope=scope, seed=1)
    a = np.random.RandomState(1).randint(0, 16, (2, 8)).astype(np.int32)
    b = a.copy()
    b[:, -1] = (b[:, -1] + 1) % 16
    la, lb = (exe.run(prog, {"toks": t}, [logits.name], scope=scope)[0] for t in (a, b))
    np.testing.assert_array_equal(la[:, :-1], lb[:, :-1])
    assert not np.allclose(la[:, -1], lb[:, -1])
