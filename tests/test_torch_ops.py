"""Each op of the inference slice against its JAX kernel on the same
inputs: the same registered kernel names, run through each package's
OpContext, with and without amp (bf16 dtype flow). Tolerances: f32 1e-5;
bf16 outputs are compared after rounding to bf16 on both sides, within
one bf16 ulp at the values' scale (2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.core.program import Operator as JOp
from paddle_tpu.ops import beam_common as jbc
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lod import LoDArray as TLoD
from paddle_tpu_torch.core.program import Operator as TOp
from paddle_tpu_torch.ops import beam_common as tbc


class Lod:
    """A ragged input given as a list of numpy sequences."""

    def __init__(self, seqs, capacity=None, max_seqs=None):
        self.seqs, self.capacity, self.max_seqs = seqs, capacity, max_seqs

    def jax(self):
        return JLoD.from_sequences(self.seqs, capacity=self.capacity, max_seqs=self.max_seqs)

    def torch(self):
        return TLoD.from_sequences(self.seqs, capacity=self.capacity, max_seqs=self.max_seqs)


def _run(op_type, inputs, attrs=None, amp=None, out_slot="Out", other_outs=()):
    """Run one op in both packages; returns (jax_out, torch_out). An input
    is a numpy array or a Lod (anything with .jax() and .torch());
    `other_outs` names the op's other output slots, which are not read."""
    slots = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in inputs.items()}
    jenv, tenv = {"@AMP@": amp}, {"@AMP@": amp}
    for k, vals in inputs.items():
        for name, v in zip(slots[k], vals):
            jenv[name] = v.jax() if isinstance(v, Lod) else jnp.asarray(v)
            tenv[name] = v.torch() if isinstance(v, Lod) else torch.as_tensor(v)
    outs = {out_slot: ["out"], **{slot: [f"other_{slot}"] for slot in other_outs}}
    jreg.get_kernel(op_type)(jreg.OpContext(JOp(op_type, slots, outs, dict(attrs or {})), jenv))
    treg.get_kernel(op_type)(treg.OpContext(TOp(op_type, slots, outs, dict(attrs or {})), tenv))
    return jenv["out"], tenv["out"]


def _assert_close(j, t, tol):
    if isinstance(t, TLoD):
        assert isinstance(j, JLoD)
        np.testing.assert_array_equal(t.seq_ids.numpy(), np.asarray(j.seq_ids))
        np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
        j, t = j.data, t.data
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0, atol=tol)


_AMP = [None, "bfloat16"]
_TOL = {None: 1e-5, "bfloat16": 2e-2}
rng = np.random.RandomState(0)


def _f(*shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("amp", _AMP)
@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
def test_mul(amp, lod):
    x = Lod([_f(n, 16) for n in (3, 5, 1)], capacity=16) if lod else _f(6, 16)
    j, t = _run("mul", {"X": [x], "Y": [_f(16, 24, scale=0.25)]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1}, amp)
    _assert_close(j, t, _TOL[amp])


@pytest.mark.parametrize("amp", _AMP)
def test_mul_flattens_by_num_col_dims(amp):
    j, t = _run("mul", {"X": [_f(2, 3, 4)], "Y": [_f(12, 5)]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1}, amp)
    assert tuple(t.shape) == (2, 5)
    _assert_close(j, t, _TOL[amp])


@pytest.mark.parametrize("amp", _AMP)
def test_elementwise_add_f32_operands(amp):
    """Two f32 operands stay f32 whether or not amp is on."""
    j, t = _run("elementwise_add", {"X": [_f(4, 8)], "Y": [_f(8)]}, {"axis": -1}, amp)
    _assert_close(j, t, _TOL[amp])


def test_elementwise_add_bf16_activation_keeps_bf16():
    x = _f(4, 8)
    jenv = {"@AMP@": "bfloat16", "X_0": jnp.asarray(x).astype(jnp.bfloat16),
            "Y_0": jnp.asarray(_f(8))}
    tenv = {"@AMP@": "bfloat16", "X_0": torch.tensor(x).bfloat16(),
            "Y_0": torch.tensor(np.asarray(jenv["Y_0"]))}
    slots, outs = {"X": ["X_0"], "Y": ["Y_0"]}, {"Out": ["out"]}
    jreg.get_kernel("elementwise_add")(jreg.OpContext(JOp("elementwise_add", slots, outs, {}), jenv))
    treg.get_kernel("elementwise_add")(treg.OpContext(TOp("elementwise_add", slots, outs, {}), tenv))
    assert tenv["out"].dtype == torch.bfloat16
    _assert_close(jenv["out"], tenv["out"], 0)  # one bf16 rounding of the same sum


@pytest.mark.parametrize("amp", _AMP)
@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table(amp, padding_idx):
    ids = Lod([rng.randint(0, 10, size=(n,)).astype(np.int32) for n in (4, 2, 5)],
              capacity=16)
    j, t = _run("lookup_table", {"W": [_f(10, 8)], "Ids": [ids]},
                {"is_sparse": False, "padding_idx": padding_idx}, amp)
    _assert_close(j, t, 0)  # a gather: exact, and f32 under amp as in JAX


@pytest.mark.parametrize("amp", _AMP)
@pytest.mark.parametrize("act", ["tanh", "sigmoid", "identity", "linear"])
def test_activation(amp, act):
    x = Lod([_f(n, 8) for n in (3, 2)], capacity=8)
    j, t = _run(act, {"X": [x]}, {}, amp)
    _assert_close(j, t, 1e-6)


def test_tanh_bf16_activation():
    x = _f(5, 8)
    jenv = {"@AMP@": "bfloat16", "X_0": jnp.asarray(x).astype(jnp.bfloat16)}
    tenv = {"@AMP@": "bfloat16", "X_0": torch.tensor(x).bfloat16()}
    op = ("tanh", {"X": ["X_0"]}, {"Out": ["out"]}, {})
    jreg.get_kernel("tanh")(jreg.OpContext(JOp(*op), jenv))
    treg.get_kernel("tanh")(treg.OpContext(TOp(*op), tenv))
    assert tenv["out"].dtype == torch.bfloat16
    _assert_close(jenv["out"], tenv["out"], 2 ** -7)  # one bf16 ulp below 2


@pytest.mark.parametrize("lens", [(3, 1, 4), (5,), (2, 2, 2, 2)])
def test_sequence_concat(lens):
    a = Lod([_f(n, 4) for n in lens], capacity=16)
    b = Lod([_f(n, 6) for n in lens], capacity=16)
    j, t = _run("sequence_concat", {"X": [a, b]})
    _assert_close(j, t, 0)


@pytest.mark.parametrize("max_seqs", [None, 5], ids=["full", "absent_seqs"])
def test_sequence_first_step(max_seqs):
    x = Lod([_f(n, 4) for n in (3, 1, 4)], capacity=16, max_seqs=max_seqs)
    j, t = _run("sequence_first_step", {"X": [x]})
    _assert_close(j, t, 0)


@pytest.mark.parametrize("max_len", [None, 6, 3])
@pytest.mark.parametrize("time_major", [True, False])
def test_lod_to_batch_from_batch(max_len, time_major):
    seqs = [_f(n, 3) for n in (5, 1, 6, 3)]
    jl = JLoD.from_sequences(seqs, capacity=32, max_seqs=6)
    tl = TLoD.from_sequences(seqs, capacity=32, max_seqs=6)
    for name in ("data", "seq_ids", "lengths", "num_seqs"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)))
    np.testing.assert_array_equal(tl.offsets.numpy(), np.asarray(jl.offsets))
    np.testing.assert_array_equal(tl.token_mask.numpy(), np.asarray(jl.token_mask))
    jb, jm = jl.to_batch(max_len=max_len, time_major=time_major)
    tb, tm = tl.to_batch(max_len=max_len, time_major=time_major)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if time_major:
        jr = JLoD.from_batch(jb, jm, jl)
        tr = TLoD.from_batch(tb, tm, tl)
        np.testing.assert_array_equal(tr.data.numpy(), np.asarray(jr.data))
        if max_len is None:  # the round trip is exact when nothing was cut
            np.testing.assert_array_equal(tr.data.numpy(), tl.data.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", [3, 40, None], ids=["many_ties", "some_ties", "no_ties"])
def test_topk_order_matches_lax_top_k(dtype, levels):
    """Ties break toward the lower index, as jax.lax.top_k promises."""
    r = np.random.RandomState(levels or 1)
    x = (r.randint(0, levels, size=(6, 50)) if levels else r.randn(6, 50)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x).astype(jnp.dtype(dtype)), 7)
    tv, ti = tbc.topk_lowest_index(torch.tensor(x).to(getattr(torch, dtype)), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


@pytest.mark.parametrize("length_normalize", [False, True])
def test_beam_common_matches_jax(length_normalize):
    """expand_prune over a frozen beam, backtrack and finalize, step by
    step against paddle_tpu.ops.beam_common on the same numbers."""
    B_, K_, V_, T_, eos = 3, 4, 9, 5, 1
    r = np.random.RandomState(7)
    jsc, tsc = jbc.init_scores(B_, K_), tbc.init_scores(B_, K_)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    jfin = jnp.zeros((B_, K_), bool)
    tfin = torch.zeros((B_, K_), dtype=torch.bool)
    jp, jt, tp, tt = [], [], [], []
    for _ in range(T_):
        logits = r.randn(B_, K_, V_).astype(np.float32)
        logits[..., eos] += 1.0  # finish some beams early
        logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
        jl = jbc.freeze_finished(jnp.asarray(logp), jfin, eos)
        tl = tbc.freeze_finished(torch.tensor(logp), tfin, eos)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        jsc, jpar, jtok = jbc.expand_prune(jsc, jl, K_)
        tsc, tpar, ttok = tbc.expand_prune(tsc, tl, K_)
        np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=1e-6)
        jfin = jnp.take_along_axis(jfin, jpar, axis=1) | (jtok == eos)
        tfin = torch.gather(tfin, 1, tpar) | (ttok == eos)
        jp.append(jpar), jt.append(jtok), tp.append(tpar), tt.append(ttok)
    jids = jbc.backtrack(jnp.stack(jp), jnp.stack(jt), B_, K_)
    tids = tbc.backtrack(tp, tt, B_, K_)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    jout = jbc.finalize(jids, jsc, eos, T_, length_normalize)
    tout = tbc.finalize(tids, tsc, eos, T_, length_normalize)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)

