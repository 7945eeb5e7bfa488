"""The CTC ops against the JAX package (paddle_tpu/ops/ctc_ops.py).

`ctc_loss` and `warpctc` take the same numpy logits and labels in both
packages: the loss within 1e-5 of its scale (its largest |value|, at least
1) and its gradient to the logits within 1e-5 of the gradient's scale, in
f32, with blank 0 and blank C-1, an empty label, an absent sequence and
norm_by_times. An infeasible alignment (more labels than frames) gives
the JAX op's floor value, 1e30, on both sides. The feasible losses also
agree with `torch.nn.functional.ctc_loss` within 1e-4 of their scale: the
yardstick the JAX package's own test uses (tests/test_ctc.py:16), never a
path of the port. `ctc_greedy_decoder`'s ids and lengths are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.lod import LoDArray as JLoD
from paddle_tpu.ops import ctc_ops as jctc
from paddle_tpu_torch.core.lod import LoDArray as TLoD
from paddle_tpu_torch.ops import ctc_ops as tctc

from test_torch_ops_general import one_thread  # noqa: F401

C = 6
T_MAX, L_MAX = 12, 5


def _case(blank, frames, labels, seed=0):
    """Logit sequences of the given frame counts and label sequences, the
    labels drawn from the non-blank classes."""
    rng = np.random.RandomState(seed)
    logits = [rng.standard_normal((n, C)).astype(np.float32) for n in frames]
    classes = [c for c in range(C) if c != blank]
    lbls = [np.asarray(rng.choice(classes, n), np.int32) for n in labels]
    return logits, lbls


CASES = {
    "blank0": (0, (12, 7, 9), (5, 2, 3)),
    "blank_last": (C - 1, (12, 7, 9), (5, 2, 3)),
    "empty_label": (0, (6, 8), (0, 3)),
    "repeats": (0, (10, 10), (4, 4)),
    "infeasible": (0, (3, 9), (5, 2)),
}


@jax.jit
def _jax_loss_grad_jit(jx, jl, blank, cot):
    return _jax_loss_grad_impl(jx, jl, blank, cot, False)


@jax.jit
def _jax_loss_grad_norm(jx, jl, blank, cot):
    return _jax_loss_grad_impl(jx, jl, blank, cot, True)


def _jax_loss_grad_impl(jx, jl, blank, cot, norm_by_times):
    def f(data):
        nll = jctc.ctc_loss(jx.with_data(data), jl, blank=blank, max_len=T_MAX,
                            max_label_len=L_MAX)
        if norm_by_times:
            nll = nll / jnp.maximum(jx.lengths, 1).astype(nll.dtype)
        return nll

    nll, vjp = jax.vjp(f, jx.data)
    return nll, vjp(cot)[0]


def _jax_loss_grad(jx, jl, blank, cot, norm_by_times):
    """The JAX loss and its VJP, one compile a flag for every case (the
    shapes and the blank traced)."""
    fn = _jax_loss_grad_norm if norm_by_times else _jax_loss_grad_jit
    nll, g = fn(jx, jl, blank, cot)
    return np.asarray(nll), np.asarray(g)


def _loss_both(name, norm_by_times=False, max_seqs=4):
    blank, frames, labels = CASES[name]
    logits, lbls = _case(blank, frames, labels, seed=len(name))
    if name == "repeats":  # a label repeated back to back needs a blank between
        lbls = [np.asarray([1, 1, 2, 2], np.int32), np.asarray([3, 3, 3, 1], np.int32)]
    jx = JLoD.from_sequences(logits, capacity=32, max_seqs=max_seqs)
    jl = JLoD.from_sequences(lbls, capacity=16, max_seqs=max_seqs)
    cot = np.random.RandomState(1).rand(max_seqs).astype(np.float32)
    jnll, jg = _jax_loss_grad(jx, jl, jnp.int32(blank), jnp.asarray(cot), norm_by_times)
    tx = TLoD.from_sequences(logits, capacity=32, max_seqs=max_seqs)
    tl = TLoD.from_sequences(lbls, capacity=16, max_seqs=max_seqs)
    data = tx.data.clone().requires_grad_(True)
    tnll = tctc.ctc_loss(tx.with_data(data), tl, blank=blank, max_len=T_MAX,
                         max_label_len=L_MAX)
    if norm_by_times:
        tnll = tnll / tx.lengths.clamp(min=1).to(tnll.dtype)
    (tnll * torch.as_tensor(cot)).sum().backward()
    return (jnll, jg), (tnll.detach().numpy(), data.grad.numpy()), (logits, lbls, blank)


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("norm", [False, True], ids=["sum", "norm_by_times"])
@pytest.mark.parametrize("name", ["blank0", "blank_last", "empty_label", "repeats"])
def test_ctc_loss_and_gradient_equal_jax(name, norm, one_thread):
    (jn, jg), (tn, tg), (logits, lbls, blank) = _loss_both(name, norm)
    _close(tn, jn, 1e-5)
    _close(tg, jg, 1e-5)
    assert tn[len(logits):].tolist() == [0.0] * (4 - len(logits))  # absent sequences
    if norm:
        return
    # the yardstick: torch's own CTC on the same log-probabilities
    ref = torch.nn.functional.ctc_loss(
        torch.nn.utils.rnn.pad_sequence([torch.log_softmax(torch.as_tensor(x), -1)
                                         for x in logits]),
        torch.nn.utils.rnn.pad_sequence([torch.as_tensor(y).long() for y in lbls],
                                        batch_first=True) if max(map(len, lbls)) else
        torch.zeros((len(lbls), 1), dtype=torch.long),
        torch.tensor([len(x) for x in logits]), torch.tensor([len(y) for y in lbls]),
        blank=blank, reduction="none", zero_infinity=False)
    _close(tn[:len(logits)], ref.numpy(), 1e-4)


def test_infeasible_alignment_gives_the_floor(one_thread):
    """Five labels in three frames: no alignment. Both packages give
    -logaddexp(_NEG, _NEG) = 1e30 there, not inf; the feasible sequence
    beside it keeps its loss and gradient."""
    (jn, jg), (tn, tg), _ = _loss_both("infeasible")
    assert tn[0] == np.float32(1e30) == jn[0]
    _close(tn[1:], jn[1:], 1e-5)
    _close(tg[3:12], jg[3:12], 1e-5)  # the second sequence's frames


def _jax_run(op, ins, outs, attrs, env):
    """The JAX op on `env`, jitted: its outputs by name."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.program import Operator as JOp

    def f(env):
        env = dict(env)
        jreg.get_kernel(op)(jreg.OpContext(JOp(op, ins, outs, attrs), env))
        return {n: env[n] for ns in outs.values() for n in ns}

    return jax.jit(f)(env)


def test_warpctc_op_equals_jax():
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator as TOp

    logits, lbls = _case(0, (9, 4), (3, 1), seed=3)
    attrs = {"blank": 0, "norm_by_times": True, "max_len": 10, "max_label_len": 4}
    ins = {"Logits": ["l"], "Label": ["y"]}
    tenv = {"l": TLoD.from_sequences(logits, capacity=16),
            "y": TLoD.from_sequences([y[:, None] for y in lbls], capacity=8)}
    jenv = _jax_run("warpctc", ins, {"Loss": ["o"]}, attrs,
                    {"l": JLoD.from_sequences(logits, capacity=16),
                     "y": JLoD.from_sequences([y[:, None] for y in lbls], capacity=8)})
    treg.get_kernel("warpctc")(treg.OpContext(TOp("warpctc", ins, {"Loss": ["o"]}, attrs), tenv))
    assert tuple(tenv["o"].shape) == (2, 1)
    _close(tenv["o"].numpy(), np.asarray(jenv["o"]), 1e-5)


@pytest.mark.parametrize("blank", [0, C - 1])
def test_greedy_decoder_equals_jax(blank):
    """Argmax per frame (the first of equal maxima), repeats collapsed,
    blanks dropped, -1 padding, lengths; a ragged batch with an absent
    sequence and tied frames."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator as TOp

    rng = np.random.RandomState(blank)
    seqs = [rng.randint(0, 3, (n, C)).astype(np.float32) for n in (9, 1, 6)]
    seqs[0][2:5] = seqs[0][1]  # a run of one symbol
    ins, outs = {"Logits": ["l"]}, {"Ids": ["i"], "Lengths": ["n"]}
    attrs = {"blank": blank, "max_len": 10}
    tenv = {"l": TLoD.from_sequences(seqs, capacity=24, max_seqs=4)}
    jenv = _jax_run("ctc_greedy_decoder", ins, outs, attrs,
                    {"l": JLoD.from_sequences(seqs, capacity=24, max_seqs=4)})
    treg.get_kernel("ctc_greedy_decoder")(treg.OpContext(
        TOp("ctc_greedy_decoder", ins, outs, attrs), tenv))
    for k in ("i", "n"):
        assert tenv[k].dtype == torch.int32
        np.testing.assert_array_equal(tenv[k].numpy(), np.asarray(jenv[k]))
    assert int(tenv["n"][3]) == 0 and bool((tenv["i"][3] == -1).all())
