"""The `flash_attention` op's routing rule (paddle_tpu_torch/ops/flash_ops.py).

On the card the op sends a call to the flash kernels when
`kernel_takes(q, k, v)`: the head dim in flash_kernels.HEAD_DIMS (64, 128)
and K, V of Q's shape. Every other shape goes to the plain formula,
`scaled_dot_product_attention` (the JAX package's `_reference` op by op),
on the card, and counts in `flash_ops.plain_routes`. This is a dispatch on
shape decided before any launch, as the JAX op's `flash_eligible`; the
kernel wrappers keep raising on what they do not take.

The card is mocked: the tensors report a CUDA device, and stubs of
`flash_fused` and of the plain formula record which one the op called.
The parity tests run the op itself in both packages on the CPU, for a
cross-attention whose keys have another length than the queries, and for
a head dim of 32: bf16 (amp) bit for bit, f32 within 1e-6 of the largest
element (the bounds of test_torch_transformer.py's op tests)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu_torch.ops import flash_kernels as fk  # noqa: E402
from paddle_tpu_torch.ops import flash_ops  # noqa: E402
from test_torch_transformer import BF16, F32, _run_op  # noqa: E402


class OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the routing rule's input."""

    @property
    def device(self):
        return torch.device("cuda", 0)


# (id, q shape, k shape, v shape, the route the rule must take)
_ROUTES = [
    ("self-D64", (2, 16, 4, 64), (2, 16, 4, 64), (2, 16, 4, 64), "kernel"),
    ("self-D128", (1, 9, 2, 128), (1, 9, 2, 128), (1, 9, 2, 128), "kernel"),
    ("self-D32", (2, 16, 4, 32), (2, 16, 4, 32), (2, 16, 4, 32), "plain"),
    ("cross-D64", (2, 12, 4, 64), (2, 20, 4, 64), (2, 20, 4, 64), "plain"),
    ("v-other-D64", (2, 16, 4, 64), (2, 16, 4, 64), (2, 16, 2, 64), "plain"),
]


@pytest.mark.parametrize("case", _ROUTES, ids=lambda c: c[0])
def test_routing_rule_with_the_card_mocked(case, monkeypatch):
    _, qs, ks, vs, route = case
    calls = []

    def stub(name):
        def fn(q, k, v, causal):
            calls.append((name, tuple(q.shape), tuple(k.shape), bool(causal)))
            return torch.zeros(q.shape)
        return fn

    monkeypatch.setattr(fk, "flash_fused", stub("kernel"))
    monkeypatch.setattr(flash_ops, "scaled_dot_product_attention", stub("plain"))
    monkeypatch.setattr(flash_ops, "plain_routes", 0)
    q, k, v = (torch.zeros(s).as_subclass(OnCard) for s in (qs, ks, vs))
    assert q.device.type == "cuda"
    out = flash_ops.flash_attention(q, k, v, causal=False)
    assert calls == [(route, qs, ks, False)] and tuple(out.shape) == qs
    assert flash_ops.plain_routes == (route == "plain")
    assert flash_ops.kernel_takes(q, k, v) == (route == "kernel")


def test_cpu_tensors_take_the_plain_formula_and_count_no_route(monkeypatch):
    """On the CPU the op is the plain formula whatever the shape, and the
    counter (of plain routes on the card) stays where it was."""
    monkeypatch.setattr(flash_ops, "plain_routes", 0)
    rng = np.random.RandomState(0)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 16, 4, 64), (2, 16, 4, 64), (2, 16, 4, 64)))
    got = flash_ops.flash_attention(q, k, v, True)
    assert torch.equal(got, flash_ops.scaled_dot_product_attention(q, k, v, True))
    assert flash_ops.plain_routes == 0


@pytest.mark.parametrize("bad", ["D32", "cross", "v_shape"])
def test_kernel_wrappers_still_raise_on_what_they_do_not_take(bad):
    """The rule keeps these shapes from the kernels; the kernels' own
    checks still refuse them (on CPU tensors, before any device choice)."""
    q = torch.zeros(1, 8, 2, 32 if bad == "D32" else 64)
    k = torch.zeros(1, 5, 2, 64) if bad == "cross" else q
    v = torch.zeros(1, 8, 1, 64) if bad == "v_shape" else k
    with pytest.raises(ValueError):
        fk.flash_fused(q, k, v, False)
    with pytest.raises(ValueError):
        fk.flash_fwd(q, k, v, False)


def _cases():
    """(id, inputs, attrs, amp): the op's packed [B, T, E] projections."""
    rng = np.random.RandomState(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = []
    for amp, dt in ((None, F32), ("bfloat16", BF16)):
        tag = "f32" if amp is None else "bf16"
        # cross-attention: 12 queries over 20 keys, 2 heads of D=64
        out.append((f"cross-Tk20-Tq12-D64-{tag}",
                    {"Q": [(f(2, 12, 128), dt)], "K": [(f(2, 20, 128), dt)],
                     "V": [(f(2, 20, 128), dt)]}, {"num_heads": 2, "causal": False}, amp))
        # self-attention, 4 heads of D=32
        out.append((f"self-D32-causal-{tag}", {s: [(f(2, 16, 128), dt)] for s in ("Q", "K", "V")},
                    {"num_heads": 4, "causal": True}, amp))
    return out


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_op_matches_jax_where_the_kernels_do_not_take_the_shape(case):
    """The port's op against the JAX op, which routes these shapes to its
    `_reference` on any backend: bf16 bit for bit (the plain formula
    rounds op by op as JAX does), f32 within 1e-6 of the largest element."""
    _, inputs, attrs, amp = case
    j, t = _run_op("flash_attention", inputs, attrs, amp)
    assert t.shape == j.shape == inputs["Q"][0][0].shape
    tol = 0 if amp else 1e-6 * np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)
    assert np.abs(j).max() > 0 and jnp.isfinite(j).all()
