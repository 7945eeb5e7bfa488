"""Ring and Ulysses attention (paddle_tpu_torch/parallel/ring_attention.py)
on two gloo ranks of an `sp` axis, against the JAX package's oracle
`scaled_dot_product_attention` and jax.vjp of it, on the CPU.

One spawned group (a module fixture, `file://` rendezvous under
tmp_path, one thread a rank) runs every case's port side: each rank takes
its T/2 shard of the same seeded q, k, v and cotangent, and writes its
output and its q, k, v gradients; the test joins the shards along T.
The module imports neither jax nor paddle_tpu at the top: the ranks
re-import it.

Tolerance (f32): outputs and gradients within 2e-6 of each one's largest
element (the ring's online softmax reassociates the sums; measured at most
4.5e-7).
"""

import os

import numpy as np
import pytest
import torch

WORLD = 2
CASES = [("ring", True), ("ring", False), ("ulysses", True), ("ulysses", False)]
SHAPE = (2, 12, 4, 8)  # B, T, H, D
TOL = 2e-6


def _inputs(causal):
    rng = np.random.RandomState(3 if causal else 4)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _rank_main(rank, init, out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.parallel import distributed

    distributed.init_distributed(init, WORLD, rank, device="cpu")
    try:
        mesh = par.mesh_from_spec("sp2")
        out = {}
        for kind, causal in CASES:
            q, k, v, do = (par.shard_sequence(torch.as_tensor(a), mesh) for a in
                           _inputs(causal))
            q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
            fn = par.ring_attention if kind == "ring" else par.ulysses_attention
            o = fn(q, k, v, mesh, causal=causal)
            o.backward(do)
            tag = f"{kind}.{causal}"
            out.update({f"{tag}.o": o.detach().numpy(), f"{tag}.dq": q.grad.numpy(),
                        f"{tag}.dk": k.grad.numpy(), f"{tag}.dv": v.grad.numpy()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("sp")
    mp.spawn(_rank_main, args=(f"file://{d / 'rendezvous'}", str(d)), nprocs=WORLD, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _oracle(causal):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import scaled_dot_product_attention

    q, k, v, do = (jnp.asarray(a) for a in _inputs(causal))
    o, vjp = jax.vjp(lambda q, k, v: scaled_dot_product_attention(q, k, v, causal=causal),
                     q, k, v)
    return [np.asarray(t) for t in (o, *vjp(do))]


@pytest.mark.parametrize("kind,causal", CASES, ids=[f"{k}-{'causal' if c else 'full'}"
                                                    for k, c in CASES])
def test_forward_and_gradients_match_jax_oracle(ranks, kind, causal):
    want = _oracle(causal)
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([r[f"{kind}.{causal}.{name}"] for r in ranks], axis=1)
        err = np.abs(got - want[i]).max() / np.abs(want[i]).max()
        assert err <= TOL, (name, err)


class _Mesh:
    """A two-rank sp axis seen from rank 0, for the errors raised before any
    collective."""

    shape = {"sp": 2}

    def size(self, axis):
        return 2

    def axis_index(self, axis):
        return 0

    def group(self, axis):
        return None


def test_divisibility_errors():
    from paddle_tpu_torch import parallel as par

    mesh = _Mesh()
    with pytest.raises(ValueError, match="T=7 not divisible by sp=2"):
        par.shard_sequence(torch.zeros(1, 7, 2, 4), mesh)
    with pytest.raises(ValueError, match="H=3 not divisible by sp=2"):
        par.ulysses_attention(*(torch.zeros(1, 4, 3, 4) for _ in range(3)), mesh)
    with pytest.raises(ValueError, match=r"expected \[B, T, H, D\]"):
        par.ring_attention(*(torch.zeros(4, 3, 4) for _ in range(3)), mesh)
    with pytest.raises(ValueError, match="differ"):
        par.ring_attention(torch.zeros(1, 4, 2, 4), torch.zeros(1, 2, 2, 4),
                           torch.zeros(1, 4, 2, 4), mesh)
    np.testing.assert_array_equal(
        par.shard_sequence(torch.arange(8.).reshape(1, 4, 1, 2), mesh).numpy().ravel(),
        [0, 1, 2, 3])
