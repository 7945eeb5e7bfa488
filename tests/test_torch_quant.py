"""Quantized serving in the port against the JAX package, on the CPU: the
int8 GEMM's plain version (what csrc/quant_matmul.cu computes), the
quantized ops, `clone(for_test)` and inference pruning, calibration,
conversion, the quant sidecar, and artifacts crossing between the two
packages in both directions. The models: the seeded MLP of
tests/test_quant.py (16 → 32 → 32 → 8) and bench.py's transformer LM cut
to dim 64, one head of D=64, 2 layers, T=16, vocab 128, with the sample
feeds of the JAX package's `quant` command (8 of them, seed 0, B=4, token
ids from randint(0, 8)).

Tolerances, each with its reading:

- The GEMM and the weight and activation scales: exact (integer sums;
  the same numpy expression).
- The ops, run eagerly in both packages: bit for bit, f32 and bf16.
- Calibration ranges (f32): within 1e-6 relative (measured equal).
- A whole program, which the JAX executor compiles (in bf16 with XLA's
  excess precision off, so that it rounds where its ops round): XLA
  rewrites `x / x_scale` with a constant x_scale into a multiply by its
  f32 reciprocal, one f32 ulp from the IEEE quotient in about a third of
  the elements, so a quotient within an ulp of a half may round to the
  other code. So at most 1e-3 of the activation codes may differ, and the
  last quantized op's output is held, f32, to one flipped code (x_scale ·
  max|w| of its weight), bf16 to at most 2% of its values beyond one ulp
  (test_torch_train's share). Measured: no code differs, and the outputs
  are the same bits in both dtypes, both models, both directions.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as pt  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import quant as jquant  # noqa: E402
from paddle_tpu.ops import quant_kernels as jqk  # noqa: E402
from paddle_tpu_torch.ops import quant_kernels as tqk  # noqa: E402
from test_torch_ops import _run  # noqa: E402
from test_torch_transformer import Cast  # noqa: E402

TFM = dict(dim=64, heads=1, layers=2, seqlen=16, vocab=128)
MLP = dict(in_dim=16, hidden=32, out_dim=8)
LR = 3e-4
BF16_SHARE = 0.02  # bf16 output values more than one ulp apart
CODE_SHARE = 1e-3  # activation codes that differ across the two packages


# ---------------------------------------------------------------- builders --
def build_tfm(pkg, train=False):
    """bench.py's transformer LM at the small width through `pkg`'s front
    end, names counted from 0; is_test unless `train` (then with Adam).
    Returns (main, startup, logits name)."""
    if pkg is pt:
        pt.reset()
        zoo = jmodels
    else:
        ptt.reset_default_programs()
        zoo = ptt.models
    main, startup = pkg.Program(), pkg.Program()
    T = TFM["seqlen"]
    with pkg.program_guard(main, startup):
        toks = pkg.layers.data("toks", shape=[T], dtype=np.int32)
        logits = zoo.transformer_lm(toks, vocab_size=TFM["vocab"], dim=TFM["dim"],
                                    num_heads=TFM["heads"], num_layers=TFM["layers"],
                                    max_len=T, is_test=not train)
        if train:
            labels = pkg.layers.data("labels", shape=[T, 1], dtype=np.int32)
            loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, labels))
            pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, logits.name


def build_mlp(pkg):
    """tests/test_quant.py's MLP: fc 16→32 relu, 32→32 relu, 32→8."""
    if pkg is pt:
        pt.reset()
    else:
        ptt.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[MLP["in_dim"]])
        h1 = pkg.layers.fc(x, size=MLP["hidden"], act="relu", name="tq_fc1")
        h2 = pkg.layers.fc(h1, size=MLP["hidden"], act="relu", name="tq_fc2")
        pred = pkg.layers.fc(h2, size=MLP["out_dim"], name="tq_fc3")
    return main, startup, pred.name


BUILDERS = {"tfm": lambda pkg: build_tfm(pkg), "mlp": build_mlp}
FEED = {"tfm": "toks", "mlp": "x"}


def samples(model, n=8, seed=0):
    """The JAX `quant` command's synthetic feeds (cli._synthetic_samples):
    B=4, ints from randint(0, 8), floats standard normal."""
    rng = np.random.RandomState(seed)
    if model == "tfm":
        return [{"toks": rng.randint(0, 8, size=(4, TFM["seqlen"])).astype(np.int32)}
                for _ in range(n)]
    return [{"x": rng.standard_normal((4, MLP["in_dim"])).astype(np.float32)}
            for _ in range(n)]


def eval_feed(model):
    rng = np.random.RandomState(99)
    if model == "tfm":
        return {"toks": rng.randint(0, TFM["vocab"], size=(4, TFM["seqlen"])).astype(np.int32)}
    return {"x": rng.standard_normal((4, MLP["in_dim"])).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """For each model: the JAX package's fp artifact (its own startup), its
    calibration on the sample feeds, and its converted artifact."""
    out = {}
    for model, build in BUILDERS.items():
        root = tmp_path_factory.mktemp(model)
        main, startup, target = build(pt)
        startup.random_seed = 5
        scope, exe = pt.Scope(), pt.Executor()
        exe.run(startup, scope=scope)
        fp_dir, q_dir = str(root / "fp"), str(root / "int8")
        pt.io.save_inference_model(fp_dir, [FEED[model]], [target], main_program=main,
                                   scope=scope)
        qscope = pt.Scope()
        prog, feeds, fetches = pt.io.load_inference_model(fp_dir, scope=qscope)
        calib = jquant.calibrate(prog, samples(model), scope=qscope, exe=exe)
        report = jquant.convert(prog, scope=qscope, calib=calib, exe=exe)
        pt.io.save_inference_model(q_dir, feeds, fetches, main_program=prog, scope=qscope)
        out[model] = dict(fp=fp_dir, q=q_dir, calib=calib, report=report, prog=prog,
                          scope=qscope)
    return out


def _port_convert(fp_dir, calib_ranges=None, model="mlp"):
    """The port's load → calibrate (unless given ranges) → convert."""
    scope = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(fp_dir, scope=scope, device="cpu")
    calib = ptt.quant.calibrate(prog, samples(model), scope=scope, device="cpu") \
        if calib_ranges is None else ptt.quant.CalibrationResult(calib_ranges, 8)
    report = ptt.quant.convert(prog, scope=scope, calib=calib, device="cpu")
    return prog, feeds, fetches, scope, report


def _flip_bound(prog, scope_get, fetch):
    """x_scale · max|w| of the quantized op that writes `fetch`: what one
    flipped activation code can move an output by."""
    op = next(o for o in prog.global_block().ops if o.outputs.get("Out") == [fetch])
    w = np.asarray(scope_get(op.inputs["Y"][0]), np.float32)
    s = np.asarray(scope_get(op.inputs["Scale"][0]), np.float32)
    return op.attrs["x_scale"] * float(np.max(np.abs(w) * s))


# ------------------------------------------------------------------ GEMM ---
def _int8(rng, *shape):
    a = rng.randint(-128, 128, size=shape).astype(np.int8)
    a.reshape(-1)[:2] = (-128, 127)  # the range's ends
    return a


@pytest.mark.parametrize("route,shape", [
    ("pallas", (64, 128, 256)),  # legal for the JAX package's (32, 128) int8 tile
    ("ref", (5, 40, 24)),        # shapes its tile model refuses
    ("ref", (130, 70, 130)),
    ("ref", (3, 4096, 5)),
], ids=["pallas-64x128x256", "ref-5x40x24", "ref-130x70x130", "ref-3x4096x5"])
def test_plain_gemm_matches_jax(route, shape):
    """quant_matmul's CPU route (quant_matmul_plain) against the JAX
    package's Pallas kernel in interpret mode or its reference, exact,
    over the whole int8 range; a row and a column all -128 reach the
    largest sum."""
    M, K, N = shape
    rng = np.random.RandomState(M + K + N)
    x, w = _int8(rng, M, K), _int8(rng, K, N)
    x[-1], w[:, -1] = -128, -128
    if route == "pallas":
        want = jqk._quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w), 32, 128)
    else:
        want = jqk._quant_matmul_ref(jnp.asarray(x), jnp.asarray(w))
    got = tqk.quant_matmul(torch.as_tensor(x), torch.as_tensor(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[-1, -1]) == K * 128 * 128


def test_gemm_wrapper_refuses_what_the_kernel_does_not_take():
    """Raised before any launch: a non-int8 input, a K that does not match,
    a non-contiguous input, a K past the int32 sum's limit, a device
    other than the CPU's plain route or the card."""
    x, w = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tqk.quant_matmul(x.float(), w)
    with pytest.raises(ValueError, match="wq is"):
        tqk.quant_matmul(x, torch.zeros(7, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        tqk.quant_matmul(x, torch.zeros(3, 8, dtype=torch.int8).t())
    big = tqk.QMM_MAX_K + 1
    with pytest.raises(ValueError, match="overflow"):
        tqk.quant_matmul(torch.zeros(1, big, dtype=torch.int8),
                         torch.zeros(big, 1, dtype=torch.int8))
    with pytest.raises(ValueError, match="unsupported device"):
        tqk.quant_matmul(x.to("meta"), w.to("meta"))
    assert tqk.quant_matmul_launches == 0


# ---------------------------------------------- the wgmma route's layout ---
# the int8 request's sites (M = 8·1024; dim 2048, FFN 8192, vocab 32000)
# and the MLP's (M = 8); chip_smoke.py's edge shapes of the wgmma route
_REQUEST_SITES = [(8192, 2048, 2048), (8192, 2048, 8192), (8192, 8192, 2048),
                  (8192, 2048, 32000), (8, 512, 1024), (8, 1024, 1024), (8, 1024, 128)]
_EDGES = [(m, k, n) for m in (1, 8, 17, 64, 65, 127, 8193) for k in (32, 48, 8192)
          for n in (24, 256, 1000)]


def test_kernel_route_takes_the_request_sites_and_edges_to_wgmma():
    """kernel_route sends the int8 request's and the MLP's sites and every
    edge shape (each with K % 16 == 0 and N % 4 == 0) to the wgmma kernel;
    an unaligned activation base to the mma.sync kernel."""
    for shape in _REQUEST_SITES + _EDGES:
        assert tqk.kernel_route(*shape) == tqk.WGMMA, shape
        assert tqk.kernel_route(*shape, aligned=False) == tqk.MMA_SYNC, shape


@pytest.mark.parametrize("shape,route", [
    ((8193, 40, 1000), tqk.MMA_SYNC),  # K % 16: a map's row stride must be 16 bytes' multiple
    ((17, 8, 24), tqk.MMA_SYNC),       # K below one 16-byte row
    ((17, 0, 24), tqk.MMA_SYNC),
    ((17, 64, 1001), tqk.MMA_SYNC),    # N % 4: the int32 output's row stride
    ((1, 16, 4), tqk.WGMMA),           # the least shape a tensor map describes
    ((3, 4096, 5), tqk.MMA_SYNC),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_kernel_route_is_a_pure_function_of_the_shape(shape, route):
    """The route's boundaries: K % 16 == 0 and N % 4 == 0 take the wgmma
    kernel; an unaligned activation base never does."""
    assert tqk.kernel_route(*shape) == route
    assert tqk.kernel_route(*shape, aligned=False) == tqk.MMA_SYNC


def test_kmajor_copy_is_made_once_per_weight_and_again_after_a_write():
    """The wgmma route's [N, K] copy of a [K, N] weight: made once while the
    weight's storage lives and is not written; made again after an in-place
    write (its _version moves) and for a replacing weight; a view or a
    detached re-wrap of the same storage shares it; a freed weight's copy
    goes when the next is made; the CPU route copies nothing."""
    rng = np.random.RandomState(7)
    w = torch.as_tensor(_int8(rng, 40, 24))
    before = tqk.kmajor_copies
    c1 = tqk.kmajor_weight(w)
    assert torch.equal(c1, w.t()) and c1.is_contiguous() and tqk.kmajor_copies == before + 1
    assert tqk.kmajor_weight(w) is c1 and tqk.kmajor_weight(w.view(40, 24)) is c1
    assert tqk.kmajor_copies == before + 1
    w[0, 0] = 5  # written in place
    c2 = tqk.kmajor_weight(w)
    assert c2 is not c1 and int(c2[0, 0]) == 5 and tqk.kmajor_copies == before + 2
    w = w.detach()  # the executor re-wraps a persistable after a run: same storage
    assert tqk.kmajor_weight(w) is c2 and tqk.kmajor_copies == before + 2
    w2 = torch.as_tensor(_int8(rng, 40, 24))  # a replacing payload
    assert torch.equal(tqk.kmajor_weight(w2), w2.t()) and tqk.kmajor_copies == before + 3
    n = len(tqk._KMAJOR)
    del w2  # the next copy drops what only the cache would keep
    tqk.kmajor_weight(torch.as_tensor(_int8(rng, 24, 40)))
    assert len(tqk._KMAJOR) == n and tqk.kmajor_copies == before + 4
    x = torch.as_tensor(_int8(rng, 5, 40))
    tqk.quant_matmul(x, w)
    assert tqk.kmajor_copies == before + 4


# the wgmma kernel's walk (tc:: in csrc/quant_matmul.cu): output tiles of
# _TM x _TN, K in stages of _STAGE_K bytes taken _K_STEP at a time, tiles
# walked in groups of _GROUP_M row panels
_TM, _TN, _STAGE_K, _K_STEP, _GROUP_M = 128, 256, 128, 32, 8


def _tile_walk(M, N, n_ctas):
    """For each of n_ctas CTAs, the (m0, n0) origins of the output tiles it
    takes in order (tile i of the walk to CTA i mod n_ctas), the tiles
    grouped by _GROUP_M row panels with the row panel fastest within a
    group: tc::tile_origin's indexing."""
    tm, tn = -(-M // _TM), -(-N // _TN)
    walks = [[] for _ in range(n_ctas)]
    for tile in range(tm * tn):
        grp, inner = divmod(tile, _GROUP_M * tn)
        first = grp * _GROUP_M
        rows = min(_GROUP_M, tm - first)
        walks[tile % n_ctas].append(((first + inner % rows) * _TM, (inner // rows) * _TN))
    return walks


def _wgmma_walk(x, w, n_ctas):
    """The wgmma kernel's function as it computes it, in int64: each CTA's
    tiles in _tile_walk's order; per tile, K in stages of _STAGE_K bytes
    taken _K_STEP at a time from the K-major copy, each step's product
    added to the tile's sums; rows, columns and K past the edges read as
    zeros (TMA's fill), and only the tile's part inside [M, N] written."""
    M, K = x.shape
    N = w.shape[1]
    tm, tn = _TM, _TN
    Kp = -(-K // _STAGE_K) * _STAGE_K
    xa = np.zeros((-(-M // tm) * tm, Kp), np.int64)
    xa[:M, :K] = x
    wt = np.zeros((-(-N // tn) * tn, Kp), np.int64)
    wt[:N, :K] = tqk.kmajor_weight(torch.as_tensor(w)).numpy()
    out = np.full((M, N), -1, np.int64)
    seen = set()
    for walk in _tile_walk(M, N, n_ctas):
        for m0, n0 in walk:
            assert (m0, n0) not in seen
            seen.add((m0, n0))
            acc = np.zeros((tm, tn), np.int64)
            for k0 in range(0, Kp, _STAGE_K):
                for kk in range(k0, k0 + _STAGE_K, _K_STEP):
                    acc += xa[m0:m0 + tm, kk:kk + _K_STEP] @ \
                        wt[n0:n0 + tn, kk:kk + _K_STEP].T
            out[m0:m0 + tm, n0:n0 + tn] = acc[:M - m0, :N - n0]
    assert len(seen) == -(-M // tm) * -(-N // tn)
    return out


@pytest.mark.parametrize("shape,n_ctas", [
    ((256, 160, 512), 3),     # legal for the JAX kernel's (32, 128) tile: held to it too
    ((300, 80, 520), 132),    # ragged M and N, K within one stage
    ((17, 272, 24), 2),       # M below one tile, K over three stages, N below one tile
    ((1100, 48, 1000), 5),    # more than one group of 8 row panels
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_wgmma_walk_matches_plain_and_jax(shape, n_ctas):
    """The wgmma route's tiled walk, emulated exactly in int64, against
    quant_matmul_plain and the JAX package's Pallas kernel (interpret
    mode) or its reference, over the whole int8 range; every output tile
    is taken once across the CTAs."""
    M, K, N = shape
    rng = np.random.RandomState(M + K + N + n_ctas)
    x, w = _int8(rng, M, K), _int8(rng, K, N)
    x[-1], w[:, -1] = -128, -128
    got = _wgmma_walk(x, w, n_ctas)
    plain = tqk.quant_matmul_plain(torch.as_tensor(x), torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, plain)
    if M % 32 == 0 and N % 128 == 0:
        want = jqk._quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w), 32, 128)
    else:
        want = jqk._quant_matmul_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[-1, -1] == K * 128 * 128


def test_wgmma_walk_orders_row_panels_fastest_in_groups():
    """The walk: tiles i, i+1 of one group share a column panel and take
    consecutive row panels (so the tiles in flight share B's panel and
    the group's A panels in L2); the last group holds the remaining rows."""
    tm, tn = _TM, _TN
    M, N = 10 * tm, 3 * tn  # one group of 8 row panels, then one of 2
    order = _tile_walk(M, N, 1)[0]
    assert order[:9] == [(r * tm, 0) for r in range(8)] + [(0, tn)]
    assert order[24:] == [(8 * tm, 0), (9 * tm, 0), (8 * tm, tn), (9 * tm, tn), (8 * tm, 2 * tn),
                          (9 * tm, 2 * tn)]
    spread = _tile_walk(M, N, 4)
    assert [len(w) for w in spread] == [8, 8, 7, 7] and spread[1][0] == (tm, 0)


def test_weight_and_activation_scales_match_jax():
    """quantize_weight (a zero column among them) and act_scale: the JAX
    package's bits."""
    rng = np.random.RandomState(3)
    w = (rng.standard_normal((48, 20)) * np.logspace(-3, 1, 20)).astype(np.float32)
    w[:, 7] = 0.0
    (jq, js), (tq, ts) = jqk.quantize_weight(w), tqk.quantize_weight(w)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()
    for a in (0.0, 1e-30, 0.37, 3.0, 1e4):
        assert tqk.act_scale(a) == jqk.act_scale(a)


# ------------------------------------------------------------------- ops ---
def _quant_inputs(rng, x_shape, K, N, dtype):
    x = (rng.standard_normal(x_shape) * 2).astype(np.float32)
    wq, scale = tqk.quantize_weight(rng.standard_normal((K, N)).astype(np.float32))
    x_scale = tqk.act_scale(float(np.abs(x).max()) * 0.8)  # some codes clip
    return {"X": [(x, dtype)], "Y": [(wq, torch.int8)], "Scale": [(scale, torch.float32)]}, \
        x_scale


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["mul-2d", "mul-3d", "matmul"])
def test_quantized_ops_match_jax(case, amp):
    """quantized_mul on [M, K] and on the transformer's [B, T, D] with
    x_num_col_dims=2, and quantized_matmul, run eagerly in both packages:
    bit for bit, in the amp dtype (bf16 activations in, bf16 out)."""
    rng = np.random.RandomState(11)
    x_shape = {"mul-2d": (9, 40), "mul-3d": (2, 5, 40), "matmul": (9, 40)}[case]
    dtype = torch.bfloat16 if amp else torch.float32
    inputs, x_scale = _quant_inputs(rng, x_shape, 40, 24, dtype)
    attrs = {"x_scale": x_scale, "quant_mode": "int8"}
    if case == "mul-3d":
        attrs["x_num_col_dims"] = 2
    op = "quantized_matmul" if case == "matmul" else "quantized_mul"
    j, t = _run(op, {k: [Cast(*v) for v in vals] for k, vals in inputs.items()}, attrs, amp)
    assert t.dtype == dtype and tuple(t.shape) == x_shape[:-1] + (24,)
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("tx,ty", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["NN", "TN", "NT", "TT"])
def test_matmul_op_matches_jax(tx, ty, amp):
    """The `matmul` op with each transpose flag, f32 within 1e-5 of the
    output's largest element (another summation order), bf16 within one
    ulp."""
    rng = np.random.RandomState(12)
    x = rng.standard_normal((3, 6, 5) if tx else (3, 5, 6)).astype(np.float32)
    y = rng.standard_normal((7, 6) if ty else (6, 7)).astype(np.float32)
    j, t = _run("matmul", {"X": [x], "Y": [y]}, {"transpose_X": tx, "transpose_Y": ty}, amp)
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    assert tuple(t.shape) == (3, 5, 7)
    want = np.asarray(j, np.float32)
    tol = 1e-5 if amp is None else 2 ** -7
    assert np.abs(t.float().numpy() - want).max() <= tol * np.abs(want).max()


# -------------------------------------------------------- programs, prune --
@pytest.mark.parametrize("model", ["tfm", "mlp", "train"])
def test_clone_and_prune_match_jax(model):
    """clone(for_test=True) and _prune_for_inference give the JAX package's
    dict: the small transformer, the MLP, and the transformer's training
    program with its backward and Adam ops dropped."""
    build = (lambda pkg: build_tfm(pkg, train=True)) if model == "train" else BUILDERS[model]
    feed = FEED.get(model, "toks")
    jmain, _, jt = build(pt)
    tmain, _, tt = build(ptt)
    assert tt == jt
    clone = tmain.clone(for_test=True)
    assert clone.version == tmain.version + 1
    assert clone.to_dict() == jmain.clone(for_test=True).to_dict()
    jp = pt.io._prune_for_inference(jmain, [feed], [jt])
    tp = ptt.io._prune_for_inference(tmain, [feed], [tt])
    assert tp.to_dict() == jp.to_dict()
    assert ptt.io.program_fingerprint(tp) == pt.io.program_fingerprint(jp)
    types = [o.type for o in tp.global_block().ops]
    assert "autodiff" not in types and "adam" not in types
    with pytest.raises(ValueError, match="not inputs"):
        ptt.io._prune_for_inference(tmain, [feed, "nowhere"], [tt])


# ------------------------------------------------------ calibrate, convert --
@pytest.mark.parametrize("model", ["mlp", "tfm"])
def test_calibrate_matches_jax(jax_side, model):
    """The port's ranges on the JAX package's fp artifact within 1e-6
    relative of the JAX package's (f32); the same ranges twice."""
    runs = []
    for _ in range(2):
        scope = ptt.Scope()
        prog, _, _ = ptt.io.load_inference_model(jax_side[model]["fp"], scope=scope,
                                                 device="cpu")
        runs.append(ptt.quant.calibrate(prog, samples(model), scope=scope, device="cpu"))
    want = jax_side[model]["calib"]
    assert runs[0].act_ranges == runs[1].act_ranges
    assert runs[0].sample_count == want.sample_count == 8
    assert sorted(runs[0].act_ranges) == sorted(want.act_ranges)
    for n, v in want.act_ranges.items():
        assert abs(runs[0].act_ranges[n] - v) <= 1e-6 * v, n


@pytest.mark.parametrize("model", ["mlp", "tfm"])
def test_convert_matches_jax(jax_side, model, tmp_path):
    """Fed the JAX package's calibration, the port's convert gives its
    program dict, int8 payloads and scales bit for bit, and its sidecar
    (fingerprint and digest included) once saved."""
    js = jax_side[model]
    prog, feeds, fetches, scope, report = _port_convert(js["fp"], js["calib"].act_ranges,
                                                        model)
    assert prog.to_dict() == js["prog"].to_dict()
    assert report.meta() == js["report"].meta()
    assert report.summary() == js["report"].summary()
    n_sites = 3 if model == "mlp" else 6 * TFM["layers"] + 1
    assert len(report.quantized) == n_sites and not report.skipped
    for site in report.quantized:
        for n in (site["w"], site["w"] + ptt.quant.SCALE_SUFFIX):
            t, j = scope.get(n), np.asarray(js["scope"].get(n))
            assert t.numpy().dtype == j.dtype and t.numpy().tobytes() == j.tobytes(), n
    ptt.io.save_inference_model(str(tmp_path), feeds, fetches, main_program=prog, scope=scope)
    with open(os.path.join(tmp_path, "meta.json")) as f:
        mine = json.load(f)
    with open(os.path.join(js["q"], "meta.json")) as f:
        theirs = json.load(f)
    assert mine["quant"] == theirs["quant"]
    assert {k: v for k, v in mine.items() if k != "quant"} == \
        {k: v for k, v in theirs.items() if k not in ("quant", "tuning")}
    assert ptt.quant.stats()["sites_quantized"] >= n_sites


def _jax_run(prog, feed, fetch, scope, amp):
    """The JAX executor's run; in bf16 compiled with XLA's excess precision
    off, so that it rounds where its ops round one by one, as the port
    does (tests/test_torch_frontend.py)."""
    jit = jax.jit
    try:
        if amp:
            jax.jit = functools.partial(jit, compiler_options={"xla_allow_excess_precision": False})
        return pt.Executor().run(prog, feed, fetch, scope=scope)
    finally:
        jax.jit = jit


def _cross_check(tprog, tscope, jprog, jscope, feed, amp):
    """The two packages on one feed: the share of activation codes that
    differ at the quantized ops, and the last quantized op's output within
    one flipped code (f32) or BF16_SHARE beyond one ulp (bf16)."""
    tprog.set_amp(amp)
    jprog.set_amp(amp)
    qops = [o for o in tprog.global_block().ops if o.type.startswith("quantized_")]
    fetch = [o.inputs["X"][0] for o in qops] + [qops[-1].outputs["Out"][0]]
    tout = ptt.Executor(device="cpu").run(tprog, feed, fetch, scope=tscope)
    jout = _jax_run(jprog, feed, fetch, jscope, amp)
    differ = [(tqk._quantize_act(torch.as_tensor(np.array(t, np.float32)), o.attrs["x_scale"])
               != tqk._quantize_act(torch.as_tensor(np.array(j, np.float32)),
                                    o.attrs["x_scale"])).numpy().ravel()
              for o, t, j in zip(qops, tout, jout)]
    share = float(np.mean(np.concatenate(differ)))
    assert share <= CODE_SHARE, share
    t, j = np.asarray(tout[-1], np.float32), np.asarray(jout[-1], np.float32)
    if amp is None:
        bound = _flip_bound(tprog, lambda n: tscope.get(n).numpy(), fetch[-1])
        assert np.abs(t - j).max() <= bound, (np.abs(t - j).max(), bound)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(j), 2.0 ** -126))) - 7)
        assert np.mean(np.abs(t - j) > ulp) <= BF16_SHARE


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("model", ["mlp", "tfm"])
def test_jax_artifact_serves_in_port(jax_side, model, amp):
    """The JAX package's quantized artifact loads in the port (its sidecar
    checked) and serves the JAX package's outputs (module docstring)."""
    js = jax_side[model]
    tscope, jscope = ptt.Scope(), pt.Scope()
    tprog, _, _ = ptt.io.load_inference_model(js["q"], scope=tscope, device="cpu")
    with open(os.path.join(js["q"], "meta.json")) as f:
        assert tprog._quant_meta == json.load(f)["quant"]
    jprog, _, _ = pt.io.load_inference_model(js["q"], scope=jscope)
    _cross_check(tprog, tscope, jprog, jscope, eval_feed(model), amp)


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("model", ["mlp", "tfm"])
def test_port_artifact_loads_in_jax(jax_side, model, amp, tmp_path):
    """The port's own load → calibrate → convert → save gives an artifact
    that the JAX package loads (its sidecar check passes) and serves as the
    port does (module docstring)."""
    prog, feeds, fetches, scope, _ = _port_convert(jax_side[model]["fp"], model=model)
    ptt.io.save_inference_model(str(tmp_path), feeds, fetches, main_program=prog, scope=scope)
    jscope = pt.Scope()
    jprog, jfeeds, jfetches = pt.io.load_inference_model(str(tmp_path), scope=jscope)
    assert (jfeeds, jfetches) == (feeds, fetches)
    assert jprog._quant_meta["sites"] == len([o for o in prog.global_block().ops
                                              if o.type == "quantized_mul"])
    _cross_check(prog, scope, jprog, jscope, eval_feed(model), amp)


# ------------------------------------------------------ the sidecar check --
def _saved_quantized(fp_dir, out_dir):
    prog, feeds, fetches, scope, report = _port_convert(fp_dir)
    ptt.io.save_inference_model(out_dir, feeds, fetches, main_program=prog, scope=scope)
    return report


def test_stale_program_raises(jax_side, tmp_path):
    """program.json edited after export (an x_scale retuned by hand): the
    fingerprint no longer matches, QuantMetaError at load, the scope left
    untouched (tests/test_quant.py:229)."""
    d = str(tmp_path)
    _saved_quantized(jax_side["mlp"]["fp"], d)
    p = os.path.join(d, "program.json")
    with open(p) as f:
        prog = json.load(f)
    op = next(o for o in prog["blocks"][0]["ops"] if o["type"] == "quantized_mul")
    op["attrs"]["x_scale"] *= 2.0
    with open(p, "w") as f:
        json.dump(prog, f)
    scope = ptt.Scope()
    with pytest.raises(ptt.io.QuantMetaError, match="stale"):
        ptt.io.load_inference_model(d, scope=scope, device="cpu")
    assert not list(scope.keys())


def test_tampered_scales_raise(jax_side, tmp_path):
    """A scale var replaced after export: the scales digest no longer
    matches, QuantMetaError naming it (tests/test_quant.py:249)."""
    d = str(tmp_path)
    report = _saved_quantized(jax_side["mlp"]["fp"], d)
    p = os.path.join(d, "params.npz")
    payload = dict(np.load(p))
    sname = report.quantized[0]["w"] + ptt.quant.SCALE_SUFFIX
    payload[sname] = payload[sname] * 1.5
    np.savez(p, **payload)
    with pytest.raises(ptt.io.QuantMetaError, match="digest"):
        ptt.io.load_inference_model(d, scope=ptt.Scope(), device="cpu")


@pytest.mark.parametrize("case", ["no-samples", "nothing-quantizable", "unknown-mode"])
def test_refusals(jax_side, case):
    """ValueError for calibrating on no samples, a program with nothing to
    quantize, and a mode other than int8 (tests/test_quant.py:119,206,218)."""
    if case == "nothing-quantizable":
        ptt.reset_default_programs()
        prog = ptt.Program()
        with ptt.program_guard(prog, ptt.Program()):
            ptt.layers.relu(ptt.layers.data("x", shape=[4]))
        with pytest.raises(ValueError, match="no quantizable matmul"):
            ptt.quant.convert(prog, scope=ptt.Scope(),
                              calib=ptt.quant.CalibrationResult({}, 1), device="cpu")
        return
    scope = ptt.Scope()
    prog, _, _ = ptt.io.load_inference_model(jax_side["mlp"]["fp"], scope=scope, device="cpu")
    if case == "no-samples":
        with pytest.raises(ValueError, match="at least one sample"):
            ptt.quant.calibrate(prog, [], scope=scope, device="cpu")
    else:
        calib = ptt.quant.calibrate(prog, samples("mlp", 1), scope=scope, device="cpu")
        with pytest.raises(ValueError, match="unsupported quant mode"):
            ptt.quant.convert(prog, scope=scope, calib=calib, mode="int4", device="cpu")


def test_save_and_load_vars_round_trip(tmp_path):
    """save_params / load_params and save_persistables / load_persistables:
    values back bit for bit (an int8 payload among them), atomically
    written, a missing name raising before the scope changes."""
    prog, startup, _ = build_mlp(ptt)
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=3)
    scope.set("q@int8", torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16))
    d = str(tmp_path)
    ptt.io.save_params(d, prog, scope)
    back = ptt.Scope()
    names = ptt.io.load_params(d, prog, back, device="cpu")
    assert sorted(names) == sorted(p.name for p in prog.parameters())
    for n in names:
        assert torch.equal(back.get(n), scope.get(n))
    ptt.io.save_vars(d, ["q@int8"], scope, filename="q.npz")
    ptt.io.load_vars(d, back, filename="q.npz", device="cpu")
    assert back.get("q@int8").dtype == torch.int8 and torch.equal(back.get("q@int8"),
                                                                   scope.get("q@int8"))
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    with pytest.raises(KeyError, match="nowhere"):
        ptt.io.load_vars(d, ptt.Scope(), var_names=["nowhere"], device="cpu")
    with pytest.raises(ValueError, match="not in the scope"):
        ptt.io.save_params(d, prog, ptt.Scope())
