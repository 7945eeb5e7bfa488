"""Programs and artifacts passing from the JAX package to the PyTorch port:
the `Program.to_dict` schema, parameters carried bit for bit, the
committed full-width NMT artifact, the sidecar the port refuses (`sharding`)
and the one it keeps unused (`draft_model`). A `quant` sidecar is no longer refused: the
port checks it at load (its program fingerprint and scales digest) and
raises QuantMetaError on a stale program or tampered scales
(tests/test_torch_quant.py).

Run as a script, this module rewrites the committed artifacts
paddle_tpu_torch/artifacts/nmt_beam_{wmt,small}/ from the JAX package:

    JAX_PLATFORMS=cpu python tests/test_torch_program_io.py
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
from test_torch_nmt_infer import build_nmt_beam, export_nmt_beam  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "paddle_tpu_torch", "artifacts")
WIDTHS = {
    # bench.py run_infer's NMT: vocab, emb = enc = dec hidden,
    # src_max_len, beam, max_len (bench.py:806-827)
    "nmt_beam_wmt": dict(vocab=30000, hidden=512, src_max_len=50, beam=4, max_len=32),
    # the same program narrowed, for chip_smoke.py's card-against-CPU check
    "nmt_beam_small": dict(vocab=1000, hidden=128, src_max_len=12, beam=4, max_len=32),
}


def export_program_meta(dirname, vocab, hidden, src_max_len, beam, max_len):
    """Write the NMT beam decoder's program.json and meta.json as
    paddle_tpu.io.save_inference_model would, without making or saving any
    weights: stand-ins that carry only shape and dtype bind the shared
    tables. meta.json leaves out the exporter's TPU tuning record."""
    pt.reset()
    scope = pt.global_scope()
    _, dprog, targets = build_nmt_beam(
        vocab, hidden, src_max_len, beam, max_len,
        scope_params=lambda n, shape: scope.set(
            n, np.broadcast_to(np.zeros((), np.float32), shape)))
    fetch_names = [v.name for v in targets]
    pruned = pt.io._prune_for_inference(dprog, ["src"], fetch_names)
    program = pruned.to_dict()
    meta = {
        "feed_names": ["src"],
        "fetch_names": fetch_names,
        "param_names": sorted(v.name for v in pruned.persistables()),
        "feed_specs": {"src": {"dtype": "int32", "shape": [-1]}},
        "program_fingerprint": pt.io.program_fingerprint(pruned),
    }
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "program.json"), "w") as f:
        json.dump(program, f, indent=1)
    with open(os.path.join(dirname, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return program, meta


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("nmt_small")
    pt.reset()
    export_nmt_beam(d, vocab=32, hidden=16, src_max_len=5, beam=2, max_len=3)
    return str(d)


def test_jax_program_loads_unchanged(small_artifact):
    with open(os.path.join(small_artifact, "program.json")) as f:
        saved = json.load(f)
    jprog, _, _ = pt.io.load_inference_model(small_artifact)
    prog, feeds, fetches = ptt.io.load_inference_model(
        small_artifact, scope=ptt.Scope(), device="cpu")
    assert prog.to_dict() == saved == jprog.to_dict()
    jops, tops = jprog.global_block().ops, prog.global_block().ops
    assert [o.type for o in tops] == [o.type for o in jops]
    assert [o.attrs for o in tops] == [o.attrs for o in jops]
    assert {n: v.shape for n, v in prog.global_block().vars.items()} == \
        {n: v.shape for n, v in jprog.global_block().vars.items()}
    assert feeds == ["src"] and len(fetches) == 3


def test_params_carry_bit_exact(small_artifact):
    pt.io.load_inference_model(small_artifact)
    names = json.load(open(os.path.join(small_artifact, "meta.json")))["param_names"]
    arrays = {n: np.asarray(pt.global_scope().get(n)) for n in names}
    scope = ptt.Scope()
    ptt.io.params_from_numpy(scope, arrays, "cpu")
    loaded = ptt.Scope()
    ptt.io.load_inference_model(small_artifact, scope=loaded, device="cpu")
    for n, a in arrays.items():
        for s in (scope, loaded):
            t = s.get(n)
            assert t.device.type == "cpu" and t.dtype == torch.float32
            assert t.numpy().tobytes() == a.tobytes(), n


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_committed_artifact_is_a_fresh_jax_export(tmp_path, name):
    widths = WIDTHS[name]
    program, meta = export_program_meta(tmp_path, **widths)
    with open(os.path.join(ARTIFACTS, name, "program.json")) as f:
        committed = json.load(f)
    with open(os.path.join(ARTIFACTS, name, "meta.json")) as f:
        committed_meta = json.load(f)
    assert committed == program
    assert committed_meta == meta
    ops = committed["blocks"][0]["ops"]
    assert [o["type"] for o in ops] == [
        "lookup_table", "mul", "dynamic_gru", "mul", "dynamic_gru",
        "sequence_concat", "sequence_first_step", "mul", "elementwise_add",
        "tanh", "attention_gru_beam_search"]
    beam = ops[-1]["attrs"]
    assert (beam["beam_size"], beam["max_len"], beam["src_max_len"]) == \
        (widths["beam"], widths["max_len"], widths["src_max_len"])
    V, Hd = widths["vocab"], widths["hidden"]
    shapes = {v["name"]: v["shape"] for v in committed["blocks"][0]["vars"]}
    assert shapes["s2s.trg_emb"] == [V, Hd] and shapes["s2s.enc_fwd_w"] == [Hd, 3 * Hd]
    # and the port reads it
    assert ptt.Program.from_dict(committed).to_dict() == committed


@pytest.mark.parametrize("sidecar", ["sharding", "draft_model"])
def test_unsupported_sidecar_raises(small_artifact, tmp_path, sidecar):
    """A sharding sidecar is refused at load. A draft-model sidecar loads and
    is kept (the serving scheduler drafts with it:
    tests/test_torch_spec_decode.py); a feed-forward artifact has no
    scheduler to draft for."""
    for f in ("program.json", "params.npz"):
        with open(os.path.join(small_artifact, f), "rb") as src, \
                open(os.path.join(tmp_path, f), "wb") as dst:
            dst.write(src.read())
    meta = json.load(open(os.path.join(small_artifact, "meta.json")))
    meta[sidecar] = {"dir": "x"}
    with open(os.path.join(tmp_path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if sidecar == "sharding":
        with pytest.raises(NotImplementedError, match=sidecar):
            ptt.io.load_inference_model(str(tmp_path), scope=ptt.Scope(), device="cpu")
        return
    program, _, _ = ptt.io.load_inference_model(str(tmp_path), scope=ptt.Scope(), device="cpu")
    assert program._draft_meta == {"dir": "x"}
    engine = ptt.serving.ServingEngine(str(tmp_path), device="cpu")
    assert engine.draft_meta == {"dir": "x"}
    with pytest.raises(ValueError, match="no beam_search_group op"):
        ptt.serving.ContinuousScheduler(engine, draft_model="x")


def test_missing_param_raises(small_artifact, tmp_path):
    for f in ("program.json", "params.npz"):
        with open(os.path.join(small_artifact, f), "rb") as src, \
                open(os.path.join(tmp_path, f), "wb") as dst:
            dst.write(src.read())
    meta = json.load(open(os.path.join(small_artifact, "meta.json")))
    meta["param_names"].append("no_such_param")
    with open(os.path.join(tmp_path, "meta.json"), "w") as f:
        json.dump(meta, f)
    scope = ptt.Scope()
    with pytest.raises(KeyError, match="no_such_param"):
        ptt.io.load_inference_model(str(tmp_path), scope=scope, device="cpu")
    assert not list(scope.keys())  # nothing half-loaded


def test_autodiff_op_raises_not_implemented():
    """autodiff runs (tests/test_torch_train.py); a parameter that takes
    SelectedRows gradients (an is_sparse table) may be read by lookup_table
    ops only, as in the JAX package: any other reader raises before the
    run."""
    prog = ptt.Program()
    blk = prog.global_block()
    blk.create_var("emb", (4, 2), persistable=True, is_parameter=True, sparse_update=True)
    blk.create_var("loss", ())
    blk.ops.append(ptt.core.program.Operator("mean", {"X": ["emb"]}, {"Out": ["loss"]}, {}))
    blk.ops.append(ptt.core.program.Operator("autodiff", {"Loss": ["loss"]}, {},
                                             {"params": ["emb"]}))
    scope = ptt.Scope()
    scope.set("emb", torch.zeros(4, 2))
    with pytest.raises(ValueError, match="SelectedRows gradients support lookup_table"):
        ptt.Executor(device="cpu").run(prog, {}, [], scope=scope)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, widths in WIDTHS.items():
        export_program_meta(os.path.join(ARTIFACTS, name), **widths)
        print(f"wrote {os.path.join(ARTIFACTS, name)}")
