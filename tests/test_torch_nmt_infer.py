"""The inference slice end to end: an NMT beam-search artifact saved by
the JAX package, answered by the JAX package and by the PyTorch port on
the same ragged feed.

Ids and lengths must be identical and scores within 1e-4 (f32; the two
frameworks sum matrix products in different orders). The JAX side runs
the encoder GRUs both through the Pallas kernel in interpret mode and
through its lax.scan; the port runs its plain GRU on the CPU.

Under bf16 amp the port is held to the Pallas GRU's rounding, which the
JAX package runs at the card's widths. A bf16 sum that lands near a
rounding boundary may round one ulp apart when the frameworks sum in
another order, so values are held to 4e-3 (one bf16 ulp just below 1)
and a share of elements that differ. The sound port reads at most 9.8e-4
with 0.63% of the encoder state and 3.9% of the decoder's initial state
differing; a GRU that rounds at other places (the JAX package's own
bf16 scan) reads 2.2e-3 to 3.9e-3 with 26-43% and 53-55% differing, as
`test_amp_bf16_bounds_reject_the_scan_rounding` holds.
Scores are bf16 sums near -23, where one ulp is 0.125: they are held to
two ulps. Ids are not compared: at bf16 resolution beams tie, and a tie
may break either way (here up to 12 of the 32 beams differ). Over
longer decodes the beams drift further apart in both frameworks, which
chip_smoke.py's bf16 phase allows for."""

import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import models
from paddle_tpu.core.lod import LoDArray as JaxLoD
from paddle_tpu.flags import FLAGS

V, H, S, K, T, B = 64, 128, 9, 4, 6, 8


def build_nmt_beam(vocab, hidden, src_max_len, beam, max_len, scope_params=None):
    """Build the book NMT model as bench.py run_infer does: the train
    program (whose startup makes the shared weights), then the beam
    decoder. The decoder binds the target embedding and output projection
    by name from the global scope, so they must be there first: run the
    startup (`scope_params=None`), or have `scope_params(name, shape)` put
    a stand-in there. Returns (startup, decode program, targets)."""
    prog, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(prog, startup):
        src = pt.layers.data("src", shape=[-1], dtype=np.int32, lod_level=1,
                             append_batch_size=False)
        trg_in = pt.layers.data("trg_in", shape=[-1], dtype=np.int32,
                                lod_level=1, append_batch_size=False)
        models.seq2seq_attention(
            src, trg_in, src_vocab=vocab, trg_vocab=vocab, emb_dim=hidden,
            enc_hidden=hidden, dec_hidden=hidden, src_max_len=src_max_len,
            trg_max_len=src_max_len)
    if scope_params is None:
        pt.Executor().run(startup)
    else:
        for v in prog.parameters():
            scope_params(v.name, tuple(v.shape))
    dprog, dstartup = pt.Program(), pt.Program()
    with pt.program_guard(dprog, dstartup):
        src2 = pt.layers.data("src", shape=[-1], dtype=np.int32, lod_level=1,
                              append_batch_size=False)
        ids, scores, lengths = models.seq2seq_beam_decode(
            src2, src_vocab=vocab, trg_vocab=vocab, emb_dim=hidden,
            enc_hidden=hidden, dec_hidden=hidden, src_max_len=src_max_len,
            beam_size=beam, max_len=max_len)
    return startup, dprog, [ids, scores, lengths]


def export_nmt_beam(dirname, vocab, hidden, src_max_len, beam, max_len):
    """Build the NMT beam decoder with seeded weights and save it as an
    inference artifact."""
    _, dprog, targets = build_nmt_beam(vocab, hidden, src_max_len, beam, max_len)
    pt.io.save_inference_model(str(dirname), ["src"], targets, main_program=dprog)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("nmt_beam")
    pt.reset()
    export_nmt_beam(d, V, H, S, K, T)
    return str(d)


@pytest.fixture(scope="module")
def seeded_artifact(artifact, tmp_path_factory):
    """The same program with weights normal/sqrt(fan_in) from a seed, as
    chip_smoke.py makes them. The startup's small uniform weights give
    near-uniform next-token distributions, whose bf16 scores all tie."""
    d = tmp_path_factory.mktemp("nmt_beam_seeded")
    for f in ("program.json", "meta.json"):
        shutil.copy(os.path.join(artifact, f), d)
    with np.load(os.path.join(artifact, "params.npz")) as z:
        shapes = {k: z[k].shape for k in sorted(z.files)}
    rng = np.random.RandomState(0)
    np.savez(os.path.join(d, "params.npz"),
             **{k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
                for k, s in shapes.items()})
    return str(d)


def _seqs(seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, S + 1, size=B)
    lens[0] = S  # one full-length sentence, the rest ragged
    return [rng.randint(2, V, size=(n,)).astype(np.int32) for n in lens]


def _decoder_inputs(prog):
    """Names of the encoder state and the decoder's initial state."""
    beam = prog.global_block().ops[-1]
    return [beam.inputs["EncState"][0], beam.inputs["H0"][0]]


def _run_jax(d, seqs, amp=None, extra=False):
    iprog, feeds, fetches = pt.io.load_inference_model(d)
    iprog.set_amp(amp)
    feed = {feeds[0]: JaxLoD.from_sequences(seqs, capacity=B * S, max_seqs=B)}
    names = (_decoder_inputs(iprog) if extra else []) + list(fetches)
    return pt.Executor().run(iprog, feed=feed, fetch_list=names)


def _run_port(d, seqs, amp=None, extra=False):
    scope = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(d, scope=scope, device="cpu")
    prog.set_amp(amp)
    feed = {feeds[0]: ptt.LoDArray.from_sequences(seqs, capacity=B * S, max_seqs=B)}
    names = (_decoder_inputs(prog) if extra else []) + list(fetches)
    return ptt.Executor(device="cpu").run(prog, feed, names, scope=scope)


@pytest.mark.parametrize("interpret", [True, False], ids=["pallas_interpret", "scan"])
@pytest.mark.parametrize("seed", [0, 1])
def test_nmt_beam_port_matches_jax(artifact, interpret, seed, monkeypatch):
    monkeypatch.setattr(FLAGS, "fused_rnn_interpret", interpret)
    seqs = _seqs(seed)
    j_ids, j_sc, j_len = _run_jax(artifact, seqs)
    p_ids, p_sc, p_len = _run_port(artifact, seqs)
    assert p_ids.shape == (B, K, T) and p_ids.dtype == np.int32
    assert p_sc.shape == (B, K) and p_len.shape == (B, K)
    np.testing.assert_array_equal(p_ids, np.asarray(j_ids))
    np.testing.assert_array_equal(p_len, np.asarray(j_len))
    np.testing.assert_allclose(p_sc, np.asarray(j_sc), rtol=0, atol=1e-4)
    assert np.all(np.diff(p_sc, axis=1) <= 0)  # best first


def test_port_gru_path_choice_does_not_change_the_answer(artifact, monkeypatch):
    """The port's two GRU routes (plain kernel twin and gru_scan) agree."""
    seqs = _seqs(2)
    fused = _run_port(artifact, seqs)
    monkeypatch.setattr(ptt.FLAGS, "use_fused_rnn", False)
    scan = _run_port(artifact, seqs)
    np.testing.assert_array_equal(fused[0], scan[0])
    np.testing.assert_allclose(fused[1], scan[1], rtol=0, atol=1e-4)


def test_amp_bf16_dtype_flow(artifact, monkeypatch):
    """Under set_amp("bfloat16") the encoder GRUs run in bf16 and the
    fetches come back as finite float32 numpy (numpy has no bfloat16) of
    the right shapes, with valid ids and lengths."""
    from paddle_tpu_torch.ops import rnn_kernels

    gru_dtypes = []
    gru_fwd = rnn_kernels.gru_fwd

    def spy(x, mask, w, reverse=False):
        gru_dtypes.append((x.dtype, w.dtype))
        return gru_fwd(x, mask, w, reverse)

    monkeypatch.setattr(rnn_kernels, "gru_fwd", spy)
    scope = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(artifact, scope=scope, device="cpu")
    prog.set_amp("bfloat16")
    feed = {feeds[0]: ptt.LoDArray.from_sequences(_seqs(3), capacity=B * S, max_seqs=B)}
    ids, sc, lens = ptt.Executor(device="cpu").run(prog, feed, fetches, scope=scope)
    assert gru_dtypes == [(torch.bfloat16, torch.bfloat16)] * 2
    assert sc.dtype == np.float32 and np.isfinite(sc).all()
    assert ids.shape == (B, K, T) and ((ids >= 0) & (ids < V)).all()
    assert ((lens >= 1) & (lens <= T)).all()
    assert scope.get("s2s.enc_fwd_w").dtype == torch.float32  # masters stay f32


_BF16_ATOL = 4e-3
_BF16_MAX_DIFFERING = {"encoder state": 0.02, "decoder h0": 0.10}
_BF16_SCORE_ATOL = 0.25  # two bf16 ulps for |score| in [16, 32)


@pytest.mark.parametrize("seed", [0, 1])
def test_amp_bf16_port_matches_jax(seeded_artifact, seed, monkeypatch):
    monkeypatch.setattr(FLAGS, "fused_rnn_interpret", True)
    seqs = _seqs(seed)
    j_enc, j_h0, _, j_sc, j_len = _run_jax(seeded_artifact, seqs, "bfloat16", extra=True)
    p_enc, p_h0, _, p_sc, p_len = _run_port(seeded_artifact, seqs, "bfloat16", extra=True)
    assert p_enc.data.dtype == torch.bfloat16 and p_h0.dtype == np.float32
    for name, got, want in (("encoder state", p_enc.data.float().numpy(), j_enc.data),
                            ("decoder h0", p_h0, j_h0)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=_BF16_ATOL, err_msg=name)
        differing = float(np.mean(got != want))
        assert differing <= _BF16_MAX_DIFFERING[name], (name, differing)
    np.testing.assert_allclose(p_sc, np.asarray(j_sc, np.float32), rtol=0,
                               atol=_BF16_SCORE_ATOL)
    np.testing.assert_array_equal(p_len, np.asarray(j_len))


@pytest.mark.parametrize("seed", [0, 1])
def test_amp_bf16_bounds_reject_the_scan_rounding(seeded_artifact, seed, monkeypatch):
    """The JAX package's bf16 scan rounds inside the GRU where the Pallas
    kernel does not; the share bounds above tell the two apart."""
    monkeypatch.setattr(FLAGS, "fused_rnn_interpret", False)
    seqs = _seqs(seed)
    j_enc, j_h0, *_ = _run_jax(seeded_artifact, seqs, "bfloat16", extra=True)
    p_enc, p_h0, *_ = _run_port(seeded_artifact, seqs, "bfloat16", extra=True)
    for name, got, want in (("encoder state", p_enc.data.float().numpy(), j_enc.data),
                            ("decoder h0", p_h0, j_h0)):
        differing = float(np.mean(got != np.asarray(want, np.float32)))
        assert differing > _BF16_MAX_DIFFERING[name], (name, differing)
