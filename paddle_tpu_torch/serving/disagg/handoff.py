"""Handoff payload: a request's decode boot state on the wire
(paddle_tpu/serving/disagg/handoff.py, byte for byte).

A prefill replica serializes the host-side boot state that
`ContinuousScheduler.prefill` gathered (`gather_handoff_rows`: one
device-to-host copy), the dispatcher ships the bytes, and a decode replica
validates and unpacks them into `submit_handoff`, which puts the rows on its
own device (`restore_handoff_rows`). The state never goes through a re-run
of the prefix, so disaggregated decoding equals monolithic decoding bit for
bit.

Layout: `b"PTHO1" | u32 header_len | header JSON | raw buffers`, buffers
concatenated in header order (boots then per-example rows, each
optionally followed by its per-row scale vector). The header carries the
artifact's DecodeState schema identity (io.generation_state_fingerprint)
so a mixed-version fleet mid-rollout fails at the /admit boundary with a
typed error naming the fix — never as a shape crash inside the pool.

int8 packing is the quant recipe at per-ROW granularity (absmax/127 scale,
round half to even, clip; dequant is `q * scale` in f32, then the cast):
float32 state shrinks about 4x, less the scale vectors and any integer state,
which rides raw (quantizing token ids would corrupt them).

The arrays are torch tensors or numpy arrays. bfloat16 has no numpy dtype
here: its buffers are written and read as torch bfloat16 viewed as 16-bit
words, under the header's dtype name "bfloat16", the bytes the JAX package
writes for the same values. `unpack_handoff` returns CPU tensors.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HandoffError", "HandoffSchemaError", "MAGIC", "gather_handoff_rows",
           "pack_handoff", "payload_schema", "restore_handoff_rows", "unpack_handoff",
           "validate_handoff"]

MAGIC = b"PTHO1"
_LEN = struct.Struct(">I")

# the one-command fix every schema rejection names: roll the whole fleet to
# one artifact version (warm, verify, flip, drain)
_ROLLOUT_CMD = "paddle_tpu_torch fleetctl rollout --router <url> --model_dir <new artifact>"

# dtypes numpy cannot name without an extension package: name -> torch
# dtype, and the integer word their bytes are moved as
_WORD_DTYPES = {"bfloat16": (torch.bfloat16, torch.int16, np.int16)}
_LOW_FLOATS = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


class HandoffError(ValueError):
    """A handoff payload is malformed (bad magic, truncated buffers, an
    unknown quant mode): the bytes themselves are unusable."""


class HandoffSchemaError(HandoffError):
    """The payload is well formed but its DecodeState schema identity does
    not match the admitting artifact's: the prefill and decode replicas
    serve different decode-state layouts (a mixed-version fleet mid-
    rollout). Rejected at /admit, before any state reaches the pool, with
    the fix in the message."""


def payload_schema(gen_meta: Dict[str, Any]) -> Dict[str, Any]:
    """The schema identity a replica stamps on the payloads it emits and
    checks on those it admits, from the artifact's generation sidecar (the
    loader backfills the fingerprint of an older artifact)."""
    from ... import io as pt_io

    if not gen_meta:
        raise HandoffError("model has no generation sidecar: disaggregated handoff serves "
                           "generation models only")
    return {
        "schema_version": int(gen_meta.get("schema_version", pt_io.GENERATION_SCHEMA_VERSION)),
        "state_fingerprint": (gen_meta.get("state_fingerprint")
                              or pt_io.generation_state_fingerprint(gen_meta)),
    }


def _host(a) -> Tuple[str, tuple, bytes, Optional[np.ndarray]]:
    """(dtype name, shape, raw bytes, float32 values or None when the
    dtype is not a float) of a tensor or array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        for name, (dt, word, _) in _WORD_DTYPES.items():
            if t.dtype == dt:
                return name, tuple(t.shape), t.view(word).numpy().tobytes(), t.float().numpy()
        a = t.numpy()
    a = np.ascontiguousarray(a)
    name = np.dtype(a.dtype).name
    xf = a.astype(np.float32) if np.dtype(a.dtype).kind == "f" or name in _LOW_FLOATS else None
    return name, tuple(a.shape), a.tobytes(), xf


def _pack_group(arrays: Sequence, quant: Optional[str], specs: list, chunks: list) -> None:
    from ...ops.quant_kernels import INT8_MAX

    for a in arrays:
        name, shape, raw, xf = _host(a)
        spec = {"dtype": name, "shape": [int(d) for d in shape]}
        if quant == "int8" and xf is not None:
            n = shape[0]
            absmax = (np.max(np.abs(xf.reshape(n, -1)), axis=1) if xf.size
                      else np.zeros((n,), np.float32))
            # per ROW: absmax/127, round half to even, clip
            scale = (np.maximum(absmax, 1e-30) / INT8_MAX).astype(np.float32)
            q = np.clip(np.round(xf / scale.reshape((n,) + (1,) * (len(shape) - 1))),
                        -INT8_MAX, INT8_MAX).astype(np.int8)
            spec["q"] = True
            chunks.append(q.tobytes())
            chunks.append(np.ascontiguousarray(scale).tobytes())
        else:
            spec["q"] = False
            chunks.append(raw)
        specs.append(spec)


def pack_handoff(boots: Sequence, pes: Sequence, schema: Dict[str, Any], model: str,
                 request_id: Optional[str] = None, quant: Optional[str] = None) -> bytes:
    """One request's boot state (host tensors or arrays [n, ...]) as a
    self-describing payload. `schema` is payload_schema(...) of the emitting
    artifact; `quant="int8"` packs float tensors per-row int8 (and an f32
    scale vector each)."""
    if quant not in (None, "int8"):
        raise HandoffError(f"unsupported handoff quant {quant!r} (only 'int8')")
    boots, pes = tuple(boots), tuple(pes)
    rows = {int(a.shape[0]) for a in boots + pes}
    if len(rows) != 1:
        raise HandoffError(f"handoff state arrays must share the row axis; got row counts "
                           f"{sorted(rows)}")
    specs_b: list = []
    specs_p: list = []
    chunks: list = []
    _pack_group(boots, quant, specs_b, chunks)
    _pack_group(pes, quant, specs_p, chunks)
    header = {
        "version": 1,
        "model": model,
        "request_id": request_id,
        "rows": rows.pop(),
        "quant": quant,
        "schema_version": int(schema["schema_version"]),
        "state_fingerprint": str(schema["state_fingerprint"]),
        "boots": specs_b,
        "pes": specs_p,
    }
    hdr = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    return b"".join([MAGIC, _LEN.pack(len(hdr)), hdr] + chunks)


def _torch_dtype(name: str) -> torch.dtype:
    if name in _WORD_DTYPES:
        return _WORD_DTYPES[name][0]
    try:
        return torch.from_numpy(np.zeros((), np.dtype(name))).dtype
    except TypeError as e:
        raise HandoffError(f"unsupported handoff dtype {name!r}") from e


def _raw(data: bytes, name: str, count: int, off: int) -> Tuple[torch.Tensor, int]:
    if name in _WORD_DTYPES:
        dt, word, np_word = _WORD_DTYPES[name]
        a = np.frombuffer(data, np_word, count=count, offset=off)
        return torch.from_numpy(a.copy()).view(dt), off + a.nbytes
    a = np.frombuffer(data, np.dtype(name), count=count, offset=off)
    return torch.from_numpy(a.copy()), off + a.nbytes


def _unpack_group(specs: list, data: bytes, off: int):
    out = []
    for spec in specs:
        name = spec["dtype"]
        dt = _torch_dtype(name)
        shape = tuple(spec["shape"])
        n = int(np.prod(shape, dtype=np.int64))
        if spec.get("q"):
            q = np.frombuffer(data, np.int8, count=n, offset=off)
            off += n
            rows = shape[0] if shape else 0
            scale = np.frombuffer(data, np.float32, count=rows, offset=off)
            off += scale.nbytes
            q = torch.from_numpy(q.reshape(shape).astype(np.float32))
            sc = torch.from_numpy(scale.reshape((rows,) + (1,) * (len(shape) - 1)).copy())
            # the dequant: q * scale in f32, then the cast
            out.append((q * sc).to(dt))
        else:
            t, off = _raw(data, name, n, off)
            out.append(t.reshape(shape))
    return tuple(out), off


def unpack_handoff(data: bytes) -> Tuple[Dict[str, Any], tuple, tuple]:
    """A payload as (header, boots, pes), CPU tensors, int8 ones already
    dequantized. Raises HandoffError on malformed bytes; schema acceptance
    is the caller's validate_handoff."""
    if not data.startswith(MAGIC):
        raise HandoffError("not a handoff payload (bad magic): /admit takes the bytes a "
                           "/prefill call returned, verbatim")
    try:
        (hlen,) = _LEN.unpack_from(data, len(MAGIC))
        off = len(MAGIC) + _LEN.size
        header = json.loads(data[off:off + hlen].decode())
        off += hlen
        boots, off = _unpack_group(header["boots"], data, off)
        pes, off = _unpack_group(header["pes"], data, off)
    except HandoffError:
        raise
    except Exception as e:
        raise HandoffError(f"truncated or corrupt handoff payload ({type(e).__name__}: {e})") \
            from e
    if off != len(data):
        raise HandoffError(f"handoff payload has {len(data) - off} trailing bytes: truncated "
                           "header or mismatched buffer specs")
    return header, boots, pes


def validate_handoff(header: Dict[str, Any], gen_meta: Dict[str, Any]) -> None:
    """The admission gate: the payload's DecodeState schema identity must
    match the admitting artifact's, before any state reaches the pool."""
    want = payload_schema(gen_meta)
    got_v = header.get("schema_version")
    got_fp = header.get("state_fingerprint")
    if got_v != want["schema_version"]:
        raise HandoffSchemaError(
            f"handoff schema version {got_v} != this replica's {want['schema_version']}: "
            f"prefill and decode replicas disagree on the DecodeState wire format; roll the "
            f"whole fleet to one version: {_ROLLOUT_CMD}")
    if got_fp != want["state_fingerprint"]:
        raise HandoffSchemaError(
            f"handoff state fingerprint {got_fp} != this replica's "
            f"{want['state_fingerprint']}: the prefill replica serves a different decode-state "
            f"layout (mixed artifact versions mid-rollout?); roll the whole fleet to one "
            f"artifact: {_ROLLOUT_CMD}")


# -- the device ends of a handoff (paddle_tpu/pipeline/elastic.py:174, 190,
# on one device) ------------------------------------------------------------

def gather_handoff_rows(arrays, rows: int) -> Tuple[torch.Tensor, ...]:
    """The first `rows` rows of each device tensor, on the host, through ONE
    device-to-host copy: the row slices' bytes are joined on the device,
    each starting at a multiple of 16 bytes (so that any dtype views its
    own), copied once (one host sync), and split back into CPU tensors."""
    arrays = tuple(arrays)
    if not arrays:
        return ()
    parts = [a[:rows].contiguous() for a in arrays]
    pieces, starts, off = [], [], 0
    for p in parts:
        pad = -off % 16
        if pad:
            pieces.append(torch.zeros(pad, dtype=torch.uint8, device=p.device))
        starts.append(off + pad)
        pieces.append(p.view(-1).view(torch.uint8))
        off += pad + p.numel() * p.element_size()
    host = torch.cat(pieces).cpu()
    return tuple(host[o:o + p.numel() * p.element_size()].view(p.dtype).reshape(p.shape)
                 for o, p in zip(starts, parts))


def restore_handoff_rows(arrays, device, mesh=None) -> Tuple[torch.Tensor, ...]:
    """Handoff rows (CPU tensors or numpy arrays) on the admitting device."""
    if mesh is not None:
        from ..engine import _not_ported

        raise _not_ported("a mesh-sharded handoff restore (mesh=)", "A10b")
    return tuple(torch.as_tensor(a).to(device) for a in arrays)
