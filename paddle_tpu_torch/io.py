"""Saved programs and state passing between the JAX package and the port.

An inference artifact (what `save_inference_model` here and in the JAX
package writes) is a directory holding `program.json` (Program.to_dict),
`params.npz` (one array per parameter name) and `meta.json` (feed, fetch and
parameter names, feed specs, the program's fingerprint, and optional
sidecars). A generation artifact's `generation` sidecar records its beam
geometry and decode-state specs, so a serving scheduler sizes its slot pool
without running a request. A quantized artifact's `quant` sidecar pins its int8 payloads
and scales to the program: `load_inference_model` raises QuantMetaError
when either no longer matches. A training program is a directory holding
`main.json` and `startup.json` (Program.to_dict of each) and `meta.json`
(feed, loss and parameter names, the widths, the amp dtype). State — parameters and
optimizer persistables alike — crosses as numpy arrays by name.

A training checkpoint (`save_checkpoint`, paddle_tpu/io.py:604-880) is a
numbered directory `checkpoint_<serial>/` under the checkpoint dir holding
`params.npz` (every persistable) and, written last as its completion
marker, `meta.json` (the serial, the trainer's position, the sha256 of each
payload file): the JAX package's layout, so a checkpoint written by one
package resumes in the other. A serial whose payload does not match its
hashes is moved aside to `<dir>.corrupt` and the previous one is loaded.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import warnings
import zipfile
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .core.executor import Scope, global_scope
from .core.lod import LoDArray
from .core.place import resolve_device
from .core.program import Program, Variable, default_main_program
from .resilience import faults

PARAMS_FILE = "params.npz"
PROGRAM_FILE = "program.json"
META_FILE = "meta.json"
MAIN_FILE = "main.json"
STARTUP_FILE = "startup.json"
CHECKPOINT_PREFIX = "checkpoint"

# sidecars that change how the artifact must run; the port cannot honour
# them yet, so it refuses the artifact rather than serve it wrongly. (The
# `draft_model` sidecar names the speculative-decoding draft the serving
# scheduler drafts with: kept as `program._draft_meta`.)
_UNSUPPORTED_SIDECARS = ("sharding",)
# the DecodeState wire-schema version (paddle_tpu/io.py:76): part of the
# generation sidecar's identity
GENERATION_SCHEMA_VERSION = 1
# the suffix of a quantized weight's f32 scale var (quant/convert.py)
SCALE_SUFFIX = "@quant_scale"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint's payload does not match the integrity record in its
    meta (or the payload is unreadable)."""


class QuantMetaError(ValueError):
    """A quantized artifact's quant sidecar does not match its payload: the
    program changed after its scales were calibrated, or the int8 weights
    or their scales were replaced."""


def program_fingerprint(program: Program) -> str:
    """Content hash of the program's to_dict (the JAX package's
    `program_fingerprint`: the same dict gives the same hash there)."""
    blob = json.dumps(program.to_dict(), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def generation_state_fingerprint(gen: Dict[str, Any]) -> str:
    """Layout identity of the decode state a generation artifact boots
    (paddle_tpu/io.py:79): beam geometry and the dtypes and trailing shapes
    of each state and per-example tensor, hashed over canonical JSON; not
    the program's fingerprint, so retrained weights keep it."""
    layout = {
        "schema_version": int(gen.get("schema_version", GENERATION_SCHEMA_VERSION)),
        "beam_size": int(gen["beam_size"]),
        "max_len": int(gen["max_len"]),
        "bos_id": int(gen["bos_id"]),
        "eos_id": int(gen["eos_id"]),
        "length_normalize": bool(gen.get("length_normalize", False)),
        "state": [[s["name"], s["dtype"], s["shape"]] for s in gen.get("state", [])],
        "per_example": [[s["name"], s["dtype"], s["shape"]]
                        for s in gen.get("per_example", [])],
    }
    blob = json.dumps(layout, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _generation_meta(pruned: Program) -> Optional[dict]:
    """The generation sidecar (paddle_tpu/io.py:494): the beam_search_group
    op's geometry and each boot and per-example tensor's dtype and trailing
    shape (the batch axis is the slot axis when serving), or None."""
    block = pruned.global_block()
    op = next((o for o in block.ops if o.type == "beam_search_group"), None)
    if op is None:
        return None

    def vspec(name):
        try:
            v = block.var(name)
        except KeyError:
            return {"name": name, "dtype": "float32", "shape": None}
        trailing = [int(d) for d in v.shape[1:]]
        return {"name": name, "dtype": np.dtype(v.dtype).name,
                "shape": trailing if all(d > 0 for d in trailing) else None}

    gen = {
        "beam_size": int(op.attrs.get("beam_size", 4)),
        "max_len": int(op.attrs.get("max_len", 32)),
        "bos_id": int(op.attrs.get("bos_id", 0)),
        "eos_id": int(op.attrs.get("eos_id", 1)),
        "length_normalize": bool(op.attrs.get("length_normalize", False)),
        "state": [vspec(n) for n in op.inputs.get("Boot", [])],
        "per_example": [vspec(n) for n in op.inputs.get("PerExample", [])],
        "outputs": {"ids": op.outputs["Ids"][0], "scores": op.outputs["Scores"][0],
                    "lengths": op.outputs["Lengths"][0]},
    }
    gen["schema_version"] = GENERATION_SCHEMA_VERSION
    gen["state_fingerprint"] = generation_state_fingerprint(gen)
    return gen


def _scales_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Digest over every int8 array and every scale var, with name, numpy
    dtype string and shape, in name order (the JAX package's
    `quant_scales_digest`)."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = arrays[name]
        if a.dtype != np.int8 and not name.endswith(SCALE_SUFFIX):
            continue
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def quant_scales_digest(scope: Scope, param_names: Sequence[str]) -> str:
    """`_scales_digest` over the named scope values that carry quant
    payload (only those are copied to the host)."""
    return _scales_digest({
        n: _host(scope.get(n)) for n in param_names if scope.has(n)
        and (scope.get(n).dtype == torch.int8 or n.endswith(SCALE_SUFFIX))})


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_json_atomic(path: str, obj) -> None:
    """tmp + os.replace, so a preempted writer never leaves a torn JSON
    file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _host(value) -> np.ndarray:
    """A scope value as a numpy array (bf16 widens to f32, which numpy
    has); a numpy array (a host snapshot's value) passes through."""
    if isinstance(value, LoDArray):
        raise TypeError("cannot save a LoDArray variable")
    if isinstance(value, np.ndarray):
        return value
    t = value.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray], device) -> None:
    """Carry state given as numpy arrays by name (the JAX package's scope
    values, or an npz) into `scope` as tensors on `device`, bit for bit:
    parameters, and the optimizer's persistables (moments, beta powers,
    learning rate) alike."""
    dev = torch.device(device)
    for name, a in arrays.items():
        # a copy: the JAX package's arrays are read-only
        scope.set(name, torch.as_tensor(np.array(a, order="C"), device=dev))
        scope.shards.pop(name, None)  # whole again: a mesh executor cuts it anew


def state_to_numpy(scope: Scope, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The reverse of params_from_numpy: the named scope values as numpy
    arrays (bf16 values widen to f32, which numpy has; int8 payloads and
    their f32 scales cross bit for bit)."""
    return {n: _host(scope.get(n)) for n in names}


# ---------------------------------------------------------- save and load --
def save_vars(dirname: str, var_names: Sequence[str], scope: Optional[Scope] = None,
              filename: str = PARAMS_FILE) -> str:
    """The named scope values as one npz under `dirname`, written to a
    temporary file and renamed over the old one, so a failed save never
    leaves a torn file. The fault point `ckpt.write` fires before the
    rename: "raise" leaves the previous file intact, "corrupt" publishes a
    torn npz (what the loader's quarantine must survive)."""
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {n: _host(scope.get(n)) for n in var_names}
    path = os.path.join(dirname, filename)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        if faults.fire("ckpt.write", path=path) == "corrupt":
            with open(tmp, "r+b") as f:
                f.truncate(max(os.path.getsize(tmp) // 2, 1))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _read_npz(path: str, var_names: Optional[Sequence[str]]) -> Dict[str, np.ndarray]:
    """Every named array, read in full before anything is handed on, so a
    bad file never leaves a scope half-updated."""
    with np.load(path) as data:
        names = list(data.files) if var_names is None else list(var_names)
        missing = [n for n in names if n not in data]
        if missing:
            raise KeyError(f"variables {missing} not found in {path}")
        return {n: data[n] for n in names}


def load_vars(dirname: str, scope: Optional[Scope] = None, filename: str = PARAMS_FILE,
              var_names: Optional[Sequence[str]] = None, device=None) -> List[str]:
    """Loads the named arrays (all, by default) of `dirname`'s npz into
    `scope` on `device` (default: the card); returns their names."""
    arrays = _read_npz(os.path.join(dirname, filename), var_names)
    params_from_numpy(scope or global_scope(), arrays, resolve_device(device))
    return list(arrays)


def save_params(dirname, main_program: Optional[Program] = None, scope=None):
    """The program's parameters only (no optimizer state)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    missing = sorted(v.name for v in program.parameters() if not scope.has(v.name))
    if missing:
        raise ValueError(f"save_params: parameters {missing} are not in the scope — "
                         "did the startup program run?")
    return save_vars(dirname, sorted(v.name for v in program.parameters()), scope)


def save_persistables(dirname, main_program: Optional[Program] = None, scope=None):
    """Every persistable the scope holds: parameters and optimizer state."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    return save_vars(dirname, sorted(v.name for v in program.persistables()
                                     if scope.has(v.name)), scope)


def load_params(dirname, main_program: Optional[Program] = None, scope=None, device=None):
    program = main_program or default_main_program()
    return load_vars(dirname, scope, var_names=sorted(v.name for v in program.parameters()),
                     device=device)


def load_persistables(dirname, main_program: Optional[Program] = None, scope=None,
                      device=None):
    """Whatever the file holds (the program may have been rebuilt with the
    same names)."""
    return load_vars(dirname, scope, device=device)


def _prune_for_inference(program: Program, feed_names: Sequence[str],
                         target_names: Sequence[str]) -> Program:
    """Block 0 sliced to the ops that compute `target_names` from
    `feed_names`, after clone(for_test=True) has dropped the backward and
    optimizer ops and set is_test. Names an op's sub-block reads from the
    enclosing block count as its inputs."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()

    def sub_block_refs(op) -> set:
        refs: set = set()
        idx = op.attrs.get("sub_block")
        if not isinstance(idx, int):
            return refs
        stack = [idx]
        while stack:
            produced: set = set()
            for sop in pruned.blocks[stack.pop()].ops:
                refs.update(n for n in sop.input_names() if n not in produced)
                produced.update(sop.output_names())
                inner = sop.attrs.get("sub_block")
                if isinstance(inner, int):
                    stack.append(inner)
        return refs

    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if any(o in needed for o in op.output_names()):
            kept.append(op)
            needed.update(op.input_names())
            needed.update(n for n in sub_block_refs(op) if n in block.vars)
    kept.reverse()
    block.ops = kept

    referenced = set(feed_names) | set(target_names)
    for op in kept:
        referenced.update(op.input_names())
        referenced.update(op.output_names())
        referenced.update(n for n in sub_block_refs(op) if n in block.vars)
    block.vars = {n: v for n, v in block.vars.items() if n in referenced}
    missing = [n for n in feed_names if n not in needed]
    if missing:
        raise ValueError(f"feed vars {missing} are not inputs of the pruned inference "
                         f"slice for targets {list(target_names)}")
    return pruned


def save_inference_model(dirname: str, feeded_var_names: Sequence[str], target_vars: Sequence,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None,
                         draft_model: Optional[str] = None) -> None:
    """The pruned program and its persistables in `dirname`, in the JAX
    package's artifact format. meta.json carries the feed specs, the
    program's fingerprint, for a generation program the `generation`
    sidecar, for a program quant.convert rewrote the `quant` sidecar with
    the fingerprint and scales digest of what is saved, and with
    `draft_model` the `draft_model` sidecar: the directory (a relative one
    resolves against `dirname` at load) of the small generation model the
    serving scheduler drafts with by default. It leaves out the JAX exporter's `tuning` record, which names a
    TPU table (its loader reads an absent one as None)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    target_names = [v.name if isinstance(v, Variable) else v for v in target_vars]
    pruned = _prune_for_inference(program, feeded_var_names, target_names)
    os.makedirs(dirname, exist_ok=True)
    param_names = sorted(v.name for v in pruned.global_block().vars.values()
                         if v.persistable and scope.has(v.name))
    save_vars(dirname, param_names, scope)
    feed_specs = {}
    for n in feeded_var_names:
        if n in pruned.global_block().vars:
            v = pruned.global_block().vars[n]
            feed_specs[n] = {"dtype": np.dtype(v.dtype).name,
                             "shape": [int(d) for d in v.shape]}
    fingerprint = program_fingerprint(pruned)
    meta = {"feed_names": list(feeded_var_names), "fetch_names": target_names,
            "param_names": param_names, "feed_specs": feed_specs,
            "program_fingerprint": fingerprint}
    generation = _generation_meta(pruned)
    if generation:
        meta["generation"] = generation
    qmeta = getattr(program, "_quant_meta", None)
    if qmeta:
        meta["quant"] = dict(qmeta, program_fingerprint=fingerprint,
                             scales_digest=quant_scales_digest(scope, param_names))
    if draft_model:
        meta["draft_model"] = {"dir": draft_model}
    with open(os.path.join(dirname, PROGRAM_FILE), "w") as f:
        json.dump(pruned.to_dict(), f)
    with open(os.path.join(dirname, META_FILE), "w") as f:
        json.dump(meta, f)


def load_train_program(dirname: str):
    """Returns (main, startup, meta) from a training program directory;
    main carries meta's amp dtype. Train with
    `exe.run(startup, scope=scope)`, then
    `exe.run(main, feed, [meta["loss_name"]], scope=scope)`."""
    with open(os.path.join(dirname, META_FILE)) as f:
        meta = json.load(f)
    progs = []
    for name in (MAIN_FILE, STARTUP_FILE):
        with open(os.path.join(dirname, name)) as f:
            progs.append(Program.from_dict(json.load(f)))
    main, startup = progs
    main.set_amp(meta.get("amp"))
    return main, startup, meta


def load_inference_model(dirname: str, scope: Optional[Scope] = None, device=None):
    """Returns (program, feed_names, fetch_names); the parameters named in
    meta.json are loaded into `scope` on `device` (default: the card), so
    `Executor(device).run(program, feed, fetch_list, scope)` runs it. A
    quantized artifact whose program or int8 payload and scales no longer
    match its `quant` sidecar raises QuantMetaError, and leaves the scope
    untouched."""
    dev = resolve_device(device)
    scope = scope or global_scope()
    with open(os.path.join(dirname, META_FILE)) as f:
        meta = json.load(f)
    present = [k for k in _UNSUPPORTED_SIDECARS if meta.get(k)]
    if present:
        raise NotImplementedError(
            f"{dirname}: the artifact carries the sidecar(s) {present}, "
            "which the PyTorch port does not support yet (the serving mesh, ROADMAP.md "
            "A10b)")
    # meta["tuning"] records which TPU table the exporter's kernels were
    # tuned with; it says nothing about this card, so it is skipped on purpose
    with open(os.path.join(dirname, PROGRAM_FILE)) as f:
        program = Program.from_dict(json.load(f))
    arrays = _read_npz(os.path.join(dirname, PARAMS_FILE), meta["param_names"])
    program._serving_meta = meta.get("feed_specs") or None
    program._program_fingerprint = meta.get("program_fingerprint") or None
    gen = meta.get("generation") or None
    if gen is not None and not gen.get("state_fingerprint"):
        # an artifact older than the schema identity: backfilled, as the
        # JAX loader does
        gen.setdefault("schema_version", GENERATION_SCHEMA_VERSION)
        gen["state_fingerprint"] = generation_state_fingerprint(gen)
    program._generation_meta = gen
    program._draft_meta = meta.get("draft_model") or None
    program._quant_meta = meta.get("quant") or None
    if program._quant_meta:
        q = program._quant_meta
        fp = program_fingerprint(program)
        if q.get("program_fingerprint") not in (None, fp):
            raise QuantMetaError(
                f"{dirname}: quantized artifact is stale — the program ({fp}) no longer "
                f"matches the one its scales were calibrated for "
                f"({q['program_fingerprint']}); re-run calibrate + convert and re-export")
        digest = _scales_digest(arrays)
        if q.get("scales_digest") not in (None, digest):
            raise QuantMetaError(
                f"{dirname}: quantized payload/scales digest {digest} does not match the "
                f"recorded {q['scales_digest']} — the int8 weights or their scales were "
                "modified after export; refusing to serve mismatched scales")
    params_from_numpy(scope, arrays, dev)
    return program, meta["feed_names"], meta["fetch_names"]


# ------------------------------------------------------------ checkpoints --
def _serial_dir(checkpoint_dir: str, serial: int) -> str:
    return os.path.join(checkpoint_dir, f"{CHECKPOINT_PREFIX}_{serial}")


def _complete_serials(checkpoint_dir: str) -> List[int]:
    """Ascending serials whose completion marker (meta) is present;
    quarantined `checkpoint_N.corrupt` dirs never match."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in os.listdir(checkpoint_dir):
        m = re.fullmatch(rf"{CHECKPOINT_PREFIX}_(\d+)", name)
        if m and os.path.exists(os.path.join(checkpoint_dir, name, META_FILE)):
            out.append(int(m.group(1)))
    return sorted(out)


def get_latest_checkpoint_serial(checkpoint_dir: str, verify: bool = False) -> int:
    """Largest complete checkpoint serial, or -1. verify=True returns the
    newest serial whose payload matches its hashes (read-only: nothing is
    quarantined; load_checkpoint does that when it falls back)."""
    serials = _complete_serials(checkpoint_dir)
    if not verify:
        return serials[-1] if serials else -1
    for serial in reversed(serials):
        try:
            verify_checkpoint(_serial_dir(checkpoint_dir, serial))
            return serial
        except CheckpointCorruptError:
            continue
    return -1


def verify_checkpoint(dirname: str) -> None:
    """Raise CheckpointCorruptError unless the directory's meta parses and
    every payload file hashed into it (`integrity`) is present and
    matches. A checkpoint without an integrity record passes (its
    corruption still shows when it is read)."""
    try:
        with open(os.path.join(dirname, META_FILE)) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{dirname}: unreadable meta ({e})") from e
    integrity = meta.get("integrity")
    if not isinstance(integrity, dict):
        # a save without hashes: a sharded one can still be checked for
        # every shard file its manifest names
        smeta_path = os.path.join(dirname, SHARDED_META)
        if os.path.exists(smeta_path):
            try:
                with open(smeta_path) as f:
                    smeta = json.load(f)
            except (OSError, ValueError) as e:
                raise CheckpointCorruptError(f"{dirname}: unreadable sharded meta ({e})") from e
            for p in sorted(_shard_processes(smeta)):
                if not os.path.exists(os.path.join(dirname, f"shards_p{p}.npz")):
                    raise CheckpointCorruptError(
                        f"{dirname}: shard file shards_p{p}.npz referenced by the manifest "
                        "is missing")
        return
    for fname, want in sorted(integrity.items()):
        path = os.path.join(dirname, fname)
        if not os.path.exists(path):
            raise CheckpointCorruptError(f"{dirname}: payload {fname} missing")
        got = _sha256_file(path)
        if got != want:
            raise CheckpointCorruptError(
                f"{dirname}: payload {fname} sha256 {got[:12]}… does not match the "
                f"recorded {str(want)[:12]}…")


def _quarantine_dir(dirname: str) -> str:
    """Move a corrupt checkpoint aside, out of the serial scan's sight."""
    q = dirname + ".corrupt"
    i = 1
    while os.path.exists(q):
        q = f"{dirname}.corrupt.{i}"
        i += 1
    os.replace(dirname, q)
    return q


def _payload_files(dirname: str) -> List[str]:
    """Checkpoint payload files subject to integrity hashing."""
    return sorted(n for n in os.listdir(dirname)
                  if n == PARAMS_FILE or n == SHARDED_META or re.fullmatch(r"shards_p\d+\.npz", n))


def _meta_with_hashes(d: str, serial: int, trainer_args) -> dict:
    return {"serial": serial, "trainer_args": trainer_args or {},
            "integrity": {n: _sha256_file(os.path.join(d, n)) for n in _payload_files(d)}}


def save_checkpoint(checkpoint_dir: str, trainer_args: Optional[Dict[str, Any]] = None,
                    main_program: Optional[Program] = None, scope: Optional[Scope] = None,
                    max_num_checkpoints: int = 3, sharded: bool = False) -> int:
    """Every persistable plus the trainer's position as a new numbered
    checkpoint, keeping the newest `max_num_checkpoints`. Returns the new
    serial. `scope` may hold tensors or a host snapshot's numpy arrays.
    Serial allocation re-lists the directory, so one thread saves into a
    directory at a time (the Trainer's writer thread).

    sharded=True writes the JAX package's per-shard format (below): each
    process writes the slices it owns, the chief folds the manifests, and
    every process of a torch.distributed group must call it together (its
    barriers; the chief picks the serial)."""
    from .parallel import distributed

    serial = get_latest_checkpoint_serial(checkpoint_dir) + 1
    if sharded:
        chief = distributed.is_chief()
        multi = distributed.process_count() > 1
        if multi:
            # every process must agree on the serial: the chief decides
            serial = distributed.broadcast_int(serial)
        d = _serial_dir(checkpoint_dir, serial)
        os.makedirs(d, exist_ok=True)
        save_sharded_checkpoint(d, main_program, scope)  # barriers inside
        # the completion marker: the chief's, after the fold, with a sha256
        # a payload file; then a barrier, so no process returns before the
        # checkpoint is loadable
        if chief:
            faults.fire("ckpt.meta", serial=serial)
            _write_json_atomic(os.path.join(d, META_FILE),
                               _meta_with_hashes(d, serial, trainer_args))
        if multi:
            distributed.barrier()
        if not chief:
            return serial  # retention runs on the chief only
    else:
        d = _serial_dir(checkpoint_dir, serial)
        os.makedirs(d, exist_ok=True)
        save_persistables(d, main_program, scope)
        # meta last: its presence marks the checkpoint complete, and it
        # carries the payload hashes load verifies
        faults.fire("ckpt.meta", serial=serial)
        _write_json_atomic(os.path.join(d, META_FILE), _meta_with_hashes(d, serial,
                                                                          trainer_args))
    # retention sweeps complete serials only
    for s in _complete_serials(checkpoint_dir)[:-max_num_checkpoints]:
        shutil.rmtree(_serial_dir(checkpoint_dir, s), ignore_errors=True)
    return serial


# errors that mean "this checkpoint is damaged, try the previous one"
_RECOVERABLE_LOAD_ERRORS = (CheckpointCorruptError, OSError, ValueError, KeyError, EOFError,
                            zipfile.BadZipFile)


def load_checkpoint(checkpoint_dir: str, main_program: Optional[Program] = None,
                    scope: Optional[Scope] = None, device=None) -> Dict[str, Any]:
    """Restore the newest VALID checkpoint into `scope` on `device`
    (default: the card); returns its trainer_args. A serial whose hashes
    mismatch, or whose payload fails to read (a torn shard file, a missing
    member), is quarantined to `<dir>.corrupt` and the previous serial is
    tried. A sharded checkpoint (`sharded_meta.json`, either package's) is
    assembled into whole values."""
    dev = resolve_device(device)
    quarantined = 0
    while True:
        serial = get_latest_checkpoint_serial(checkpoint_dir)
        if serial < 0:
            extra = f" ({quarantined} corrupt serial(s) quarantined)" if quarantined else ""
            raise FileNotFoundError(f"no valid checkpoint under {checkpoint_dir}{extra}")
        d = _serial_dir(checkpoint_dir, serial)
        try:
            verify_checkpoint(d)
            if os.path.exists(os.path.join(d, SHARDED_META)):
                arrays, world = _assemble_sharded(d, main_program)
            else:
                arrays, world = _read_npz(os.path.join(d, PARAMS_FILE), None), None
            with open(os.path.join(d, META_FILE)) as f:
                args = json.load(f)["trainer_args"]
        except _RECOVERABLE_LOAD_ERRORS as e:
            quarantined += 1
            q = _quarantine_dir(d)
            warnings.warn(f"checkpoint {d} is corrupt ({type(e).__name__}: {e}); "
                          f"quarantined to {q}, falling back to the previous serial",
                          stacklevel=2)
            continue
        params_from_numpy(scope or global_scope(), arrays, dev)
        _count_if_resharded(world)
        return args


# --------------------------------------------------------- sharded checkpoints --
# The JAX package's layout (paddle_tpu/io.py:854-1104), so a sharded
# checkpoint crosses between the packages both ways:
#
#   checkpoint_<serial>/
#     shards_p<process>.npz    # the slices this process owns, "<var>::<k>",
#                              # and on the chief the whole values "<var>::r"
#     manifest_p<process>.json # this process's entries
#     sharded_meta.json        # the chief's fold: per var "replicated", or
#                              # "sharded" with its global shape, dtype and
#                              # each shard's key, slice and process
#     meta.json                # written last: serial, trainer_args, hashes
#
# A scope value a mesh executor cut to this rank's slice carries its global
# shape and slice in `scope.shards` (parallel/data_parallel.py); a whole
# value is "replicated", written once, by the chief. Loading assembles
# whole host arrays from whichever world wrote them; the restoring world's
# mesh executor cuts its own slices.

SHARDED_META = "sharded_meta.json"


def save_sharded_checkpoint(dirname: str, main_program: Optional[Program] = None,
                            scope: Optional[Scope] = None) -> str:
    """Each process's slices and the chief's whole values into `dirname`
    (the layout above); every process of the group calls it."""
    from .parallel import distributed
    from .pipeline.elastic import current_world

    program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    pid, nproc = distributed.process_index(), distributed.process_count()
    names = sorted(v.name for v in program.persistables() if scope.has(v.name))
    shards = getattr(scope, "shards", {})
    meta: Dict[str, Any] = {"vars": {}, "num_processes": nproc, "world": current_world()}
    local: Dict[str, np.ndarray] = {}
    for n in names:
        info = shards.get(n)
        if info is None:  # whole: the chief saves one copy
            meta["vars"][n] = {"kind": "replicated"}
            if pid == 0:
                local[f"{n}::r"] = _host(scope.get(n))
            continue
        entries = []
        host = _host(scope.get(n))
        if info["owner"]:  # exactly one owner a slice
            key = f"{n}::0"
            local[key] = host
            entries.append({"key": key, "slice": [list(x) for x in info["slice"]],
                            "process": pid})
        meta["vars"][n] = {"kind": "sharded", "shape": list(info["shape"]),
                           "dtype": np.dtype(host.dtype).name, "shards": entries}
    # a reused dirname must not leak a previous save's files into this one
    for stale in (f"shards_p{pid}.npz", f"manifest_p{pid}.json"):
        path = os.path.join(dirname, stale)
        if os.path.exists(path):
            os.remove(path)
    if pid == 0 and os.path.exists(os.path.join(dirname, SHARDED_META)):
        os.remove(os.path.join(dirname, SHARDED_META))
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **local)
        if faults.fire("ckpt.write", shard=pid) == "corrupt":
            with open(tmp, "r+b") as f:
                f.truncate(max(os.path.getsize(tmp) // 2, 1))
        os.replace(tmp, os.path.join(dirname, f"shards_p{pid}.npz"))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    with open(os.path.join(dirname, f"manifest_p{pid}.json"), "w") as f:
        json.dump(meta, f)
    # the chief folds every process's entries only after all have written
    if nproc > 1:
        distributed.barrier()
    if pid == 0:
        _fold_sharded_manifests(dirname, meta)
    if nproc > 1:
        distributed.barrier()  # nobody leaves before sharded_meta.json exists
    return dirname


def _fold_sharded_manifests(dirname: str, chief_meta: Dict[str, Any]) -> None:
    """The chief merges every process's shard entries into
    sharded_meta.json; a missing expected manifest is an error."""
    merged = json.loads(json.dumps(chief_meta))
    nproc = chief_meta["num_processes"]
    for p in range(1, nproc):
        path = os.path.join(dirname, f"manifest_p{p}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"sharded save: manifest for process {p}/{nproc} missing ({path}) — did the "
                "save barrier run on every process?")
        with open(path) as f:
            other = json.load(f)
        for var, info in other["vars"].items():
            if info.get("kind") == "sharded":
                mine = merged["vars"].setdefault(var, info)
                if mine is not info:
                    mine["shards"].extend(info["shards"])
    _write_json_atomic(os.path.join(dirname, SHARDED_META), merged)


def _shard_processes(meta) -> set:
    return {0} | {e["process"] for info in meta.get("vars", {}).values()
                  if info.get("kind") == "sharded" for e in info.get("shards", [])}


# a torn zip surfaces at open or at member access, as a container error
# (BadZipFile, a short read) or an npy payload error (ValueError)
_SHARD_READ_ERRORS = (OSError, ValueError, EOFError, zipfile.BadZipFile)


def _read_shard(files, process: int, key: str, dirname: str) -> np.ndarray:
    try:
        return files[process][key]
    except KeyError as e:
        raise CheckpointCorruptError(
            f"{dirname}: shards_p{process}.npz is missing member {key!r} (truncated or "
            "stale shard file)") from e
    except _SHARD_READ_ERRORS as e:
        raise CheckpointCorruptError(
            f"{dirname}: shard {key!r} in shards_p{process}.npz is unreadable "
            f"({type(e).__name__}: {e})") from e


def _assemble_sharded(dirname: str, main_program: Optional[Program] = None):
    """({name: whole host array}, the saving world) of a sharded
    checkpoint, every value read before any is handed on: a torn shard
    file or a missing member raises CheckpointCorruptError naming it, and
    a slice no shard covers raises too."""
    with open(os.path.join(dirname, SHARDED_META)) as f:
        meta = json.load(f)
    if main_program is not None:
        keep = {v.name for v in main_program.persistables()}
        meta["vars"] = {n: i for n, i in meta["vars"].items() if n in keep}
    files = {}
    try:
        for p in sorted(_shard_processes(meta)):
            fname = f"shards_p{p}.npz"
            try:
                files[p] = np.load(os.path.join(dirname, fname))
            except _SHARD_READ_ERRORS as e:
                raise CheckpointCorruptError(f"{dirname}: shard file {fname} is unreadable "
                                             f"({type(e).__name__}: {e})") from e
        staging: Dict[str, np.ndarray] = {}
        for var, info in meta["vars"].items():
            if info["kind"] == "replicated":
                staging[var] = _read_shard(files, 0, f"{var}::r", dirname)
                continue
            out = np.zeros(info["shape"], np.dtype(info["dtype"]))
            covered = np.zeros(info["shape"], bool)
            for e in info["shards"]:
                sl = tuple(slice(a, b) for a, b in e["slice"])
                out[sl] = _read_shard(files, e["process"], e["key"], dirname)
                covered[sl] = True
            if not covered.all():
                raise CheckpointCorruptError(
                    f"sharded checkpoint: {var} has uncovered slices "
                    f"({int((~covered).sum())} of {covered.size} elements) — incomplete save?")
            staging[var] = out
    finally:
        for f in files.values():
            f.close()
    return staging, meta.get("world")


def _count_if_resharded(world) -> None:
    """A restore into another world than the saving one is counted
    (pipeline/elastic.py's pt_ckpt_reshard_total)."""
    if not world:
        return
    from .pipeline.elastic import count_reshard, current_world

    cur = current_world()
    if any(int(world.get(k, v)) != v for k, v in cur.items()):
        count_reshard()


def load_sharded_checkpoint(dirname: str, main_program: Optional[Program] = None,
                            scope: Optional[Scope] = None, device=None) -> List[str]:
    """The whole values of a sharded checkpoint directory into `scope` on
    `device` (default: the card); returns their names. A mesh executor
    cuts them to its ranks' slices on its next run."""
    arrays, world = _assemble_sharded(dirname, main_program)
    params_from_numpy(scope or global_scope(), arrays, resolve_device(device))
    _count_if_resharded(world)
    return list(arrays)


def clean_checkpoint(checkpoint_dir: str) -> None:
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
