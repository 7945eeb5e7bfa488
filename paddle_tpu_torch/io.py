"""Saved programs and state passing between the JAX package and the port.

An inference artifact (what paddle_tpu.io.save_inference_model writes) is a
directory holding `program.json` (Program.to_dict), `params.npz` (one array
per parameter name) and `meta.json` (feed, fetch and parameter names plus
optional sidecars). A training program is a directory holding `main.json`
and `startup.json` (Program.to_dict of each) and `meta.json` (feed, loss
and parameter names, the widths, the amp dtype). State — parameters and
optimizer persistables alike — crosses as numpy arrays by name.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .core.executor import Scope, global_scope
from .core.place import resolve_device
from .core.program import Program

PARAMS_FILE = "params.npz"
PROGRAM_FILE = "program.json"
META_FILE = "meta.json"
MAIN_FILE = "main.json"
STARTUP_FILE = "startup.json"

# sidecars that change how the artifact must run; the port cannot honour
# them yet, so it refuses the artifact rather than serve it wrongly
_UNSUPPORTED_SIDECARS = ("quant", "sharding", "draft_model")


def params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray], device) -> None:
    """Carry state given as numpy arrays by name (the JAX package's scope
    values, or an npz) into `scope` as tensors on `device`, bit for bit:
    parameters, and the optimizer's persistables (moments, beta powers,
    learning rate) alike."""
    dev = torch.device(device)
    for name, a in arrays.items():
        # a copy: the JAX package's arrays are read-only
        scope.set(name, torch.as_tensor(np.array(a, order="C"), device=dev))


def state_to_numpy(scope: Scope, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The reverse of params_from_numpy: the named scope values as numpy
    arrays (bf16 values widen to f32, which numpy has)."""
    out = {}
    for n in names:
        t = scope.get(n).detach()
        out[n] = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return out


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
    `Executor(device).run(program, feed, fetch_list, scope)` runs it."""
    dev = resolve_device(device)
    scope = scope or global_scope()
    with open(os.path.join(dirname, META_FILE)) as f:
        meta = json.load(f)
    present = [k for k in _UNSUPPORTED_SIDECARS if meta.get(k)]
    if present:
        raise NotImplementedError(
            f"{dirname}: the artifact carries the sidecar(s) {present}, "
            "which the PyTorch port does not support yet")
    # meta["tuning"] records which TPU table the exporter's kernels were
    # tuned with; it says nothing about this card, so it is skipped on purpose
    with open(os.path.join(dirname, PROGRAM_FILE)) as f:
        program = Program.from_dict(json.load(f))
    path = os.path.join(dirname, PARAMS_FILE)
    # materialize every array before touching the scope, so a bad file
    # never leaves the scope half-updated
    with np.load(path) as data:
        missing = [n for n in meta["param_names"] if n not in data]
        if missing:
            raise KeyError(f"variables {missing} not found in {path}")
        arrays = {n: data[n] for n in meta["param_names"]}
    params_from_numpy(scope, arrays, dev)
    return program, meta["feed_names"], meta["fetch_names"]
