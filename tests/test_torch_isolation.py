"""The PyTorch port stands alone: it imports neither jax nor any part of
paddle_tpu, and its entry points refuse to run on the CPU unless asked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as ptt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def test_import_pulls_in_no_jax_and_no_paddle_tpu():
    """Every module of the package, imported in a fresh process."""
    code = (
        "import importlib, pkgutil, sys, paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'paddle_tpu_torch.models.text', 'paddle_tpu_torch.models.transformer',\n"
        "        'paddle_tpu_torch.ops.flash_kernels', 'paddle_tpu_torch.layers.attention',\n"
        "        'paddle_tpu_torch.models.image', 'paddle_tpu_torch.ops.fused_conv_kernels',\n"
        "        'paddle_tpu_torch.ops.fused_conv_ops', 'paddle_tpu_torch.trainer',\n"
        "        'paddle_tpu_torch.data.reader', 'paddle_tpu_torch.data.feeder',\n"
        "        'paddle_tpu_torch.obs.trace', 'paddle_tpu_torch.obs.metrics',\n"
        "        'paddle_tpu_torch.profiler', 'paddle_tpu_torch.resilience.faults',\n"
        "        'paddle_tpu_torch.resilience.guard'}"
        " <= set(sys.modules)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax_and_no_paddle_tpu(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), f"{path} imports {mod}"


def test_entry_points_need_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.io.load_inference_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.Trainer(ptt.Program().global_block().create_var("loss", ()),
                    main_program=ptt.Program(), startup_program=ptt.Program())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.data.DevicePrefetcher(lambda: iter(()))
    assert ptt.Executor(device="cpu").device.type == "cpu"


def test_executor_refuses_params_on_another_device():
    prog = ptt.Program()
    prog.global_block().create_var("w", (2,), persistable=True)
    scope = ptt.Scope()
    scope.set("w", torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="executor's device"):
        ptt.Executor(device="cpu").run(prog, {}, ["w"], scope=scope)
