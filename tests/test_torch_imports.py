"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package (``repro.*`` imports run
``repro/compat.py``, which imports jax), and the port's entry points do
not fall back to the CPU when no device is named and there is no CUDA.
"""
from __future__ import annotations

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for name in ("repro_torch.kernels.quantize", "repro_torch.serve.kv_cache",
                 "repro_torch.kernels.quantize_ef",
                 "repro_torch.kernels.topk_mask",
                 "repro_torch.core.grad_sync",
                 "repro_torch.core.compression.fused",
                 "repro_torch.core.collectives.api",
                 "repro_torch.launch.train", "repro_torch.launch.dist",
                 "repro_torch.api", "repro_torch.optim.adam",
                 "repro_torch.data.pipeline",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.configs.gemma2_9b",
                 "repro_torch.configs.gemma3_4b",
                 "repro_torch.core.parallelism", "repro_torch.core.pipeline",
                 "repro_torch.core.schedule.cost",
                 "repro_torch.core.schedule.topology",
                 "repro_torch.core.schedule.perf_model",
                 "repro_torch.core.schedule.planner",
                 "repro_torch.launch.report", "repro_torch.launch.paths"):
        assert name in mods, name
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_entry_points_refuse_cpu_without_a_device(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serve import Engine, ServeConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(reduced(get_config("gemma-2b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, None, ServeConfig(max_batch=1, max_len=8, page_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "2", "--prompt-len", "4"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--batch", "2",
                    "--seq", "16"])
    # an explicit CPU device is honoured
    params = model.init(device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
