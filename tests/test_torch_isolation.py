"""The port stands alone, and runs on the card unless told otherwise.

- ``rocnrdma_tpu_torch`` and every submodule import in a fresh process
  where ``jax`` is unimportable and an import hook refuses
  ``rocnrdma_tpu`` and its submodules;
- no module of the port, not ``chip_smoke.py`` and not the port's
  example names JAX, flax or the JAX package in an import statement;
- on a host without CUDA, every entry point called without ``device=``
  raises instead of running on the CPU, and ``chip_smoke.py`` exits
  non-zero without printing its result — in the repo, and alone in an
  empty directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rocnrdma_tpu_torch
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from rocnrdma_tpu_torch.serving import model as tmodel
from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "rocnrdma_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "rocnrdma_tpu")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

FORBIDDEN = %r

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.modules["jax"] = None
import rocnrdma_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    rocnrdma_tpu_torch.__path__, "rocnrdma_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [n for n, m in sys.modules.items()
          if m is not None and n.split(".")[0] in FORBIDDEN]
print("IMPORTED", len(names), "LEAKED", leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")


def test_package_imports_with_jax_and_reference_refused():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT % (FORBIDDEN,)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1].split()
    assert last[0] == "IMPORTED" and int(last[1]) >= 10, proc.stdout
    assert proc.stdout.strip().endswith("LEAKED []"), proc.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "examples/train_single_chip_torch.py"]))
def test_no_import_of_jax_or_the_reference(path):
    roots = set(_imported_roots(REPO / path))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def _serve_cfg():
    return tmodel.ServeConfig(vocab_size=16, d_model=8, n_layers=1,
                              n_heads=2, n_kv_heads=1, d_ff=16,
                              max_seq_len=8)


def _cpu_generate_without_device():
    model = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    model.load_state_dict(tllama.init_params(tllama.LLAMA_TINY, 0, "cpu"))
    tllama.generate(model, [[1, 2]], 2)


ENTRY_POINTS = {
    "resolve_device": lambda: rocnrdma_tpu_torch.resolve_device(),
    "Llama": lambda: tllama.Llama(tllama.LLAMA_TINY),
    "init_params": lambda: tllama.init_params(tllama.LLAMA_TINY, 0),
    "init_cache": lambda: tllama.init_cache(tllama.LLAMA_TINY, 1),
    "generate": _cpu_generate_without_device,
    "PagedDecoder": lambda: tmodel.PagedDecoder(_serve_cfg()),
    "Trainer": lambda: Trainer("llama-tiny"),
    "ContinuousBatcher": lambda: ContinuousBatcher(
        None, tmodel.pack_pages(_serve_cfg(),
                                tmodel.toy_param_tree(_serve_cfg())),
        _serve_cfg()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ENTRY_POINTS[name]()


def test_cpu_is_taken_only_when_asked():
    assert rocnrdma_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        rocnrdma_tpu_torch.resolve_device("meta")
    d = tmodel.PagedDecoder(_serve_cfg(), device="cpu")
    assert d.new_cache()["k"].device.type == "cpu"
    assert np.isfinite(d._cos.numpy()).all()


def _run_chip_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})


def test_chip_smoke_fails_without_cuda(no_cuda):
    proc = _run_chip_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_fails_alone(no_cuda, tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
