"""Checkpoint/resume for the trainer: the counterpart of
``rocnrdma_tpu/parallel/checkpoint.py``, in its format.

One ``.npz`` of path-flattened leaves plus metadata:

- ``params/<path>``: every parameter, keyed by its path in the
  flax-shaped tree, so the ``params/...`` keys are the JAX
  checkpoint's for the same model;
- ``opt/<state>/<path>``: the ``torch.optim.AdamW`` state of each
  parameter (``exp_avg``, ``exp_avg_sq`` and its ``step``);
- every leaf whole: the trainer hands each one over
  (``trainer._ckpt_leaf(name, what)``) and takes it back
  (``trainer._ckpt_load(name, what, whole)``), so a meshed trainer
  assembles its blocks and splits them again, and its file is the one a
  single-device trainer writes at the same state;
- ``__meta__/step``, ``__meta__/config`` (the config name) and
  ``__meta__/version``;
- a bf16 leaf is stored bit-exact as ``uint16`` beside a
  ``__dtype__/<key>`` tag holding ``bfloat16``, as the JAX package
  stores its ``ml_dtypes`` leaves. The bits go through torch
  (``view(torch.int16)``), so no ``ml_dtypes`` is needed.

The file is written to ``<path>.tmp.npz`` one leaf at a time (each
leaf copied to the host, written, dropped: the host holds one leaf, not
the whole state) and published with ``os.replace``. Restore copies
every leaf back into the trainer's tensors in place, on their device,
bit for bit, creating an optimizer state that is missing in AdamW's own
layout. The ``ckpt.save`` and ``ckpt.restore`` trace events carry
the seconds spent copying between device and host (``d2h_s`` /
``h2d_s``) and on the file (``write_s`` / ``read_s``).
"""

from __future__ import annotations

import os
import time
import zipfile
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..models.llama import flax_tree, param_names
from ..utils.trace import trace

__all__ = ["checkpoint_file", "save_checkpoint", "restore_checkpoint",
           "load_adamw_state"]

_FORMAT_VERSION = 1
_OPT_KEYS = ("exp_avg", "exp_avg_sq", "step")
_TAGGED = {torch.bfloat16: "bfloat16"}


def checkpoint_file(path: str) -> str:
    """The on-disk file a checkpoint ``path`` resolves to — the one
    normalization save/restore/existence checks must share."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten_with_paths(tree, prefix: str = ""
                        ) -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nested dict in sorted-key order, as
    ``jax.tree_util.tree_flatten_with_path`` walks a dict."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        node = tree[key]
        if isinstance(node, dict):
            yield from _flatten_with_paths(node, path)
        else:
            yield path, node


def _paths(trainer) -> List[Tuple[str, str]]:
    """(path, state-dict name) of every parameter, in the file's
    order."""
    names = param_names(trainer.cfg.n_layers)
    return list(_flatten_with_paths(flax_tree((n, n) for n in names)))


def _named_leaves(trainer) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor a checkpoint holds, by key: the parameters, then
    each parameter's AdamW state; each made when it is reached."""
    paths = _paths(trainer)
    for path, name in paths:
        yield f"params/{path}", trainer._ckpt_leaf(name, "param")
    for what in _OPT_KEYS:
        for path, name in paths:
            leaf = trainer._ckpt_leaf(name, what)
            if leaf is not None:
                yield f"opt/{what}/{path}", leaf


def load_adamw_state(opt: torch.optim.Optimizer, p: torch.Tensor,
                     what: str, value: torch.Tensor) -> None:
    """Copy ``value`` into ``p``'s AdamW state ``what`` in place; a
    state the optimizer has not made yet is made in AdamW's own layout
    (an uncaptured step lives on the host)."""
    state: Dict[str, torch.Tensor] = opt.state[p]
    if what not in state:
        group = opt.param_groups[0]
        on_card = what != "step" or group.get("capturable") or group.get(
            "fused")
        state[what] = torch.empty(value.shape, dtype=value.dtype,
                                  device=p.device if on_card else "cpu")
    state[what].copy_(value)


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as a host array: tagged dtypes as their raw bits."""
    t = t.detach().cpu()
    tag = _TAGGED.get(t.dtype)
    if tag is not None:
        return t.view(torch.int16).numpy().view(np.uint16), tag
    return t.numpy(), ""


def _decode(arr: np.ndarray, tag: str) -> torch.Tensor:
    if not tag:
        return torch.from_numpy(arr)
    dtype = {v: k for k, v in _TAGGED.items()}.get(tag)
    if dtype is None:
        raise ValueError(f"checkpoint leaf has unknown dtype tag {tag!r}")
    return torch.from_numpy(arr.view(np.int16)).view(dtype)


def _write(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asarray(arr), allow_pickle=False)


def save_checkpoint(path: str, trainer, step: int) -> None:
    """Write params + optimizer state + step to ``path`` (.npz)."""
    path = checkpoint_file(path)
    tmp = path + ".tmp.npz"
    d2h_s = write_s = 0.0
    # np.savez's layout (stored .npy members), written leaf by leaf.
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _named_leaves(trainer):
            t0 = time.perf_counter()
            arr, tag = _encode(leaf)
            t1 = time.perf_counter()
            _write(zf, key, arr)
            d2h_s += t1 - t0
            write_s += time.perf_counter() - t1
            if tag:
                _write(zf, f"__dtype__/{key}",
                       np.frombuffer(tag.encode(), dtype=np.uint8))
        _write(zf, "__meta__/step", np.asarray(step, dtype=np.int64))
        _write(zf, "__meta__/config",
               np.frombuffer(trainer.cfg.name.encode(), dtype=np.uint8))
        _write(zf, "__meta__/version", np.asarray(_FORMAT_VERSION))
    os.replace(tmp, path)  # atomic publish — no torn checkpoints
    trace.event("ckpt.save", path=path, step=step, d2h_s=d2h_s,
                write_s=write_s)


def restore_checkpoint(path: str, trainer) -> int:
    """Restore params and optimizer state in place onto the trainer's
    tensors; sets and returns the step."""
    path = checkpoint_file(path)
    with np.load(path) as z:
        cfg_name = bytes(z["__meta__/config"]).decode()
        if cfg_name != trainer.cfg.name:
            raise ValueError(
                f"checkpoint is for config {cfg_name!r}, trainer is "
                f"{trainer.cfg.name!r}")
        step = int(z["__meta__/step"])
        read_s = 0.0

        def load(key: str) -> torch.Tensor:
            nonlocal read_s
            if key not in z:
                raise ValueError(f"checkpoint missing leaf {key}")
            t0 = time.perf_counter()
            tag_key = f"__dtype__/{key}"
            tag = bytes(z[tag_key]).decode() if tag_key in z else ""
            leaf = _decode(z[key], tag)
            read_s += time.perf_counter() - t0
            return leaf

        t_start = time.perf_counter()
        for path_, name in _paths(trainer):
            trainer._ckpt_load(name, "param", load(f"params/{path_}"))
            for what in _OPT_KEYS:
                trainer._ckpt_load(name, what, load(f"opt/{what}/{path_}"))
        h2d_s = time.perf_counter() - t_start - read_s
    trainer.global_step = step
    trace.event("ckpt.restore", path=path, step=step, read_s=read_s,
                h2d_s=h2d_s)
    return step
