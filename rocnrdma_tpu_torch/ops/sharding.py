"""Per-position dispatch of the kernel ops under an intra-slice mesh.

Counterpart of ``rocnrdma_tpu/ops/sharding.py``. GSPMD has no
partitioning rule for ``pallas_call``, so the JAX package runs each
kernel as a ``shard_map`` manual region: every device runs the
unmodified kernel on its local block (batch rows on ``dp``, heads on
``tp``, sequence and features local) and no collective is needed
inside the region. Here there is no partitioner to hide from: the
meshed model (:mod:`rocnrdma_tpu_torch.models.llama_mesh`) holds one
block per mesh position already, and :func:`run_sharded` calls the op
once per position on that position's device, with the same three cases
as the JAX function:

- no mesh, or a mesh of one position: the plain local call;
- the geometry divides (:func:`rms_ok`, :func:`attn_ok`): the
  unmodified kernel op (K1, or K3-K5 through the attention's autograd
  function) on each position's block, on its device;
- it does not divide: the caller's mesh-wide fallback, which for
  attention gathers the layer's weights from their shards and runs the
  layer whole on every tp position, still through the kernels. That is
  the counterpart of the JAX trainer pinning such a mesh's attention to
  the XLA path (``rocnrdma_tpu/parallel/trainer.py:189-229``).

On the card every position's call launches the kernels; on the CPU the
ops run their plain versions, as everywhere in the port.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["rms_ok", "attn_ok", "on_positions", "run_sharded"]


def rms_ok(mesh) -> bool:
    """RMSNorm splits over rows, which needs only the ``dp`` axis."""
    return "dp" in mesh.shape


def attn_ok(mesh, n_heads: int, n_kv_heads: int) -> bool:
    """Attention splits over heads when the query and the kv heads both
    divide ``tp``: local q heads ``[t·H/tp, (t+1)·H/tp)`` then meet
    exactly the local kv heads ``[t·KVH/tp, (t+1)·KVH/tp)``, so every
    GQA group stays whole on one position."""
    tp = mesh.shape.get("tp")
    return (rms_ok(mesh) and tp is not None and n_heads % tp == 0
            and n_kv_heads % tp == 0)


def _on(device: torch.device):
    """The device guard of a position: kernels launched through the
    ops' C entry points run on the current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def on_positions(mesh, fn: Callable, args: Sequence[tuple]) -> List:
    """``fn(*args[p])`` for every position ``p``, on its device."""
    out = []
    for dev, a in zip(mesh.device_list, args):
        with _on(dev):
            out.append(fn(*a))
    return out


def run_sharded(mesh, local_fn: Callable, args: Sequence[tuple],
                fits: bool,
                fallback_fn: Optional[Callable] = None) -> List:
    """The one dispatch shared by the kernel ops (module docstring).
    ``args`` holds one argument tuple per position; ``fallback_fn``
    takes them all and returns one result per position."""
    if mesh is None or mesh.size <= 1:
        return [local_fn(*args[0])]
    if fits:
        return on_positions(mesh, local_fn, args)
    return fallback_fn(args)
