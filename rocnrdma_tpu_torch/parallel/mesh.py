"""Device mesh, sharding rules and the cross-position operations of the
intra-slice dp × tp mesh.

Counterpart of ``rocnrdma_tpu/parallel/mesh.py``. The JAX package picks
a mesh, annotates shardings (the batch on ``dp``; heads, ffn and vocab
on ``tp``) and lets XLA insert the collectives. PyTorch has no
partitioner, so here the program runs one block per mesh position and
calls the collectives itself: :class:`Mesh` holds the axis names, their
sizes and one torch device per position, the spec functions are the
JAX rules verbatim (a spec is a plain tuple of axis names or ``None``
per dimension), and the cross-position operations below are what XLA
would insert.

A mesh may name one device more than once: ``make_mesh({"dp": 2, "tp":
2}, ["cpu"] * 4)`` or ``["cuda:0"] * 4`` runs every position's work,
every cross-position sum and gather and the sharded optimizer update
on that one device. It is the counterpart of the JAX test suite's
forced host device count (``--xla_force_host_platform_device_count``);
only the copies between cards are then left out.

The cross-position operations take and return lists of per-position
tensors and are differentiable. Every sum adds its terms in position
order, accumulating in f32 on the first term's device and rounding
once to the terms' dtype, so two processes running the same step get
the same bits. Every output owns its storage: ``t.to(d)`` returns ``t``
itself when ``t`` already lives on ``d``, so positions that share a
device would otherwise share (and write through) one tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device

__all__ = ["Mesh", "make_mesh", "parse_mesh", "batch_spec", "param_spec",
           "param_shardings", "replicated", "shard", "assemble", "psum",
           "all_gather", "gather", "block", "ordered_sum"]

Spec = Tuple[Optional[str], ...]


class Mesh:
    """Positions laid out on named axes, each holding a torch device.

    ``devices`` is an object array of ``torch.device`` whose shape is
    the axes' sizes in ``axis_names`` order. Positions are numbered in
    row-major order of that array (the last axis fastest)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        """Each position's device, by position."""
        return list(self.devices.reshape(-1))

    def coords(self, pos: int) -> Dict[str, int]:
        """The index of position ``pos`` on each axis."""
        idx = np.unravel_index(pos, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def groups(self, axis: str) -> List[List[int]]:
        """The positions that differ only along ``axis``, one list per
        setting of the other axes, each ordered along ``axis``."""
        ids = np.arange(self.size).reshape(self.devices.shape)
        k = self.axis_names.index(axis)
        return np.moveaxis(ids, k, -1).reshape(-1, ids.shape[k]).tolist()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.device_list})"


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh from axis name → size, e.g. ``{"dp": 2, "tp": 4}``.
    ``devices`` defaults to every visible CUDA device; an explicit list
    may name one device more than once (module docstring)."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = list(devices)
    total = int(np.prod(list(shape.values())))
    if total > len(devs):
        raise ValueError(f"mesh {shape} needs {total} devices, "
                         f"have {len(devs)}")
    arr = np.empty(total, dtype=object)
    arr[:] = [_device(d) for d in devs[:total]]
    return Mesh(arr.reshape(tuple(shape.values())), tuple(shape.keys()))


def parse_mesh(spec: str) -> Dict[str, int]:
    """``"dp=2,tp=4"`` → ``{"dp": 2, "tp": 4}`` (the examples'
    ``--mesh``)."""
    out = {}
    for part in spec.split(","):
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


def batch_spec() -> Spec:
    """Tokens (B, S): batch on dp."""
    return ("dp", None)


def param_spec(path: str) -> Spec:
    """Tensor-parallel partitioning of a Llama parameter by its flax
    path. Column-parallel (the output features sharded): wq/wk/wv,
    w_gate, w_up, lm_head. Row-parallel (the input features sharded):
    wo, w_down. The embedding shards its vocab rows. Norms
    replicate."""
    if "embed" in path:
        return ("tp", None)
    if any(k in path for k in ("wq", "wk", "wv")):
        return (None, "tp")
    if "wo" in path:
        return ("tp", None)
    if any(k in path for k in ("w_gate", "w_up")):
        return (None, "tp")
    if "w_down" in path:
        return ("tp", None)
    if "lm_head" in path:
        return (None, "tp")
    return ()  # norms and anything residual: replicated


def _leaf_spec(mesh: Mesh, path: str, shape) -> Spec:
    """``param_spec(path)``, or replicated where a sharded dimension
    does not divide its axis or the mesh lacks the axis (tiny configs
    with odd head counts)."""
    spec = param_spec(path)
    for axis, size in zip(spec, shape):
        if axis is None:
            continue
        if axis not in mesh.shape or size % mesh.shape[axis] != 0:
            return ()
    return spec


def param_shardings(mesh: Mesh, params):
    """The tree of ``params`` (nested dicts of tensors, or anything with
    a ``shape``) with each leaf replaced by its spec on ``mesh``."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + [str(k)]) for k, v in node.items()}
        return _leaf_spec(mesh, "/".join(prefix), tuple(node.shape))

    return walk(params, [])


def replicated(mesh: Mesh) -> Spec:
    return ()


# ------------------------------------------------ placement of a tensor

def _block(spec: Spec, coords: Dict[str, int], ndim: int) -> Tuple[int, ...]:
    """Which block of each dimension a position holds under ``spec``."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(0 if a is None else coords[a] for a in full)


def block(full: torch.Tensor, spec: Spec, mesh: Mesh,
          pos: int) -> torch.Tensor:
    """Position ``pos``'s block of ``full`` under ``spec``: a view."""
    t = full
    full_spec = tuple(spec) + (None,) * (full.dim() - len(spec))
    for dim, (axis, idx) in enumerate(zip(
            full_spec, _block(spec, mesh.coords(pos), full.dim()))):
        if axis is not None:
            n = full.shape[dim] // mesh.shape[axis]
            t = t.narrow(dim, idx * n, n)
    return t


def shard(full: torch.Tensor, spec: Spec, mesh: Mesh) -> List[torch.Tensor]:
    """Each position's block of ``full`` under ``spec``, a contiguous
    copy on the position's device (never a view of ``full`` or of
    another position's block). Differentiable."""
    return [block(full, spec, mesh, pos).to(
        device=dev, copy=True, memory_format=torch.contiguous_format)
        for pos, dev in enumerate(mesh.device_list)]


def assemble(blocks: Sequence[torch.Tensor], spec: Spec, mesh: Mesh,
             device) -> torch.Tensor:
    """The full tensor from one block per position under ``spec``, on
    ``device``: each block read from the first position holding it.
    Differentiable. A replicated spec returns the first position's
    tensor moved to ``device`` (itself where it lives there)."""
    ndim = blocks[0].dim()
    full_spec = tuple(spec) + (None,) * (ndim - len(spec))
    first: Dict[Tuple[int, ...], int] = {}
    for pos in range(mesh.size):
        first.setdefault(_block(spec, mesh.coords(pos), ndim), pos)

    def build(prefix: Tuple[int, ...]) -> torch.Tensor:
        dim = len(prefix)
        if dim == ndim:
            return blocks[first[prefix]].to(device)
        axis = full_spec[dim]
        n = 1 if axis is None else mesh.shape[axis]
        parts = [build(prefix + (i,)) for i in range(n)]
        return parts[0] if n == 1 else torch.cat(parts, dim)

    return build(())


# ------------------------------------------- cross-position operations

def ordered_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """x0 + x1 + ... in that order, in f32 on x0's device, rounded once
    to x0's dtype; a fresh tensor."""
    acc = xs[0].to(device=xs[0].device, dtype=torch.float32, copy=True)
    for x in xs[1:]:
        acc.add_(x.to(device=acc.device, dtype=torch.float32))
    return acc.to(xs[0].dtype)


def _copies(t: torch.Tensor, devices) -> Tuple[torch.Tensor, ...]:
    """One copy of ``t`` on each device, each owning its storage."""
    return tuple(t.to(device=d, copy=True) for d in devices)


class _Sum(torch.autograd.Function):
    """Every term receives the sum of all terms; the gradient of each
    term is the sum of the outputs' gradients."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        with record_function("mesh.psum"):
            return _copies(ordered_sum(xs), ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        with record_function("mesh.psum"):
            return _copies(ordered_sum(gs), ctx.devices)


class _AllGather(torch.autograd.Function):
    """Every term receives the concatenation of all terms along ``dim``;
    the gradient of term i is its slice of the sum of the outputs'
    gradients."""

    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        ctx.devices = [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        with record_function("mesh.all_gather"):
            full = torch.cat([x.to(xs[0].device) for x in xs], dim)
            return _copies(full, ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        with record_function("mesh.all_gather"):
            total = ordered_sum(gs)
            parts = total.split(ctx.sizes, ctx.dim)
            return (None, *(p.to(device=d, copy=True,
                                 memory_format=torch.contiguous_format)
                             for p, d in zip(parts, ctx.devices)))


class _Gather(torch.autograd.Function):
    """The terms concatenated along ``dim`` on one device; the gradient
    of term i is its slice of the output's gradient."""

    @staticmethod
    def forward(ctx, dim, device, *xs):
        ctx.dim = dim
        ctx.devices = [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        with record_function("mesh.gather"):
            return torch.cat([x.to(device) for x in xs], dim)

    @staticmethod
    def backward(ctx, g):
        with record_function("mesh.gather"):
            parts = g.split(ctx.sizes, ctx.dim)
            return (None, None, *(p.to(device=d, copy=True,
                                       memory_format=torch.contiguous_format)
                                  for p, d in zip(parts, ctx.devices)))


def _by_group(mesh: Mesh, axis: str, xs: Sequence[torch.Tensor],
              fn) -> List[torch.Tensor]:
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        if len(group) == 1:
            out[group[0]] = xs[group[0]]
            continue
        for pos, y in zip(group, fn([xs[p] for p in group])):
            out[pos] = y
    return out


def psum(xs: Sequence[torch.Tensor], mesh: Mesh,
         axis: str) -> List[torch.Tensor]:
    """Sum over ``axis``: each position receives the sum of the terms
    of the positions that differ from it only along ``axis`` (the tp
    all-reduce of a row-parallel product)."""
    return _by_group(mesh, axis, xs, lambda g: _Sum.apply(*g))


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               dim: int) -> List[torch.Tensor]:
    """Gather over ``axis``: each position receives its group's terms
    concatenated along ``dim`` in axis order (a sharded weight made
    whole on every position)."""
    return _by_group(mesh, axis, xs, lambda g: _AllGather.apply(dim, *g))


def gather(xs: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The terms concatenated along ``dim`` on ``device`` (the logits'
    vocab shards, the rows of the dp groups)."""
    if len(xs) == 1:
        return xs[0].to(device)
    return _Gather.apply(dim, torch.device(device), *xs)
