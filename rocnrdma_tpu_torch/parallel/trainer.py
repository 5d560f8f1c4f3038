"""Single-card Llama training: the counterpart of the fused train step
of ``rocnrdma_tpu/parallel/trainer.py``.

One :class:`Trainer` owns a :class:`~rocnrdma_tpu_torch.models.llama.Llama`
on one device and an AdamW optimizer configured as the JAX trainer's
``optax.adamw(learning_rate, weight_decay=weight_decay)``: betas
(0.9, 0.999), eps 1e-8, decoupled weight decay on every parameter, and
moments in each parameter's dtype (optax's ``mu_dtype=None``). A
:meth:`Trainer.step` is the JAX ``full_step``: next-token cross entropy,
its gradients through the model's kernels (K1-K5 on the card), one
AdamW update, inside the ``trainer.fused_step`` trace span.

With ``cross_slice_sync`` (a callable, typically
:class:`~rocnrdma_tpu_torch.collectives.torch_shim.CrossSliceAllReduce`)
a step is the JAX trainer's ``_step_once`` across data-parallel slices:
the gradients (``trainer.grads`` / ``trainer.backward``), then the sync
of the gradient tree (``trainer.sync``), shaped like
:func:`~rocnrdma_tpu_torch.models.llama.params_to_flax`'s tree
(``{"params": {"embed": {"embedding": g}, "layer_0": {...}, ...}}``)
with the tensors left on their device, then the AdamW update of the
reduced gradients (``trainer.apply``). The first sync is stamped with
the step number (``set_step_token``), so ranks at different steps fail
the schedule digest instead of averaging different batches.

The sync runs in one of the JAX trainer's three modes: the fused call;
with ``overlap`` (a sync exposing ``start``), ``start(grads)`` inside
``trainer.grads`` right after the backward and ``finish()`` in
``trainer.sync``; with ``per_layer`` (a sync exposing
``start_layered``), ``start_layered(layer_plan)`` before the backward,
each bucket pushed from the backward by post-accumulate-grad hooks the
moment its last parameter's gradient has accumulated, and
``finish(grads)`` in ``trainer.sync``. ``layer_plan`` has one bucket
per top-level key of the flax-shaped tree, sorted (``embed``,
``final_norm``, ``layer_0``, ``layer_1``, ``layer_10``, ...,
``lm_head``), each listing its leaves' (numel, dtype) in tree order:
the JAX trainer's plan for the same model.

What else the JAX trainer does across devices and hosts is not ported
yet, and asking for it raises ``NotImplementedError`` naming the
ROADMAP item that ports it: ``elastic`` (Queue 1 item 2b, entry 5),
``seq_parallel`` (item 3) and any mesh of more than one device (item 5).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Union

import torch

from .. import DeviceLike, resolve_device
from ..collectives.torch_shim import tree_flatten
from ..models.llama import (CONFIGS, Llama, LlamaConfig, _flax_path,
                            cross_entropy_loss, init_params)
from ..transport.engine import dtype_name
from ..utils.trace import trace

__all__ = ["loss_fn", "Trainer"]


def loss_fn(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy on (B, S) token ids."""
    logits = model(tokens[:, :-1])
    return cross_entropy_loss(logits, tokens[:, 1:])


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to rocnrdma_tpu_torch yet (ROADMAP.md "
        f"Queue 1, {item})")


class Trainer:
    """Single-process Llama trainer on one device.

    ``config`` is a config name or a :class:`LlamaConfig`;
    ``model_overrides`` replace its fields (e.g. ``remat=True``,
    ``dtype=torch.float32``). The weights are ``params`` (a state dict,
    e.g. from :func:`~rocnrdma_tpu_torch.models.llama.params_from_flax`)
    or else :func:`~rocnrdma_tpu_torch.models.llama.init_params` at
    ``seed``. ``mesh_shape`` may only describe one device."""

    def __init__(self, config: Union[LlamaConfig, str],
                 mesh_shape: Optional[Dict[str, int]] = None,
                 learning_rate: float = 3e-4, weight_decay: float = 0.1,
                 cross_slice_sync=None, seed: int = 0, seq_parallel=None,
                 elastic=None, device: DeviceLike = "cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 **model_overrides) -> None:
        if elastic is not None:
            raise _not_ported("elastic (ElasticPolicy resume)",
                              "item 2b, entry 5")
        if seq_parallel is not None:
            raise _not_ported("seq_parallel (ring attention / Ulysses)",
                              "item 3")
        n_dev = 1
        for size in (mesh_shape or {}).values():
            n_dev *= int(size)
        if n_dev != 1:
            raise _not_ported(f"a mesh of {n_dev} devices ({mesh_shape})",
                              "item 5")
        cfg = CONFIGS[config] if isinstance(config, str) else config
        self.cfg = dataclasses.replace(cfg, **model_overrides)
        self.device = resolve_device(device)
        self.model = Llama(self.cfg, self.device)
        if params is None:
            self.model.load_state_dict(
                init_params(self.cfg, seed, self.device), assign=True)
        else:
            # A plain dict drops the ``_metadata`` of a state dict: once
            # that dict went through ``load_state_dict(..., assign=True)``
            # its metadata says "assign", and loading it again would make
            # these parameters share (and train) the caller's tensors.
            self.model.load_state_dict(dict(params))
        self.opt = torch.optim.AdamW(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay)
        self.global_step = 0
        self.cross_slice_sync = cross_slice_sync
        self._stamp_sync = cross_slice_sync is not None
        # Host ms of the last synced step's phases (grads, sync, apply),
        # each ending with the card idle.
        self.last_split: Dict[str, float] = {}
        self._per_layer = bool(getattr(cross_slice_sync, "per_layer", False)
                               and hasattr(cross_slice_sync,
                                           "start_layered"))
        self._pending_layers = None
        if self._per_layer:
            inner = self._param_tree(lambda p: p)["params"]
            self._buckets = [tree_flatten(inner[k])[0]
                             for k in sorted(inner)]
            self.layer_plan = [
                (k, [(p.numel(), dtype_name(p)) for p in ps])
                for k, ps in zip(sorted(inner), self._buckets)]
            for idx, ps in enumerate(self._buckets):
                for p in ps:
                    p.register_post_accumulate_grad_hook(
                        functools.partial(self._grad_ready, idx))

    def _param_tree(self, leaf) -> Dict[str, object]:
        """``leaf(p)`` of every parameter in the flax-shaped tree."""
        tree: Dict[str, object] = {}
        for name, p in self.model.named_parameters():
            path = _flax_path(name)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf(p)
        return {"params": tree}

    def grads_tree(self) -> Dict[str, object]:
        """The parameters' gradients as the flax-shaped tree the sync
        takes, the tensors left where they are."""
        return self._param_tree(lambda p: p.grad)

    def _grad_ready(self, idx: int, _param) -> None:
        """Post-accumulate-grad hook: push bucket ``idx`` to the step's
        pending sync once the last of its parameters' gradients has
        accumulated. Runs inside the backward (on the card, on
        autograd's device thread), so it never raises: ``push`` keeps
        failures for ``finish()``."""
        pending = self._pending_layers
        if pending is None:
            return  # a backward outside a per-layer step
        self._left[idx] -= 1
        if self._left[idx] == 0:
            pending.push(idx, [p.grad for p in self._buckets[idx]])

    def _set_grads(self, tree) -> None:
        """Write a synced tree back into ``p.grad`` (in place where the
        sync returned other tensors than it was given)."""
        for name, p in self.model.named_parameters():
            node = tree["params"]
            for key in _flax_path(name):
                node = node[key]
            if node is not p.grad:
                p.grad.copy_(torch.as_tensor(node))

    def _mark(self, phase: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.last_split[phase] = (now - t0) * 1e3
        return now

    def _synced_step(self, tokens: torch.Tensor, step_no: int):
        if self._stamp_sync:
            stamp = getattr(self.cross_slice_sync, "set_step_token", None)
            if stamp is not None:
                stamp(self.global_step)
            self._stamp_sync = False
        sync = self.cross_slice_sync
        overlap = getattr(sync, "overlap", False) and hasattr(sync, "start")
        pending = None
        t0 = time.perf_counter()
        with trace.span("trainer.grads", step=step_no):
            self.opt.zero_grad(set_to_none=True)
            if self._per_layer:
                # The hooks push each bucket from inside the backward,
                # so its wire rides under the rest of the backward.
                pending = sync.start_layered(self.layer_plan)
                self._left = [len(ps) for ps in self._buckets]
                self._pending_layers = pending
            try:
                with trace.span("trainer.backward", step=step_no):
                    loss = loss_fn(self.model, tokens)
                    loss.backward()
            finally:
                self._pending_layers = None
            if overlap and pending is None:
                pending = sync.start(self.grads_tree())
            t0 = self._mark("grads_ms", t0)
        # The cross-slice hop: the gradients averaged across slices.
        with trace.span("trainer.sync", step=step_no):
            if self._per_layer:
                tree = pending.finish(self.grads_tree())
            elif pending is not None:
                tree = pending.finish()
            else:
                tree = sync(self.grads_tree())
            self._set_grads(tree)
            t0 = self._mark("sync_ms", t0)
        with trace.span("trainer.apply", step=step_no):
            self.opt.step()
            self._mark("apply_ms", t0)
        return loss

    def step(self, tokens) -> float:
        """One optimizer step on (B, S) token ids; returns the loss
        before the update."""
        tokens = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        step_no = self.global_step + 1
        if self.cross_slice_sync is not None:
            loss = self._synced_step(tokens, step_no)
        else:
            with trace.span("trainer.fused_step", step=step_no):
                self.opt.zero_grad(set_to_none=True)
                loss = loss_fn(self.model, tokens)
                loss.backward()
                self.opt.step()
        self.global_step = step_no
        value = float(loss.detach())
        trace.event("trainer.step", loss=value, step=step_no)
        return value
