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

What the JAX trainer does across devices and hosts is not ported yet,
and asking for it raises ``NotImplementedError`` naming the ROADMAP
item that ports it: ``cross_slice_sync`` and ``elastic`` (Queue 1 item
2, the transport and the DP trainer), ``seq_parallel`` (item 3) and any
mesh of more than one device (item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from .. import DeviceLike, resolve_device
from ..models.llama import (CONFIGS, Llama, LlamaConfig, cross_entropy_loss,
                            init_params)
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
        if cross_slice_sync is not None:
            raise _not_ported("cross_slice_sync (the cross-slice gradient "
                              "allreduce)", "item 2")
        if elastic is not None:
            raise _not_ported("elastic (ElasticPolicy resume)", "item 2")
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

    def step(self, tokens) -> float:
        """One optimizer step on (B, S) token ids; returns the loss
        before the update."""
        tokens = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        step_no = self.global_step + 1
        with trace.span("trainer.fused_step", step=step_no):
            self.opt.zero_grad(set_to_none=True)
            loss = loss_fn(self.model, tokens)
            loss.backward()
            self.opt.step()
        self.global_step = step_no
        value = float(loss.detach())
        trace.event("trainer.step", loss=value, step=step_no)
        return value
