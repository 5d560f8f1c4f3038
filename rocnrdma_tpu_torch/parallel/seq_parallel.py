"""Sequence-parallel training: ring attention or Ulysses wired into the
train step.

Counterpart of ``rocnrdma_tpu/parallel/seq_parallel.py``. Long-context
training where the SEQUENCE is the partitioned axis: each rank (slice)
holds a contiguous token shard of every batch row, and attention reaches
the rest of the sequence over the transport. Everything but the
attention contraction is position-local, so per layer

    x → Block.qkv → (ring / Ulysses over the world) → Block.post

with ``Block.qkv`` and ``Block.post`` the model's own halves
(:mod:`~rocnrdma_tpu_torch.models.llama`). The attention middle is a
``torch.autograd.Function`` whose backward is the strategy's own
(:func:`~rocnrdma_tpu_torch.collectives.ring_attention.ring_attention`,
:func:`~rocnrdma_tpu_torch.collectives.ulysses.ulysses_attention`), so
the step's backward is ordinary autograd with one collective per layer,
issued in reverse layer order on every rank (the layers form a chain;
no hook calls into the world).

Under ``remat`` the two halves are checkpointed separately
(``torch.utils.checkpoint``, non-reentrant), never the attention
middle: recomputing it would post a second round of rotations, which is
not the reference's schedule.

Gradients: with L = (1/W)·Σ_r ℓ_r and each rank seeding its backward
with dℓ_r, the mean over ranks of the per-rank parameter gradients is
dL/dθ, so after the backward the gradients go through one fused
``CrossSliceAllReduce(world, mean=True)`` (CUDA gradients stage through
pinned host memory, as in data-parallel training). The loss a step
returns is the ring mean of the ranks' local means.

Positions: rank r's rope angles are those of positions
``[r * S_local, (r + 1) * S_local)``; a global length over
``max_seq_len`` raises on every rank.

Replication: every rank holds the same parameters and optimizer state
(same weights, same averaged gradients, same update), so ranks stay
bitwise in step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import DeviceLike, resolve_device
from ..collectives.ring_attention import RingAttention, ring_attention
from ..collectives.torch_shim import CrossSliceAllReduce
from ..collectives.ulysses import UlyssesAttention, ulysses_attention
from ..models.llama import CONFIGS, LlamaConfig, cross_entropy_loss
from ..ops import _native
from ..utils.trace import trace
from .trainer import Trainer, adamw, build_model, param_tree, set_grads

__all__ = ["SeqParallelTrainer"]


class SeqParallelTrainer:
    """Trains a Llama model with the sequence sharded across a
    :class:`~rocnrdma_tpu_torch.collectives.world.RingWorld`;
    ``Trainer(config, seq_parallel=world)`` is the front-door spelling.

    ``step(inputs, targets)`` takes this rank's contiguous (B, S_local)
    token shard (inputs and next-token targets, split the same way on
    every rank) and returns the GLOBAL mean loss. All ranks call
    ``step`` collectively.

    ``sp_mode`` is ``"ring"`` (K/V rotation, :class:`RingAttention`) or
    ``"ulysses"`` (all-to-all head resharding; both head counts must
    divide the world). Under ``remat`` the halves are recomputed whole
    whatever ``remat_policy`` says, as the JAX trainer's are. ``optimizer`` is a factory over the parameters
    (e.g. ``lambda ps: torch.optim.SGD(ps, lr=...)``); the default is
    the ``Trainer``'s AdamW. ``params`` and ``seed`` choose the weights
    as for ``Trainer``; ``model_overrides`` replace config fields."""

    def __init__(self, config: Union[LlamaConfig, str], world,
                 learning_rate: float = 3e-4, weight_decay: float = 0.1,
                 seed: int = 0,
                 optimizer: Optional[Callable] = None,
                 sp_mode: str = "ring", device: DeviceLike = "cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 **model_overrides) -> None:
        self.device = resolve_device(device)
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_mode={sp_mode!r}: must be 'ring' or 'ulysses'")
        cfg = CONFIGS[config] if isinstance(config, str) else config
        self.cfg = cfg = dataclasses.replace(cfg, **model_overrides)
        if sp_mode == "ulysses":
            # Checked here so every rank fails at construction, not
            # mid-ring.
            for what, n in (("n_heads", cfg.n_heads),
                            ("n_kv_heads", cfg.n_kv_heads)):
                if n % world.world != 0:
                    raise ValueError(
                        f"sp_mode='ulysses': {what}={n} must divide by "
                        f"world={world.world} (use sp_mode='ring' for "
                        "head counts the world does not divide)")
        self.sp_mode = sp_mode
        self.world = world
        self.model = build_model(cfg, self.device, seed, params)
        self.opt = (optimizer(self.model.parameters()) if optimizer
                    else adamw(self.model.parameters(), learning_rate,
                               weight_decay))
        if sp_mode == "ulysses":
            self.attn = UlyssesAttention(world)
        else:
            self.attn = RingAttention(world)
        self.sync = CrossSliceAllReduce(world, mean=True)
        self.global_step = 0
        # Host ms of the last step's phases (grads, sync, apply), each
        # ending with the card idle, and the attention's transport over
        # that step (the strategy's ``totals``: calls, wire bytes, and
        # the ring's wait and whole seconds or Ulysses' reshard seconds).
        self.last_split: Dict[str, float] = {}
        self.last_attention: Dict[str, float] = {}
        if self.device.type == "cuda":
            # Build and load every kernel now: a rank compiling at its
            # first launch while its peer waits in a rotation could
            # reach the ring's timeout.
            for name in _native.KERNELS:
                _native.library(name)

    # ------------------------------------------------------------ model

    def _freqs_shard(self, s_local: int) -> torch.Tensor:
        # Checked against the GLOBAL length, so every rank raises (an
        # offset check would fire only on the last ranks and leave the
        # rest waiting in the ring).
        if self.world.world * s_local > self.cfg.max_seq_len:
            raise ValueError(
                f"global sequence {self.world.world * s_local} exceeds "
                f"max_seq_len={self.cfg.max_seq_len}")
        off = self.world.rank * s_local
        return self.model.freqs[off:off + s_local]

    def _attend(self, q, k, v) -> torch.Tensor:
        if self.sp_mode == "ulysses":
            return ulysses_attention(self.attn, q, k, v, True)
        return ring_attention(self.attn, q, k, v, True)

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        m = self.model
        fr = self._freqs_shard(tokens.shape[1])
        x = F.embedding(tokens, m.embed)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in m.layers:
            if remat:
                q, k, v = torch.utils.checkpoint.checkpoint(
                    layer.qkv, x, fr, use_reentrant=False)
            else:
                q, k, v = layer.qkv(x, fr)
            o = self._attend(q, k, v)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer.post, x, o, use_reentrant=False)
            else:
                x = layer.post(x, o)
        return (m.final_norm(x) @ m.lm_head).float()

    def _tokens(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.long, device=self.device)

    def forward(self, inputs) -> torch.Tensor:
        """Logits (B, S_local, vocab) f32 for this rank's shard, without
        gradients. Collective."""
        with torch.no_grad():
            return self._logits(self._tokens(inputs))

    def grads_tree(self) -> Dict[str, object]:
        """The gradients as the flax-shaped tree the sync takes."""
        return param_tree(self.model, lambda p: p.grad)

    # A checkpoint's leaves, given and taken as the single-device
    # trainer does.
    _ckpt_leaf = Trainer._ckpt_leaf
    _ckpt_load = Trainer._ckpt_load

    def forward_backward(self, inputs, targets) -> float:
        """This rank's local mean loss; its exact gradients are left in
        the parameters' ``.grad`` (see the module docstring for why
        their mean across ranks is the global loss's gradient).
        Collective."""
        self.opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(self._logits(self._tokens(inputs)),
                                  self._tokens(targets))
        loss.backward()
        return float(loss.detach())

    # ------------------------------------------------------------- step

    def _mark(self, phase: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.last_split[phase] = (now - t0) * 1e3
        return now

    def step(self, inputs, targets) -> float:
        """One collective optimizer step on this rank's shard; returns
        the global mean loss (before the update)."""
        step_no = self.global_step + 1
        self.last_split = {}
        self.attn.reset_totals()
        t0 = time.perf_counter()
        with trace.span("trainer.grads", step=step_no):
            loss = self.forward_backward(inputs, targets)
            t0 = self._mark("grads_ms", t0)
        with trace.span("trainer.sync", step=step_no):
            set_grads(self.model, self.sync(self.grads_tree()))
            t0 = self._mark("sync_ms", t0)
        with trace.span("trainer.apply", step=step_no):
            self.opt.step()
            self._mark("apply_ms", t0)
        self.last_attention = dict(self.attn.totals)
        # The global loss: the mean of the ranks' local means (equal
        # shards).
        box = np.array([loss], dtype=np.float64)
        self.world.allreduce(box)
        gloss = float(box[0]) / self.world.world
        self.global_step = step_no
        trace.event("seq_parallel.step", rank=self.world.rank,
                    world=self.world.world, loss=gloss)
        return gloss

    def close(self) -> None:
        self.attn.close()
        self.sync.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
