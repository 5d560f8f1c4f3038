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

With ``elastic`` (an :class:`ElasticPolicy`) a step survives a peer's
death as the JAX trainer's does: a retryable ``TransportError`` rebuilds
the sync's world, restores the last checkpoint
(:mod:`~rocnrdma_tpu_torch.parallel.checkpoint`) and re-runs the step;
gradients that come back from the sync non-finite are retried once in
place before that ladder engages; every ``save_every`` steps the
trainer checkpoints.

With ``seq_parallel`` (a ``RingWorld``) the constructor returns a
:class:`~rocnrdma_tpu_torch.parallel.seq_parallel.SeqParallelTrainer`,
as the JAX trainer's does.

With a ``mesh_shape`` of more than one position (``{"dp": 2, "tp":
2}``) the constructor returns a :class:`MeshTrainer`: the JAX trainer's
sharded step over an intra-slice dp × tp mesh
(:mod:`~rocnrdma_tpu_torch.parallel.mesh`,
:mod:`~rocnrdma_tpu_torch.models.llama_mesh`) on ``devices`` (default:
every visible card). Its fused and overlapped cross-slice syncs take
the whole gradient of each leaf, so the wire, the layer plan and the
checkpoint are the single-device trainer's.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from typing import Any, Dict, Optional, Union

import torch

from .. import DeviceLike, resolve_device
from ..collectives.torch_shim import tree_flatten
from ..models.llama import (CONFIGS, Llama, LlamaConfig, _flax_path,
                            cross_entropy_loss, flax_tree, init_params,
                            param_names)
from ..models.llama_mesh import MeshedLlama
from ..transport.engine import TransportError, dtype_name
from ..utils.trace import trace
from .checkpoint import (checkpoint_file, load_adamw_state,
                         restore_checkpoint, save_checkpoint)
from .mesh import block, make_mesh

__all__ = ["loss_fn", "ElasticPolicy", "Trainer", "MeshTrainer"]


def loss_fn(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy on (B, S) token ids."""
    logits = model(tokens[:, :-1])
    return cross_entropy_loss(logits, tokens[:, 1:])


@dataclasses.dataclass
class ElasticPolicy:
    """Opt-in auto-resume for transient transport failures (the JAX
    trainer's ``ElasticPolicy``, same fields and defaults).

    When a ``step()`` raises a RETRYABLE ``TransportError`` (peer death,
    connection drop, stall), the trainer rebuilds the sync's world
    (``RingWorld.rebuild``: re-rendezvous under a new generation),
    restores params, optimizer state and step from the last checkpoint,
    and re-runs the step, so a SIGKILLed-and-restarted rank rejoins and
    training converges to the same params as an uninterrupted run.
    Fatal errors re-raise unchanged.

    ``checkpoint_path``: where this rank saves and restores its state
    (one path per rank). ``save_every``: checkpoint cadence in steps;
    with 1 the failed step re-runs exactly in place, with more a
    mid-interval failure restores an older step and ``step()`` raises
    (it cannot replay the caller's batches). ``max_resumes``: resume
    budget per step. ``rebuild``: kwargs for ``RingWorld.rebuild``.
    ``quarantine_nonfinite``: synced gradients that are non-finite are
    retried once in place (apply never ran) before the elastic ladder
    engages."""

    checkpoint_path: str
    save_every: int = 1
    max_resumes: int = 4
    rebuild: Dict[str, Any] = dataclasses.field(default_factory=dict)
    quarantine_nonfinite: bool = True


class _NonFiniteGrads(RuntimeError):
    """Internal: the synced gradients are non-finite (NaN/inf). Raised
    before the update so ``step()`` can run the quarantine retry before
    the elastic ladder engages."""


def _check_elastic(elastic, cross_slice_sync) -> None:
    """The JAX trainer's refusal of a policy with nothing to recover: an
    ``elastic=`` without ``cross_slice_sync`` would checkpoint every step
    and never resume."""
    if elastic is not None and cross_slice_sync is None:
        raise ValueError(
            "elastic= recovers the cross-slice transport world and "
            "requires cross_slice_sync")


def _positions(mesh_shape: Optional[Dict[str, int]]) -> int:
    n = 1
    for size in (mesh_shape or {}).values():
        n *= int(size)
    return n


def build_model(cfg: LlamaConfig, device: torch.device, seed: int,
                params: Optional[Dict[str, torch.Tensor]]) -> Llama:
    """A :class:`Llama` on ``device`` holding ``params`` (a state dict),
    or else :func:`init_params` at ``seed``."""
    model = Llama(cfg, device)
    if params is None:
        model.load_state_dict(init_params(cfg, seed, device), assign=True)
    else:
        # A plain dict drops the ``_metadata`` of a state dict: once
        # that dict went through ``load_state_dict(..., assign=True)``
        # its metadata says "assign", and loading it again would make
        # these parameters share (and train) the caller's tensors.
        model.load_state_dict(dict(params))
    return model


def adamw(parameters, learning_rate: float,
          weight_decay: float) -> torch.optim.AdamW:
    """The JAX trainer's ``optax.adamw(learning_rate,
    weight_decay=weight_decay)``."""
    return torch.optim.AdamW(parameters, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def param_tree(model: Llama, leaf) -> Dict[str, object]:
    """``leaf(p)`` of every parameter of ``model`` in the flax-shaped
    tree."""
    return flax_tree((name, leaf(p)) for name, p in model.named_parameters())


def set_grads(model: Llama, tree) -> None:
    """Write a synced tree back into ``p.grad`` (in place where the sync
    returned other tensors than it was given)."""
    for name, p in model.named_parameters():
        node = tree["params"]
        for key in _flax_path(name):
            node = node[key]
        if node is not p.grad:
            p.grad.copy_(torch.as_tensor(node))


class Trainer:
    """Single-process Llama trainer on one device.

    ``config`` is a config name or a :class:`LlamaConfig`;
    ``model_overrides`` replace its fields (e.g. ``remat=True``,
    ``dtype=torch.float32``). The weights are ``params`` (a state dict,
    e.g. from :func:`~rocnrdma_tpu_torch.models.llama.params_from_flax`)
    or else :func:`~rocnrdma_tpu_torch.models.llama.init_params` at
    ``seed``. The trainer runs on ``device``, or on ``devices[0]`` where
    ``devices`` is given; a ``mesh_shape`` of more than one position
    makes it a :class:`MeshTrainer`. ``elastic`` is an
    :class:`ElasticPolicy`.

    ``Trainer(config, seq_parallel=world, sp_mode=...)`` returns a
    :class:`~rocnrdma_tpu_torch.parallel.seq_parallel.SeqParallelTrainer`
    instead: the sequence is sharded across the ring's ranks, a
    different orchestration from this one."""

    def __new__(cls, *args, **kwargs):
        if cls is Trainer and kwargs.get("seq_parallel") is not None:
            from .seq_parallel import SeqParallelTrainer

            kw = dict(kwargs)
            world = kw.pop("seq_parallel")
            if len(args) > 1:
                # A positional mesh_shape would land in the world slot.
                raise ValueError(
                    "mesh_shape does not apply to the seq_parallel "
                    "trainer (one device per ring rank)")
            for unsupported in ("mesh_shape", "devices", "cross_slice_sync",
                                "elastic"):
                if kw.pop(unsupported, None) is not None:
                    raise ValueError(
                        f"{unsupported} does not apply to the "
                        "seq_parallel trainer (one device per ring rank)")
            return SeqParallelTrainer(*args, world=world, **kw)
        if cls is Trainer and _positions(
                args[1] if len(args) > 1 else kwargs.get("mesh_shape")) > 1:
            return super().__new__(MeshTrainer)
        return super().__new__(cls)

    def __init__(self, config: Union[LlamaConfig, str],
                 mesh_shape: Optional[Dict[str, int]] = None,
                 learning_rate: float = 3e-4, weight_decay: float = 0.1,
                 cross_slice_sync=None, devices=None, seed: int = 0,
                 seq_parallel=None,
                 elastic: Optional[ElasticPolicy] = None,
                 device: DeviceLike = "cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 **model_overrides) -> None:
        if seq_parallel is not None:
            # Only a subclass gets here (__new__ dispatches the base
            # class), where dropping the flag would train data-parallel.
            raise ValueError(
                "seq_parallel requires the Trainer base class (__new__ "
                "dispatches to SeqParallelTrainer; subclasses are not "
                "intercepted)")
        if "sp_mode" in model_overrides:
            raise ValueError(
                "sp_mode selects the seq-parallel attention strategy and "
                "requires seq_parallel=<RingWorld>")
        _check_elastic(elastic, cross_slice_sync)
        cfg = CONFIGS[config] if isinstance(config, str) else config
        self.cfg = dataclasses.replace(cfg, **model_overrides)
        self._place(mesh_shape, devices, device, seed, params)
        self.opt = adamw(self._trained(), learning_rate, weight_decay)
        self.global_step = 0
        self.elastic = elastic
        self.cross_slice_sync = cross_slice_sync
        self._stamp_sync = cross_slice_sync is not None
        # Host ms of the last step's phases (grads, sync, the finite
        # check, apply; a resume's rebuild and restore; the checkpoint
        # save), each ending with the card idle.
        self.last_split: Dict[str, float] = {}
        self._per_layer = bool(getattr(cross_slice_sync, "per_layer", False)
                               and hasattr(cross_slice_sync,
                                           "start_layered"))
        self._pending_layers = None
        self._hook_error: Optional[BaseException] = None
        if self._per_layer:
            inner = flax_tree((n, n) for n in param_names(
                self.cfg.n_layers))["params"]
            self._buckets = [tree_flatten(inner[k])[0]
                             for k in sorted(inner)]
            self.layer_plan = [(k, [self._leaf_plan(n) for n in names])
                               for k, names in zip(sorted(inner),
                                                   self._buckets)]
            # On a multi-card mesh each card's backward runs its hooks
            # on its own autograd device thread.
            self._left_lock = threading.Lock()
            for idx, names in enumerate(self._buckets):
                for n in names:
                    for t in self._copies(n):
                        t.register_post_accumulate_grad_hook(
                            functools.partial(self._grad_ready, idx))

    def _place(self, mesh_shape, devices, device, seed, params) -> None:
        """Build the model on the trainer's device."""
        if _positions(mesh_shape) > 1:
            # Only Trainer's own constructor dispatches to MeshTrainer; a
            # subclass would otherwise train one device and drop the mesh.
            raise ValueError(
                f"mesh_shape {mesh_shape} has more than one position: "
                "construct Trainer (which returns a MeshTrainer) or "
                "MeshTrainer itself")
        self.device = resolve_device(devices[0] if devices else device)
        self.model = build_model(self.cfg, self.device, seed, params)

    def _trained(self):
        """The tensors the optimizer updates."""
        return self.model.parameters()

    def _devices(self):
        return [self.device]

    def _copies(self, name: str):
        """The tensors that hold parameter ``name`` and take its
        gradient."""
        return [self.model.get_parameter(name)]

    def _leaf_plan(self, name: str):
        """(numel, dtype) of parameter ``name`` in the per-layer plan."""
        p = self.model.get_parameter(name)
        return p.numel(), dtype_name(p)

    def _bucket_grads(self, idx: int):
        """Bucket ``idx``'s whole gradients, in tree order."""
        return [self.model.get_parameter(n).grad for n in self._buckets[idx]]

    def _ckpt_leaf(self, name: str, what: str):
        """The whole tensor a checkpoint holds for parameter ``name``:
        the parameter (``what`` "param") or its AdamW state ``what``;
        None where the optimizer has not stepped it."""
        p = self.model.get_parameter(name)
        if what == "param":
            return p
        state = self.opt.state.get(p)
        return state[what] if state else None

    @torch.no_grad()
    def _ckpt_load(self, name: str, what: str, whole: torch.Tensor) -> None:
        """Copy ``whole`` from a checkpoint into parameter ``name`` or
        its AdamW state ``what``, in place."""
        p = self.model.get_parameter(name)
        if what == "param":
            p.copy_(whole)
        else:
            load_adamw_state(self.opt, p, what, whole)

    def _param_tree(self, leaf) -> Dict[str, object]:
        """``leaf(p)`` of every parameter in the flax-shaped tree."""
        return param_tree(self.model, leaf)

    def param_tree(self) -> Dict[str, object]:
        """The parameters as the flax-shaped tree."""
        return self._param_tree(lambda p: p.detach())

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The parameters by state-dict name, in the model's order."""
        return self.model.state_dict()

    def grads_tree(self) -> Dict[str, object]:
        """The parameters' gradients as the flax-shaped tree the sync
        takes, the tensors left where they are."""
        return self._param_tree(lambda p: p.grad)

    def _grad_ready(self, idx: int, _param) -> None:
        """Post-accumulate-grad hook: push bucket ``idx`` to the step's
        pending sync once the last copy of its parameters' gradients
        has accumulated. Runs inside the backward (on the card, on
        autograd's device thread), so it never raises: ``push`` keeps
        failures for ``finish()``."""
        pending = self._pending_layers
        if pending is None:
            return  # a backward outside a per-layer step
        with self._left_lock:
            self._left[idx] -= 1
            last = self._left[idx] == 0
        if last:
            self._push(pending, idx)

    def _deliver_rest(self, pending) -> None:
        """End a per-layer backward's deliveries. A copy that took no
        gradient (a replicated head whose other tp positions' logits go
        unused) never fires its hook: its bucket goes now. Then wait
        until every bucket has been staged and posted, so the backward
        span closes where the JAX trainer's does: once its program, and
        so every tap's stage and launch, has finished."""
        for idx, left in enumerate(self._left):
            if left:
                self._left[idx] = 0
                self._push(pending, idx)
        pending.wait_posted()

    def _push(self, pending, idx: int) -> None:
        """Push bucket ``idx``'s whole gradients. A failure to gather
        them is kept, and ``_synced_step`` raises it once ``finish()``
        has drained the sync (which the push of nothing fails)."""
        try:
            grads = self._bucket_grads(idx)
        except BaseException as e:  # noqa: BLE001 — re-raised after finish
            if self._hook_error is None:
                self._hook_error = e
            grads = None
        pending.push(idx, grads)

    def _mark(self, phase: str, t0: float) -> float:
        for device in self._devices():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
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
            self._zero_grad()
            if self._per_layer:
                # The hooks push each bucket from inside the backward,
                # so its wire rides under the rest of the backward.
                pending = sync.start_layered(self.layer_plan)
                self._left = [sum(len(self._copies(n)) for n in names)
                              for names in self._buckets]
                self._hook_error = None
                self._pending_layers = pending
            try:
                with trace.span("trainer.backward", step=step_no):
                    loss = self._backward(tokens)
                    if self._per_layer:
                        self._deliver_rest(pending)
            finally:
                self._pending_layers = None
            if overlap and pending is None:
                pending = sync.start(self.grads_tree())
            t0 = self._mark("grads_ms", t0)
        # The cross-slice hop: the gradients averaged across slices.
        with trace.span("trainer.sync", step=step_no):
            if self._per_layer:
                try:
                    tree = pending.finish(self.grads_tree())
                finally:
                    hook_error, self._hook_error = self._hook_error, None
                    if hook_error is not None:
                        raise hook_error
            elif pending is not None:
                tree = pending.finish()
            else:
                tree = sync(self.grads_tree())
            self._set_grads(tree)
            t0 = self._mark("sync_ms", t0)
        # Quarantine check BEFORE apply: gradients the sync returned
        # non-finite would poison the params; while the pre-step state
        # is intact, step() retries once in place, then escalates.
        if self.elastic is not None and self.elastic.quarantine_nonfinite:
            finite = self._grads_finite()
            t0 = self._mark("finite_ms", t0)
            if not finite:
                raise _NonFiniteGrads(
                    f"all-reduced gradients contain non-finite values "
                    f"at step {step_no}")
        with trace.span("trainer.apply", step=step_no):
            self._apply()
            self._mark("apply_ms", t0)
        return loss

    def _grads_finite(self) -> bool:
        """Whether every gradient is finite: the largest magnitude of
        each gradient (NaN where one holds a NaN) by one multi-tensor
        reduction per device and dtype, reduced on the device to one
        flag per device, and those flags to the host. No gradient is
        copied."""
        groups: Dict[tuple, list] = {}
        for p in self.model.parameters():
            if p.grad is not None:
                groups.setdefault((p.grad.device, p.grad.dtype),
                                  []).append(p.grad)
        by_device: Dict[torch.device, list] = {}
        for (device, _dtype), gs in groups.items():
            by_device.setdefault(device, []).extend(
                torch._foreach_norm(gs, float("inf")))
        flags = [torch.stack(norms).isfinite().all().cpu()
                 for norms in by_device.values()]
        return bool(torch.stack(flags).all()) if flags else True

    def _resume(self, exc: BaseException, attempt: int) -> None:
        """The detect→recover bridge: rebuild the sync's world under a
        new generation, drop the sync's ring-bound caches, and restore
        the last checkpoint so the failed step re-runs from a consistent
        (params, optimizer state, step)."""
        trace.event("trainer.resume", step=self.global_step + 1,
                    attempt=attempt, error=str(exc)[:160])
        # Nothing of the failed step may outlive it. A sync that failed
        # drained its handles, and a per-layer one its posting worker,
        # before raising; what may still run are the per-layer sync's
        # side-stream copies into the staging tensors.
        for device in self._devices():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        world = getattr(self.cross_slice_sync, "world", None)
        if world is not None:
            old_size = getattr(world, "world", None)
            kw = dict(self.elastic.rebuild)
            kw.setdefault("reason", str(exc)[:400])
            t0 = time.perf_counter()
            world.rebuild(**kw)
            self.last_split["rebuild_ms"] = (time.perf_counter() - t0) * 1e3
            new_size = getattr(world, "world", None)
            if old_size is not None and new_size != old_size:
                # A world RESIZE rode the rebuild: every sync scales by
                # the current world size, but the global batch moved.
                trace.add("trainer.resize", 1)
                trace.event("trainer.resize",
                            step=self.global_step + 1,
                            old_size=old_size, new_size=new_size)
        reset = getattr(self.cross_slice_sync, "reset_transport_cache", None)
        if reset is not None:
            reset()
        entry_step = self.global_step
        path = self.elastic.checkpoint_path
        if os.path.exists(checkpoint_file(path)):
            t0 = time.perf_counter()
            restore_checkpoint(path, self)  # also sets self.global_step
            self._mark("restore_ms", t0)
        # else: failure before the first checkpoint — the params and
        # optimizer state are the pre-step values (apply never ran).
        if self.global_step != entry_step:
            raise RuntimeError(
                f"elastic resume restored step {self.global_step} but "
                f"the failed step was {entry_step + 1}: the "
                f"intervening steps were never checkpointed "
                f"(save_every={self.elastic.save_every}); re-feed "
                "batches from trainer.global_step (or use "
                "save_every=1 for exact in-place replay)")
        # The retried sync re-proves step agreement across ranks.
        self._stamp_sync = True

    def _step_once(self, tokens: torch.Tensor, step_no: int):
        if self.cross_slice_sync is not None:
            return self._synced_step(tokens, step_no)
        dev = self.device
        with trace.span("trainer.fused_step", dev, step=step_no):
            self._zero_grad()
            with trace.span("trainer.forward", dev, step=step_no):
                loss = self._forward(tokens)
            with trace.span("trainer.backward", dev, step=step_no):
                self._grads(loss)
            with trace.span("trainer.apply", dev, step=step_no):
                self._apply()
        return loss

    def _zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def _backward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The loss and its gradients in the parameters' ``.grad``."""
        loss = self._forward(tokens)
        self._grads(loss)
        return loss

    def _forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The loss of (B, S) tokens."""
        return loss_fn(self.model, tokens)

    def _grads(self, loss: torch.Tensor) -> None:
        """The loss's gradients in the parameters' ``.grad``."""
        loss.backward()

    def _set_grads(self, tree) -> None:
        set_grads(self.model, tree)

    def _apply(self) -> None:
        self.opt.step()

    def step(self, tokens) -> float:
        """One optimizer step on (B, S) token ids; returns the loss
        before the update. With an ``elastic`` policy, a retryable
        transport failure rebuilds, restores and re-runs the step (at
        most ``max_resumes`` times), non-finite synced gradients are
        retried once in place before that, and every ``save_every``
        steps the trainer checkpoints."""
        tokens = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        self.last_split = {}
        if self.elastic is None:
            loss = self._step_once(tokens, self.global_step + 1)
        else:
            resumes = 0
            quarantined = False
            while True:
                try:
                    loss = self._step_once(tokens, self.global_step + 1)
                    break
                except _NonFiniteGrads as e:
                    if not quarantined:
                        # First non-finite on this step: the params and
                        # optimizer state are the pre-step values, so
                        # the re-run recomputes and re-syncs the batch.
                        quarantined = True
                        trace.event("trainer.quarantine",
                                    step=self.global_step + 1)
                        continue
                    if resumes >= self.elastic.max_resumes:
                        raise TransportError(str(e), retryable=True)
                    resumes += 1
                    self._resume(e, resumes)
                    quarantined = False
                except TransportError as e:
                    if (not getattr(e, "retryable", False)
                            or resumes >= self.elastic.max_resumes):
                        raise
                    resumes += 1
                    self._resume(e, resumes)
                    quarantined = False
        self.global_step += 1
        # Reading the loss waits for the step's device work; dropping it
        # frees the step's autograd graph, host work the device idles for.
        with trace.span("trainer.finish", step=self.global_step):
            value = float(loss.detach())
            del loss
        if (self.elastic is not None and self.elastic.save_every > 0
                and self.global_step % self.elastic.save_every == 0):
            t0 = time.perf_counter()
            save_checkpoint(self.elastic.checkpoint_path, self,
                            self.global_step)
            self.last_split["ckpt_save_ms"] = \
                (time.perf_counter() - t0) * 1e3
        trace.event("trainer.step", loss=value, step=self.global_step)
        return value


class MeshTrainer(Trainer):
    """The trainer over an intra-slice dp × tp mesh of more than one
    position: what ``Trainer(config, mesh_shape, devices=...)`` returns
    for such a ``mesh_shape``. The counterpart of the JAX trainer's
    sharded jit (``rocnrdma_tpu/parallel/trainer.py:181-292``).

    ``mesh_shape`` names the axes ``dp`` and ``tp`` (a missing one has
    size 1); ``devices`` (default: every visible card, or the CPU where
    ``device="cpu"``) holds one torch device per position and may name
    one device more than once (:func:`~rocnrdma_tpu_torch.parallel.mesh.
    make_mesh`). ``params``, a full state dict, is split by
    :func:`~rocnrdma_tpu_torch.parallel.mesh.param_shardings`, so a JAX
    meshed trainer's parameters (through ``params_from_flax``) enter as
    they are; else ``init_params(seed)`` on the first device is.

    A step runs :class:`~rocnrdma_tpu_torch.models.llama_mesh.MeshedLlama`
    on the global batch (its rows split over ``dp``; the batch must
    divide), sums each logical block's copies' gradients onto its
    master, applies one AdamW update per logical block and writes it
    back to the other copies. With ``cross_slice_sync`` (fused, or the
    overlap mode's ``start``/``finish``) the sync takes the whole
    gradient of each leaf on the first device in the flax-shaped tree
    and its result is split back onto the masters, as the JAX shim
    gathers a sharded leaf and puts the mean back on its sharding: the
    wire, the leaf order and the schedule digest are those of a JAX rank
    with the same mesh and of a single-device trainer. The per-layer
    sync hooks every position's copy of every leaf: once the last copy
    of a bucket's leaves has accumulated, the copies are summed onto the
    masters (:meth:`~rocnrdma_tpu_torch.models.llama_mesh.MeshedLlama.
    reduce_names`, the fused path's sum) and the bucket is pushed as
    whole leaves, what a JAX rank's tap delivers. With ``elastic`` a
    checkpoint holds whole leaves, the params and AdamW's moments
    assembled from the masters: the file a single-device trainer writes
    at the same state, and either restores the other.
    :meth:`param_tree`, :meth:`grads_tree` and :meth:`state_dict` give
    whole tensors."""

    def _place(self, mesh_shape, devices, device, seed, params) -> None:
        unknown = set(mesh_shape) - {"dp", "tp"}
        if unknown:
            raise ValueError(f"mesh axes {sorted(unknown)} are not dp or "
                             f"tp; the meshed trainer shards on those")
        shape = dict(mesh_shape)
        shape.setdefault("dp", 1)
        shape.setdefault("tp", 1)
        if devices is None and resolve_device(device).type == "cpu":
            devices = [torch.device("cpu")]
        self.mesh = make_mesh(shape, devices)
        self.device = self.mesh.device_list[0]
        state = (params if params is not None
                 else init_params(self.cfg, seed, self.device))
        self.model = MeshedLlama(self.cfg, self.mesh, state)

    def _trained(self):
        return self.model.masters()

    def _devices(self):
        return sorted(set(self.mesh.device_list), key=str)

    def _copies(self, name: str):
        return self.model.copies_of(name)

    def _leaf_plan(self, name: str):
        masters = [t for _, t in self.model.masters_of(name)]
        return sum(t.numel() for t in masters), dtype_name(masters[0])

    def _bucket_grads(self, idx: int):
        names = self._buckets[idx]
        self.model.reduce_names(names)
        return [self.model.full(n, grad=True) for n in names]

    def _ckpt_leaf(self, name: str, what: str):
        m = self.model
        if what == "param":
            return m.full(name)
        states = [self.opt.state.get(t) for _, t in m.masters_of(name)]
        if not all(states):
            return None
        if what == "step":
            return states[0]["step"]
        return m.whole(name, lambda t: self.opt.state[t][what])

    @torch.no_grad()
    def _ckpt_load(self, name: str, what: str, whole: torch.Tensor) -> None:
        """Each master's block of ``whole`` into the master (then every
        other copy from it) or into its AdamW state."""
        m = self.model
        for pos, master in m.masters_of(name):
            part = (whole if what == "step"
                    else block(whole, m.spec[name], m.mesh, pos))
            if what == "param":
                master.copy_(part)
            else:
                load_adamw_state(self.opt, master, what, part)
        if what == "param":
            m.broadcast([name])

    def _param_tree(self, leaf) -> Dict[str, object]:
        """``leaf`` of every whole parameter in the flax-shaped tree."""
        return flax_tree((name, leaf(t))
                          for name, t in self.model.state_dict().items())

    def grads_tree(self) -> Dict[str, object]:
        """The whole gradient of every leaf on the first device, in the
        flax-shaped tree the sync takes (a replicated leaf's is its
        master's own ``.grad`` where that lives on the first device)."""
        return self.model.tree(grad=True)

    def _zero_grad(self) -> None:
        self.model.zero_grad()

    def _grads(self, loss: torch.Tensor) -> None:
        super()._grads(loss)
        self.model.reduce_names(self.model.names)

    def _set_grads(self, tree) -> None:
        self.model.set_master_grads(tree)

    def _apply(self) -> None:
        self.opt.step()
        self.model.broadcast()
