"""Llama on an intra-slice dp × tp mesh: the meshed model step.

The counterpart of what ``rocnrdma_tpu/parallel/trainer.py`` gets from
GSPMD when it jits the Llama loss over a dp × tp mesh. PyTorch has no
partitioner, so :class:`MeshedLlama` holds one block of every parameter
per mesh position (placed by
:func:`~rocnrdma_tpu_torch.parallel.mesh.param_shardings`: the JAX
rules) and runs the step Megatron-style on those blocks, calling the
cross-position operations of :mod:`rocnrdma_tpu_torch.parallel.mesh`
where XLA would insert its collectives:

- the embedding is vocab-parallel: each position looks up the tokens
  its rows hold (the others give zeros), summed over ``tp``;
- every RMSNorm runs K1 on each position's own rows (its dp group's
  batch rows, the same on every tp position);
- attention is column-parallel in q/k/v, so a position holds its local
  heads: RoPE, then K3 on (local batch, local heads) through
  :func:`~rocnrdma_tpu_torch.ops.attention.attention` (K5 and K4
  backward), then the ``wo`` row block gives a partial sum, summed over
  ``tp``. Where the heads do not divide ``tp`` the layer's weights are
  gathered from their blocks and the layer runs whole on every tp
  position, still through the kernels
  (:func:`~rocnrdma_tpu_torch.ops.sharding.run_sharded`);
- the MLP the same way (w_gate/w_up columns, w_down rows, then the
  sum), or whole where ``d_ff`` does not divide ``tp``;
- the lm_head's vocab columns give vocab-sharded logits, gathered along
  the vocab onto each dp group's first position and then along the
  batch onto the mesh's first device, for the unchanged
  :func:`~rocnrdma_tpu_torch.models.llama.cross_entropy_loss`: the loss
  is the mean over the global batch, as the JAX trainer's.

With ``cfg.remat`` each layer's mesh-wide function is checkpointed
(``checkpoint_block`` under ``cfg.remat_policy``): the backward
recomputes the same ops as the single-device remat, K1 and K3
relaunching on every position under either policy. The
backward is autograd through the cross-position functions; each
copy's gradient is then partial (a dp copy saw its rows, a replicated
norm's tp copy its position's use), and :meth:`MeshedLlama.reduce_names`
sums the copies of every logical block onto its first copy, the
master, which the optimizer updates before :meth:`MeshedLlama.broadcast`
writes it back to the other copies. The per-layer sync sums a bucket's
names as soon as their copies have accumulated, the fused path every
name after the backward: one sum, in one order, either way.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.attention import attention
from ..ops.rmsnorm import rmsnorm
from ..ops.sharding import attn_ok, on_positions, run_sharded
from ..parallel.mesh import (Mesh, all_gather, assemble, batch_spec, block,
                             gather, ordered_sum, param_shardings, psum,
                             shard)
from .llama import (LlamaConfig, _flax_path, checkpoint_block, flax_tree,
                    out_proj, param_names, project_qkv, rope_freqs, swiglu)

__all__ = ["MeshedLlama"]


def _lookup(tokens: torch.Tensor, rows: torch.Tensor,
            first: int) -> torch.Tensor:
    """The embedding of the tokens that fall in this block of vocab rows
    (``first`` onwards); zeros for the others."""
    idx = tokens - first
    hit = (idx >= 0) & (idx < rows.shape[0])
    e = F.embedding(idx.clamp(0, rows.shape[0] - 1), rows)
    return e.masked_fill(~hit.unsqueeze(-1), 0)


class MeshedLlama:
    """Per-position blocks of a Llama's parameters on ``mesh`` (axes
    ``dp`` and ``tp``), split from the full state dict ``state``.
    Calling it on (B, S) token ids gives the (B, S, vocab) f32 logits
    on the mesh's first device; B must be a multiple of ``dp``."""

    def __init__(self, cfg: LlamaConfig, mesh: Mesh,
                 state: Dict[str, torch.Tensor]) -> None:
        missing = {"dp", "tp"} - set(mesh.shape)
        if missing or len(mesh.shape) != 2:
            raise ValueError(f"the meshed Llama takes a mesh of axes dp and "
                             f"tp, got {mesh.shape}")
        self.cfg, self.mesh = cfg, mesh
        self.names = param_names(cfg.n_layers)
        if set(state) != set(self.names):
            raise ValueError(
                f"state dict names differ from {cfg.name}'s: missing "
                f"{sorted(set(self.names) - set(state))[:4]}, unexpected "
                f"{sorted(set(state) - set(self.names))[:4]}")
        specs = param_shardings(mesh, flax_tree(
            (n, state[n]) for n in self.names))["params"]
        self.spec: Dict[str, tuple] = {}
        for name in self.names:
            node = specs
            for key in _flax_path(name):
                node = node[key]
            self.spec[name] = node
        self.device = mesh.device_list[0]
        self.local: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(mesh.size)]
        # The positions holding each logical block, the master first.
        self.copies: Dict[str, List[List[int]]] = {}
        with torch.no_grad():
            for name in self.names:
                for pos, t in enumerate(shard(state[name].detach(),
                                              self.spec[name], mesh)):
                    self.local[pos][name] = t.requires_grad_()
                held: Dict[Tuple[int, ...], List[int]] = {}
                for pos in range(mesh.size):
                    key = self._block_key(name, pos)
                    held.setdefault(key, []).append(pos)
                self.copies[name] = list(held.values())
        # The names whose copies were summed since the last zero_grad.
        self._summed: set = set()
        self.freqs = {d: rope_freqs(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, d)
                      for d in set(mesh.device_list)}
        self.attn_split = attn_ok(mesh, cfg.n_heads, cfg.n_kv_heads)

    def _block_key(self, name: str, pos: int) -> Tuple[int, ...]:
        coords = self.mesh.coords(pos)
        return tuple(0 if a is None else coords[a]
                     for a in self.spec[name])

    # ----------------------------------------------------------- forward

    def _weights(self, name: str) -> List[torch.Tensor]:
        return [self.local[p][name] for p in range(self.mesh.size)]

    def _norm(self, xs, name: str) -> List[torch.Tensor]:
        """K1 on each position's rows (the mesh has a dp axis, so
        ``rms_ok`` holds and every position normalises its own)."""
        eps = self.cfg.norm_eps
        return on_positions(self.mesh, lambda x, w: rmsnorm(x, w, eps),
                            list(zip(xs, self._weights(name))))

    def _attention(self, pre: str, hs, s: int) -> List[torch.Tensor]:
        mesh, hd = self.mesh, self.cfg.head_dim
        names = [pre + n for n in ("attn.wq", "attn.wk", "attn.wv",
                                   "attn.wo")]

        def local(h, wq, wk, wv, wo, freqs):
            q, k, v = project_qkv(h, wq, wk, wv, hd, freqs)
            return out_proj(attention(q, k, v, causal=True), wo)

        def gathered(args):
            cols = [list(c) for c in zip(*args)]
            for j, name in enumerate(names, start=1):
                spec = self.spec[name]
                if spec:
                    cols[j] = all_gather(cols[j], mesh, "tp",
                                         spec.index("tp"))
            return on_positions(mesh, local, list(zip(*cols)))

        args = [(hs[p], *(self.local[p][n] for n in names),
                 self.freqs[dev][:s])
                for p, dev in enumerate(mesh.device_list)]
        ys = run_sharded(mesh, local, args, self.attn_split, gathered)
        # Split heads give each position a partial sum of wo's rows.
        return psum(ys, mesh, "tp") if self.attn_split else ys

    def _mlp(self, pre: str, hs) -> List[torch.Tensor]:
        names = [pre + n for n in ("mlp.w_gate", "mlp.w_up", "mlp.w_down")]
        ys = on_positions(self.mesh, swiglu, [
            (hs[p], *(self.local[p][n] for n in names))
            for p in range(self.mesh.size)])
        return psum(ys, self.mesh, "tp") if self.spec[names[2]] else ys

    def _layer(self, i: int, s: int, *xs) -> Tuple[torch.Tensor, ...]:
        pre = f"layers.{i}."
        ys = self._attention(pre, self._norm(xs, pre + "attn_norm.weight"),
                             s)
        xs = [x + y for x, y in zip(xs, ys)]
        ys = self._mlp(pre, self._norm(xs, pre + "mlp_norm.weight"))
        return tuple(x + y for x, y in zip(xs, ys))

    def _embed(self, toks) -> List[torch.Tensor]:
        mesh, w = self.mesh, self._weights("embed")
        if not self.spec["embed"]:
            return on_positions(mesh, F.embedding, list(zip(toks, w)))
        rows = self.cfg.vocab_size // mesh.shape["tp"]
        parts = on_positions(mesh, _lookup, [
            (toks[p], w[p], mesh.coords(p)["tp"] * rows)
            for p in range(mesh.size)])
        return psum(parts, mesh, "tp")

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, mesh = self.cfg, self.mesh
        b, s = tokens.shape
        if s > cfg.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds {cfg.name}'s "
                             f"max_seq_len={cfg.max_seq_len}")
        dp = mesh.shape["dp"]
        if b % dp:
            raise ValueError(f"batch {b} does not divide over dp={dp}")
        toks = [block(tokens, batch_spec(), mesh, p).to(dev)
                for p, dev in enumerate(mesh.device_list)]
        xs = tuple(self._embed(toks))
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            fn = functools.partial(self._layer, i, s)
            if remat:
                xs = checkpoint_block(fn, *xs, policy=cfg.remat_policy)
            else:
                xs = fn(*xs)
        hs = self._norm(xs, "final_norm.weight")
        logits = on_positions(mesh, lambda h, w: (h @ w).float(),
                              list(zip(hs, self._weights("lm_head"))))
        by_row = []
        for group in mesh.groups("tp"):           # one group per dp row
            if self.spec["lm_head"]:
                by_row.append(gather([logits[p] for p in group], -1,
                                     mesh.device_list[group[0]]))
            else:
                by_row.append(logits[group[0]])
        return gather(by_row, 0, self.device)

    # ----------------------------------------------------------- training

    def parameters(self) -> Iterator[torch.Tensor]:
        """Every position's blocks."""
        for local in self.local:
            yield from local.values()

    def masters(self) -> List[torch.Tensor]:
        """The first copy of every logical block, in name order: what
        the optimizer updates."""
        return [t for name in self.names for _, t in self.masters_of(name)]

    def masters_of(self, name: str) -> List[Tuple[int, torch.Tensor]]:
        """(position, master) of each logical block of ``name``."""
        return [(g[0], self.local[g[0]][name]) for g in self.copies[name]]

    def copies_of(self, name: str) -> List[torch.Tensor]:
        """Every position's copy of ``name``, by position."""
        return [self.local[p][name] for p in range(self.mesh.size)]

    def zero_grad(self) -> None:
        for p in self.parameters():
            p.grad = None
        self._summed = set()

    def reduce_names(self, names) -> None:
        """For each of ``names``, each logical block's gradient, the sum
        of its copies' in position order, onto its master; the other
        copies' dropped. A name already summed since the last
        :meth:`zero_grad` is left as it is."""
        with record_function("mesh.grad_sum"), torch.no_grad():
            for name in names:
                if name in self._summed:
                    continue
                for group in self.copies[name]:
                    ps = [self.local[p][name] for p in group]
                    gs = [q.grad for q in ps if q.grad is not None]
                    if len(ps) > 1 and gs:
                        ps[0].grad = ordered_sum(gs).to(ps[0].device)
                        for q in ps[1:]:
                            q.grad = None
                self._summed.add(name)

    @torch.no_grad()
    def broadcast(self, names=None) -> None:
        """Every master (of ``names``, default all) written into its
        other copies."""
        with record_function("mesh.broadcast"):
            for name in self.names if names is None else names:
                for group in self.copies[name]:
                    master = self.local[group[0]][name]
                    for p in group[1:]:
                        self.local[p][name].copy_(master)

    def whole(self, name: str, of) -> torch.Tensor:
        """``of(master)`` of every logical block of ``name``, assembled
        in spec order on the mesh's first device (a replicated one is
        ``of(master)`` itself where the master lives there)."""
        blocks: List[torch.Tensor] = [None] * self.mesh.size
        for group in self.copies[name]:
            t = of(self.local[group[0]][name])
            for p in group:
                blocks[p] = t
        return assemble(blocks, self.spec[name], self.mesh, self.device)

    def full(self, name: str, grad: bool = False) -> torch.Tensor:
        """The whole parameter ``name`` (or its master gradient) on the
        mesh's first device (:meth:`whole`)."""
        return self.whole(name, (lambda t: t.grad) if grad
                          else torch.Tensor.detach)

    def tree(self, grad: bool = False) -> Dict[str, object]:
        """The whole parameters (or gradients) as the flax-shaped tree."""
        return flax_tree((n, self.full(n, grad)) for n in self.names)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: self.full(n) for n in self.names}

    @torch.no_grad()
    def set_master_grads(self, tree) -> None:
        """Each master's gradient from its block of the whole-leaf tree
        ``tree`` (what the cross-slice sync returned)."""
        for name in self.names:
            node = tree["params"]
            for key in _flax_path(name):
                node = node[key]
            full = torch.as_tensor(node)
            for pos, master in self.masters_of(name):
                part = block(full, self.spec[name], self.mesh, pos)
                if part is not master.grad:
                    master.grad.copy_(part)
