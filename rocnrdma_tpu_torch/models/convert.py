"""HuggingFace Llama checkpoint import (the port's counterpart of
``rocnrdma_tpu/models/convert.py``).

Maps a ``transformers`` Llama state dict (``LlamaForCausalLM`` layout)
onto this port's state dict, the names of
:func:`~rocnrdma_tpu_torch.models.llama.params_from_flax`:

- ``nn.Linear.weight`` is (out, in); the port keeps flax's ``Dense``
  layout (in, out) and applies ``x @ W``, so every projection, and the
  LM head, is transposed once;
- HF checkpoints use the rotate-half RoPE layout that
  :func:`~rocnrdma_tpu_torch.models.llama.apply_rope` implements and
  head-major projection rows, so no head-dim permutation is needed;
- norm weights stay f32 (they are f32 parameters in the model); every
  other tensor is cast to ``cfg.dtype``;
- a ``tie_word_embeddings`` checkpoint has no ``lm_head.weight``: the
  head is the embedding's transpose.

:func:`config_from_hf`, :func:`from_hf_state_dict` and
:func:`from_hf_model` need no ``transformers``: they read a config-like
object (HF's field names) and a ``Mapping`` of torch tensors or numpy
arrays. Only :func:`from_hf_pretrained` imports ``transformers``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .. import DeviceLike
from .llama import Llama, LlamaConfig

__all__ = ["config_from_hf", "from_hf_state_dict", "from_hf_model",
           "from_hf_pretrained"]


def config_from_hf(hf_config: Any, name: str = "llama-hf",
                   **overrides) -> LlamaConfig:
    """The port's :class:`LlamaConfig` from a transformers
    ``LlamaConfig`` (or any object with its field names); ``overrides``
    replace fields (``dtype=torch.float32``)."""
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    explicit_hd = getattr(hf_config, "head_dim", None) or derived_hd
    if explicit_hd != derived_hd:
        raise ValueError(
            f"unsupported checkpoint: explicit head_dim={explicit_hd} != "
            f"hidden_size/num_heads={derived_hd} (this architecture "
            "derives head_dim; width-pruned checkpoints need resizing)")
    cfg = LlamaConfig(
        name=name,
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _tensor(t) -> torch.Tensor:
    """A checkpoint tensor (torch, or a numpy array) as a CPU tensor,
    without a copy where none is needed."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return torch.from_numpy(np.asarray(t))


def from_hf_state_dict(cfg: LlamaConfig,
                       state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF ``LlamaForCausalLM`` state dict → this port's state dict on
    the CPU: projections and the head transposed to (in, out) and cast
    to ``cfg.dtype``, the embedding cast, norm weights in f32."""

    def dense(key: str) -> torch.Tensor:
        w = _tensor(state[key])
        out = torch.empty((w.shape[1], w.shape[0]), dtype=cfg.dtype)
        return out.copy_(w.t())

    def norm(key: str) -> torch.Tensor:
        return _tensor(state[key]).to(torch.float32, copy=True)

    embed = _tensor(state["model.embed_tokens.weight"])
    out = {"embed": embed.to(cfg.dtype, copy=True),
           "final_norm.weight": norm("model.norm.weight"),
           "lm_head": (dense("lm_head.weight") if "lm_head.weight" in state
                       else dense("model.embed_tokens.weight"))}
    for i in range(cfg.n_layers):
        hf, ours = f"model.layers.{i}", f"layers.{i}"
        out.update({
            f"{ours}.attn_norm.weight": norm(f"{hf}.input_layernorm.weight"),
            f"{ours}.attn.wq": dense(f"{hf}.self_attn.q_proj.weight"),
            f"{ours}.attn.wk": dense(f"{hf}.self_attn.k_proj.weight"),
            f"{ours}.attn.wv": dense(f"{hf}.self_attn.v_proj.weight"),
            f"{ours}.attn.wo": dense(f"{hf}.self_attn.o_proj.weight"),
            f"{ours}.mlp_norm.weight": norm(
                f"{hf}.post_attention_layernorm.weight"),
            f"{ours}.mlp.w_gate": dense(f"{hf}.mlp.gate_proj.weight"),
            f"{ours}.mlp.w_up": dense(f"{hf}.mlp.up_proj.weight"),
            f"{ours}.mlp.w_down": dense(f"{hf}.mlp.down_proj.weight"),
        })
    return out


def from_hf_model(hf_model: Any, name: str = "llama-hf",
                  device: DeviceLike = "cuda", **overrides) -> Llama:
    """The port's :class:`Llama` on ``device`` (the card unless the
    caller asks for the CPU) with a live ``LlamaForCausalLM``'s weights
    (anything with ``.config`` and ``.state_dict()``)."""
    cfg = config_from_hf(hf_model.config, name=name, **overrides)
    model = Llama(cfg, device=device)
    model.load_state_dict(from_hf_state_dict(cfg, hf_model.state_dict()))
    return model


def from_hf_pretrained(path_or_repo: str, name: str = "llama-hf",
                       device: DeviceLike = "cuda", **overrides) -> Llama:
    """The port's :class:`Llama` from a local HF checkpoint directory (a
    ``save_pretrained`` output; a hub id where the host has network)."""
    from transformers import AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(path_or_repo)
    return from_hf_model(hf, name=name, device=device, **overrides)
