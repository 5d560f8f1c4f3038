"""The port's HF Llama import (``rocnrdma_tpu_torch.models.convert``)
against transformers and the JAX package's import.

A tiny randomly initialised ``transformers.LlamaForCausalLM`` (eager
attention, GQA and MHA; nothing downloaded) goes through both packages'
``convert``: the config field by field, the logits of HF, of the JAX
model and of the port's model (CPU, plain kernels) within the
reference's 2e-4, a tied-embedding checkpoint, greedy generation equal
to HF's, ``from_hf_pretrained`` from a local ``save_pretrained``
directory, and the explicit-``head_dim`` refusal.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from rocnrdma_tpu.models import convert as jconvert
from rocnrdma_tpu_torch.models import convert as tconvert
from rocnrdma_tpu_torch.models import llama as tllama

TOL = 2e-4


def _tiny_hf(tie=False, n_kv=2):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=n_kv, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tie, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


def _three_logits(hf, tokens):
    """HF's, the JAX import's and the port's import's logits (f32)."""
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    jm, jp = jconvert.from_hf_model(hf, dtype=jnp.float32)
    jax_logits = np.asarray(jm.apply(jp, jnp.asarray(tokens, jnp.int32)))
    port = tconvert.from_hf_model(hf, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        got = port(torch.from_numpy(tokens)).numpy()
    return ref, jax_logits, got


@pytest.mark.parametrize("n_kv", [2, 4])
def test_config_equals_the_jax_import(n_kv):
    hf = _tiny_hf(n_kv=n_kv)
    got = tconvert.config_from_hf(hf.config)
    want = jconvert.config_from_hf(hf.config)
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.head_dim == want.head_dim == 16
    assert (got.n_heads, got.n_kv_heads) == (4, n_kv)
    assert tconvert.config_from_hf(hf.config, dtype=torch.float32).dtype \
        == torch.float32


@pytest.mark.parametrize("n_kv", [2, 4])  # GQA and MHA
def test_logits_match_transformers_and_the_jax_import(n_kv):
    hf = _tiny_hf(n_kv=n_kv)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 17))
    ref, jax_logits, got = _three_logits(hf, tokens)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax_logits, rtol=TOL, atol=TOL)


def test_tied_embeddings_checkpoint():
    hf = _tiny_hf(tie=True)
    assert "lm_head.weight" not in hf.state_dict() or \
        hf.lm_head.weight.data_ptr() == hf.model.embed_tokens.weight.data_ptr()
    state = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    cfg = tconvert.config_from_hf(hf.config, dtype=torch.float32)
    sd = tconvert.from_hf_state_dict(cfg, state)
    assert torch.equal(sd["lm_head"], sd["embed"].t())
    tokens = np.ones((1, 7), dtype=np.int64)
    ref, jax_logits, got = _three_logits(hf, tokens)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax_logits, rtol=TOL, atol=TOL)
    untied = tllama.Llama(cfg, device="cpu")
    untied.load_state_dict(sd)
    with torch.inference_mode():
        no_head = untied(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(no_head, ref, rtol=TOL, atol=TOL)


def test_state_dict_layout_and_dtypes():
    """Projections transposed to (in, out) in ``cfg.dtype``, norms f32,
    every name of the port's model; numpy arrays convert like tensors."""
    hf = _tiny_hf()
    hf_sd = hf.state_dict()
    cfg = tconvert.config_from_hf(hf.config)            # bf16
    sd = tconvert.from_hf_state_dict(cfg, hf_sd)
    assert set(sd) == set(tllama.Llama(cfg, device="cpu").state_dict())
    w = hf_sd["model.layers.1.self_attn.k_proj.weight"]
    assert sd["layers.1.attn.wk"].shape == (64, 32)
    assert torch.equal(sd["layers.1.attn.wk"], w.t().to(torch.bfloat16))
    assert sd["layers.0.mlp_norm.weight"].dtype == torch.float32
    assert sd["embed"].dtype == sd["lm_head"].dtype == torch.bfloat16
    as_np = tconvert.from_hf_state_dict(
        cfg, {k: v.numpy() for k, v in hf_sd.items()})
    for k in sd:
        assert torch.equal(as_np[k], sd[k]), k


def test_greedy_generation_matches_transformers():
    hf = _tiny_hf()
    port = tconvert.from_hf_model(hf, dtype=torch.float32, device="cpu")
    prompt = np.asarray([[5, 9, 42, 7]])
    with torch.no_grad():
        ref = hf.generate(
            torch.from_numpy(prompt), max_new_tokens=8, do_sample=False,
            pad_token_id=0).numpy()[:, prompt.shape[1]:]
    got = tllama.generate(port, prompt, 8, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_from_hf_pretrained_loads_a_local_directory(tmp_path):
    hf = _tiny_hf(n_kv=4)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    assert (tmp_path / "model.safetensors").exists()
    got = tconvert.from_hf_pretrained(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    want = tconvert.from_hf_model(hf, dtype=torch.float32, device="cpu")
    assert got.cfg == want.cfg
    for (n, a), (m, b) in zip(got.state_dict().items(),
                              want.state_dict().items()):
        assert n == m and torch.equal(a, b), n


def test_explicit_head_dim_is_refused():
    like = types.SimpleNamespace(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, head_dim=32)
    with pytest.raises(ValueError) as got:
        tconvert.config_from_hf(like)
    with pytest.raises(ValueError) as want:
        jconvert.config_from_hf(like)
    assert str(got.value) == str(want.value)
    assert "explicit head_dim=32 != hidden_size/num_heads=16" in str(got.value)
