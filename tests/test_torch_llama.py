"""The port's Llama (rocnrdma_tpu_torch.models.llama) against flax.

llama-tiny in f32 (H=4 query heads over KVH=2 kv heads, so the GQA
mapping q head h → kv head h // 2 is exercised), with the JAX package's
own ``init_params(PRNGKey(0))`` weights carried over by
``params_from_flax``. On the CPU the port runs its kernels' plain
versions. Logits are held to 2e-4 (the JAX package's own tolerance for
cached-vs-full forwards), greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu_torch.models import llama as tllama

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def tiny():
    model = jllama.make_model("llama-tiny")
    params = jllama.init_params(model, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    port.load_state_dict(tllama.params_from_flax(tree))
    return model, params, tree, port


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 255, shape).astype(
        np.int32)


def test_configs_mirror_the_jax_package():
    for name, jc in jllama.CONFIGS.items():
        tc = tllama.CONFIGS[name]
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.head_dim == jc.head_dim
        assert tc.param_count() == jc.param_count()
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


def test_rope_matches_flax():
    freqs_j = np.asarray(jllama.rope_freqs(16, 40, 500000.0))
    freqs_t = tllama.rope_freqs(16, 40, 500000.0)
    np.testing.assert_allclose(freqs_t.numpy(), freqs_j, rtol=1e-6,
                               atol=1e-6)
    x = np.random.default_rng(0).standard_normal((1, 2, 40, 16)).astype(
        np.float32)
    want = np.asarray(jllama.apply_rope(jnp.asarray(x), jnp.asarray(freqs_j)))
    got = tllama.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(np.array(freqs_j)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pallas", [False, True])
def test_full_forward_logits_match_flax(tiny, pallas):
    """Full (no-cache) forward; the JAX side once through its XLA
    reference and once through its Pallas kernels in interpret mode."""
    model, params, _, port = tiny
    if pallas:
        model = jllama.make_model("llama-tiny", use_pallas_attention=True,
                                  use_pallas_rmsnorm=True,
                                  pallas_interpret=True)
    tok = _tokens(0, (2, 12))
    want = np.asarray(model.apply(params, jnp.asarray(tok)))
    with torch.inference_mode():
        got = port(torch.from_numpy(tok).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cached_prefill_and_decode_match_flax(tiny):
    """Prefill 8 tokens at pos 0 (the K3 path), then three single-token
    decode steps against the cache (the plain GQA path)."""
    model, params, _, port = tiny
    tok = _tokens(1, (2, 11))
    jcache = jllama.init_cache(model.cfg, 2, 64)
    tcache = tllama.init_cache(port.cfg, 2, 64, device="cpu")
    with torch.inference_mode():
        want, jcache = model.apply(params, jnp.asarray(tok[:, :8]),
                                   cache=jcache, pos=0)
        got = port(torch.from_numpy(tok[:, :8]).long(), tcache, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for i in range(8, 11):
            want, jcache = model.apply(params, jnp.asarray(tok[:, i:i + 1]),
                                       cache=jcache, pos=i)
            got = port(torch.from_numpy(tok[:, i:i + 1]).long(), tcache, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tcache[0]["k"].numpy(), np.asarray(jcache["layer_0"]["k"]), **TOL)


def test_chunked_cached_forward_matches_flax(tiny):
    """A multi-token chunk at pos > 0 takes the plain cached product with
    its causal mask (query rows folded per kv group)."""
    model, params, _, port = tiny
    tok = _tokens(5, (2, 9))
    jcache = jllama.init_cache(model.cfg, 2, 64)
    tcache = tllama.init_cache(port.cfg, 2, 64, device="cpu")
    _, jcache = model.apply(params, jnp.asarray(tok[:, :6]), cache=jcache,
                            pos=0)
    want, _ = model.apply(params, jnp.asarray(tok[:, 6:]), cache=jcache,
                          pos=6)
    with torch.inference_mode():
        port(torch.from_numpy(tok[:, :6]).long(), tcache, 0)
        got = port(torch.from_numpy(tok[:, 6:]).long(), tcache, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cached_prefill_equals_full_forward(tiny):
    """The cached prefill at pos 0 is the same function as the full
    causal forward (the equality the JAX package's tests pin)."""
    _, _, _, port = tiny
    tok = torch.from_numpy(_tokens(2, (2, 12))).long()
    cache = tllama.init_cache(port.cfg, 2, 64, device="cpu")
    with torch.inference_mode():
        torch.testing.assert_close(port(tok, cache, 0), port(tok), **TOL)


def test_generate_greedy_matches_jax(tiny):
    model, params, _, port = tiny
    prompt = _tokens(3, (2, 5))
    want = np.asarray(jllama.generate(model, params, jnp.asarray(prompt),
                                      max_new_tokens=6))
    got = tllama.generate(port, prompt, 6, device="cpu")
    assert got.dtype == torch.long and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampling_is_seeded_and_bounds_checked(tiny):
    _, _, _, port = tiny
    prompt = _tokens(4, (2, 4))
    runs = [tllama.generate(port, prompt, 5, temperature=1.0,
                            generator=torch.Generator().manual_seed(s),
                            device="cpu") for s in (7, 7, 8)]
    torch.testing.assert_close(runs[0], runs[1])
    assert int(runs[0].max()) < port.cfg.vocab_size
    assert tllama.generate(port, prompt, 0, device="cpu").shape == (2, 0)
    with pytest.raises(ValueError, match="max_seq_len"):
        tllama.generate(port, prompt, port.cfg.max_seq_len, device="cpu")


def test_weight_bridge_round_trips(tiny):
    _, _, tree, port = tiny
    state = tllama.params_from_flax(tree)
    assert set(state) == set(port.state_dict())
    # flax Dense kernels stay (in, out): no transpose.
    assert tuple(state["layers.0.attn.wq"].shape) == tuple(
        tree["params"]["layer_0"]["attn"]["wq"]["kernel"].shape)
    back = tllama.params_to_flax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_weight_bridge_takes_bf16_leaves():
    cfg = dataclasses.replace(tllama.LLAMA_TINY, n_layers=1,
                              dtype=torch.bfloat16)
    jmodel = jllama.make_model("llama-tiny", n_layers=1, dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jmodel, jax.random.PRNGKey(1)))
    state = tllama.params_from_flax(tree)
    assert state["embed"].dtype == torch.bfloat16
    assert state["final_norm.weight"].dtype == torch.float32
    np.testing.assert_array_equal(
        state["embed"].float().numpy(),
        tree["params"]["embed"]["embedding"].astype(np.float32))
    port = tllama.Llama(cfg, device="cpu")
    port.load_state_dict(state)


def test_init_params_scales_and_seed():
    cfg = tllama.LLAMA_TINY
    a = tllama.init_params(cfg, seed=0, device="cpu")
    b = tllama.init_params(cfg, seed=0, device="cpu")
    c = tllama.init_params(cfg, seed=1, device="cpu")
    port = tllama.Llama(cfg, device="cpu")
    assert set(a) == set(port.state_dict())
    for name, t in a.items():
        torch.testing.assert_close(t, b[name])
        assert t.shape == port.state_dict()[name].shape
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert torch.equal(a["final_norm.weight"], torch.ones(cfg.d_model))
    std = float(a["layers.0.mlp.w_down"].std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert abs(float(a["embed"].std()) - cfg.d_model ** -0.5) < \
        0.1 * cfg.d_model ** -0.5
    port.load_state_dict(a, assign=True)
    with torch.inference_mode():
        assert torch.isfinite(port(torch.zeros(1, 4, dtype=torch.long))).all()
