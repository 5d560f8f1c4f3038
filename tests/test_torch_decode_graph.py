"""The port's compiled decode against the JAX package's, on the CPU.

The JAX package compiles its decode: ``generate`` jits prefill plus a
``lax.scan`` of steps with a traced ``pos``, and ``JitPagedDecoder``
jits the paged layer step. The port's counterparts are a static-shape
step (a 0-d ``pos`` tensor) captured as a CUDA graph on the card and run
uncaptured on the CPU, where these tests hold it against JAX: llama-tiny
and the serving tests' toy config, numpy inputs from a seed. Logits,
layer outputs and caches to 2e-4 (the JAX package's tolerance for
cached-vs-full forwards), greedy tokens exactly.
"""

import inspect
import os
import subprocess
import sys
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu.serving import batcher as jbatcher
from rocnrdma_tpu.serving import model as jmodel
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.serving import batcher as tbatcher
from rocnrdma_tpu_torch.serving import model as tmodel
from rocnrdma_tpu_torch.utils.graphs import CapturedStep

TOL = dict(rtol=2e-4, atol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _toy(pkg, seed=7):
    cfg = pkg.ServeConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq_len=32,
                          rope_theta=10000.0)
    return cfg, pkg.pack_pages(cfg, pkg.toy_param_tree(cfg, seed=seed))


def _scenario(b, req_cls):
    """R1 + R2 decode, R3 queues while full, R1 is evicted mid-stream
    and the freed slot admits R3 mid-run."""
    b.submit(req_cls(1, [3, 7, 11], 8))
    b.submit(req_cls(2, [9, 2], 6))
    for _ in range(3):
        b.step()
    b.submit(req_cls(3, [5, 1], 4))
    b.evict(1)
    b.run()
    return {rid: r.tokens for rid, r in sorted(b.finished.items())}


# ---------------------------------------------- the tensor-pos step


def test_tensor_pos_step_matches_jitted_flax(tiny):
    """``Llama.forward`` with a 0-d ``pos`` tensor (the captured step's
    forward) against ``model.apply`` under ``jax.jit`` with a traced
    ``pos``: a 5-token prefill, two single-token steps, then a 3-token
    chunk at pos 7; logits at every call and every layer's cache."""
    model, params, _, port = tiny
    tok = _tokens(11, (2, 10))
    step = jax.jit(lambda p, t, c, pos: model.apply(p, t, cache=c, pos=pos))
    jcache = jllama.init_cache(model.cfg, 2, 64)
    tcache = tllama.init_cache(port.cfg, 2, 64, device="cpu")
    with torch.inference_mode():
        for lo, hi in ((0, 5), (5, 6), (6, 7), (7, 10)):
            want, jcache = step(params, jnp.asarray(tok[:, lo:hi]), jcache,
                                jnp.asarray(lo, jnp.int32))
            got = port(torch.from_numpy(tok[:, lo:hi]).long(), tcache,
                       torch.tensor(lo))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(port.cfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                tcache[i][kv].numpy(),
                np.asarray(jcache[f"layer_{i}"][kv]), **TOL)


def test_tensor_pos_step_equals_int_pos_step(tiny):
    """The product over the whole cache (a tensor ``pos``) and over the
    cache prefix (an int ``pos``) give the same logits: the keys past
    the prefix are masked and weigh exactly zero."""
    _, _, _, port = tiny
    tok = torch.from_numpy(_tokens(12, (2, 9))).long()
    c_int = tllama.init_cache(port.cfg, 2, 64, device="cpu")
    c_ten = tllama.init_cache(port.cfg, 2, 64, device="cpu")
    with torch.inference_mode():
        port(tok[:, :6], c_int, 0)
        port(tok[:, :6], c_ten, 0)
        for i in range(6, 9):
            torch.testing.assert_close(
                port(tok[:, i:i + 1], c_ten, torch.tensor(i)),
                port(tok[:, i:i + 1], c_int, i), **TOL)


# ------------------------------------------------- compiled generate


def test_compiled_generate_matches_jax_generate(tiny):
    """The port's generate (prefill, then the decode loop's step, run
    uncaptured on the CPU) against the JAX generate's jitted scan:
    greedy tokens exact, at two batch sizes and twice per shape (the
    second call through the memoized loop)."""
    model, params, _, port = tiny
    for b, p, new in ((3, 7, 9), (1, 20, 12)):
        prompt = _tokens(20 + b, (b, p))
        want = np.asarray(jllama.generate(model, params, jnp.asarray(prompt),
                                          max_new_tokens=new))
        for _ in range(2):
            got = tllama.generate(port, prompt, new, device="cpu")
            assert got.dtype == torch.long and tuple(got.shape) == (b, new)
            np.testing.assert_array_equal(got.numpy(), want)


def test_decode_loop_uncaptured_equals_generate(tiny):
    """``DecodeLoop(capture=False)`` drives the same step by hand: the
    tokens ``generate`` returns, greedy and sampled with one seed."""
    _, _, _, port = tiny
    prompt = torch.from_numpy(_tokens(30, (2, 6))).long()
    for temp in (0.0, 0.8):
        want = tllama.generate(port, prompt, 7, temperature=temp,
                               generator=torch.Generator().manual_seed(3),
                               device="cpu")
        loop = tllama.DecodeLoop(port, 2, 128, temperature=temp,
                                 capture=False)
        got = loop.run(prompt, 7, torch.Generator().manual_seed(3))
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_generate_sampling_advances_the_callers_generator(tiny):
    """The loop draws through its own generator, with the caller's state
    copied in and written back: two calls on one generator continue its
    stream (the second call's tokens differ from the first's), and the
    same two calls from the same seed repeat both."""
    _, _, _, port = tiny
    prompt = _tokens(31, (2, 4))

    def two_calls():
        gen = torch.Generator().manual_seed(11)
        return [tllama.generate(port, prompt, 6, temperature=1.0,
                                generator=gen, device="cpu")
                for _ in range(2)]

    first, second = two_calls()
    assert not torch.equal(first, second)
    for got, want in zip(two_calls(), (first, second)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_generate_memo_reuse_fifo_and_parameter_swap(tiny):
    """One entry per key, reused by a second call; the 33rd distinct key
    evicts the oldest; ``load_state_dict(assign=True)`` moves the
    parameters' storage, so the next call makes a new entry and its
    tokens follow the new weights."""
    _, _, tree, port = tiny
    memo = tllama._GEN_CACHE
    memo.clear()
    prompt = _tokens(40, (2, 5))
    first = tllama.generate(port, prompt, 4, device="cpu")
    (key, loop), = memo.items()
    again = tllama.generate(port, prompt, 6, device="cpu")
    assert list(memo.items()) == [(key, loop)]
    torch.testing.assert_close(again[:, :4], first, rtol=0, atol=0)

    for b in range(3, 3 + tllama._GEN_CACHE_MAX):        # 32 more keys
        tllama.generate(port, _tokens(b, (b, 3)), 1, device="cpu")
    assert len(memo) == tllama._GEN_CACHE_MAX and key not in memo

    other = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    other.load_state_dict(tllama.init_params(tllama.LLAMA_TINY, seed=5,
                                             device="cpu"))
    want = tllama.generate(other, prompt, 6, device="cpu")
    swap = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    swap.load_state_dict(tllama.params_from_flax(tree))
    old = tllama.generate(swap, prompt, 6, device="cpu")
    n = len(memo)
    entries = set(map(id, memo.values()))
    swap.load_state_dict(dict(other.state_dict()), assign=True)
    got = tllama.generate(swap, prompt, 6, device="cpu")
    assert len(memo) == n and not {id(v) for v in memo.values()} <= entries
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, old)
    memo.clear()


def test_generate_memo_bytes_bounded_over_fresh_generators(tiny):
    """40 calls, each with a fresh generator, greedy and sampled: the
    generator is not part of the key, so the memo holds one loop per
    temperature and its static bytes do not grow."""
    _, _, _, port = tiny
    memo = tllama._GEN_CACHE
    memo.clear()
    prompt = _tokens(41, (2, 5))
    sizes = []
    for i in range(40):
        tllama.generate(port, prompt, 4, temperature=0.8 * (i % 2),
                        generator=torch.Generator().manual_seed(i),
                        device="cpu")
        sizes.append(sum(loop.nbytes for loop in memo.values()))
    assert len(memo) == 2 and sizes[2:] == [sizes[1]] * 38
    memo.clear()


def test_generate_memo_drops_dead_models_and_bounds_bytes(tiny, monkeypatch):
    """A loop goes from the memo, and is freed, as soon as its model is
    deleted; and a new loop that would take the memo's static bytes past
    ``_GEN_CACHE_MAX_BYTES`` evicts the oldest first."""
    _, _, tree, _ = tiny
    memo = tllama._GEN_CACHE
    memo.clear()
    model = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    model.load_state_dict(tllama.params_from_flax(tree))
    tllama.generate(model, _tokens(42, (2, 5)), 3, device="cpu")
    (loop,) = memo.values()
    freed = weakref.ref(loop)
    del loop, model
    assert not memo and freed() is None

    model = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    model.load_state_dict(tllama.params_from_flax(tree))
    tllama.generate(model, _tokens(43, (1, 5)), 3, device="cpu")
    (one,) = memo.values()
    monkeypatch.setattr(tllama, "_GEN_CACHE_MAX_BYTES", 2 * one.nbytes)
    tllama.generate(model, _tokens(44, (2, 5)), 3, device="cpu")
    assert [loop.tok.shape[0] for loop in memo.values()] == [2]
    memo.clear()


def test_captured_step_runs_uncaptured_on_the_cpu():
    calls = []
    step = CapturedStep(lambda: calls.append(1), torch.device("cpu"))
    for _ in range(3):
        step()
    assert calls == [1, 1, 1] and step.graph is None


def test_launch_tally_is_per_thread():
    """Inside ``tally_launches`` this thread's counts go to the tally
    (a capture records launches, it does not make them); another
    thread's launches meanwhile still count in ``launches()``."""
    _native.reset_launches()
    with _native.tally_launches() as tally:
        _native.count("rmsnorm_fwd")
        _native.count("rmsnorm_fwd", 2)
        other = threading.Thread(target=_native.count, args=("flash_fwd",))
        other.start()
        other.join()
    _native.count("rmsnorm_fwd")
    assert tally == {"rmsnorm_fwd": 3}
    assert _native.launches()["rmsnorm_fwd"] == 1
    assert _native.launches()["flash_fwd"] == 1
    _native.reset_launches()


# ------------------------------------------------- JitPagedDecoder


def test_jit_paged_decoder_matches_jax_jit_and_numpy_decoders():
    """Layer by layer on the same page bytes: a 5-token prefill (the
    eager layer, K3 on the card) and three decode steps (the step the
    card captures), against the JAX ``JitPagedDecoder`` (jitted, donated
    caches) and the numpy ``PagedDecoder``; layer outputs, logits and
    every layer's cache to 2e-4."""
    jcfg, jpages = _toy(jmodel, seed=3)
    tcfg, tpages = _toy(tmodel, seed=3)
    jd, nd = jmodel.JitPagedDecoder(jcfg), jmodel.PagedDecoder(jcfg)
    td = tmodel.JitPagedDecoder(tcfg, "cpu")
    jc = [jd.new_cache() for _ in range(jcfg.n_layers)]
    nc = [nd.new_cache() for _ in range(jcfg.n_layers)]
    tc = [td.new_cache() for _ in range(tcfg.n_layers)]
    pos = 0
    for t in ([1, 2, 3, 4, 5], [6], [7], [8]):
        xj = jd.embed(jpages.pages[0], np.array(t))
        xn = nd.embed(jpages.pages[0], np.array(t))
        xt = td.embed(td.upload(tpages.pages[0]), np.array(t))
        for li in range(jcfg.n_layers):
            xj = jd.layer(jpages.pages[1 + li], xj, jc[li], pos)
            xn = nd.layer(jpages.pages[1 + li], xn, nc[li], pos)
            xt = td.layer(td.upload(tpages.pages[1 + li]), xt, tc[li], pos)
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
            np.testing.assert_allclose(xt.numpy(), xn, **TOL)
        lt = td.head(td.upload(tpages.pages[-1]), xt)
        np.testing.assert_allclose(lt.numpy(), jd.head(jpages.pages[-1], xj),
                                   **TOL)
        pos += len(t)
    for li in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tc[li][kv].numpy(),
                                       np.asarray(jc[li][kv]), **TOL)
            np.testing.assert_allclose(tc[li][kv].numpy(), nc[li][kv],
                                       **TOL)
    dumped = td.dump_kv(tc[0], pos)
    np.testing.assert_allclose(dumped, jd.dump_kv(jc[0], pos), **TOL)
    td.release_cache(tc[0])
    fresh = td.new_cache()                   # the pooled pair, zeroed
    assert fresh is tc[0] and not bool(fresh["k"].any())
    half = dumped.size // 2
    shape = (tcfg.n_kv_heads, pos, tcfg.head_dim)
    td.load_kv(fresh, dumped[:half].reshape(shape),
               dumped[half:].reshape(shape), pos)
    np.testing.assert_array_equal(td.dump_kv(fresh, pos), dumped)


class _SyncJitDecoder(jmodel.JitPagedDecoder):
    """The JAX ``JitPagedDecoder``, returning once each jitted call has
    run (so it has read its page)."""

    def embed(self, embed_page, tokens):
        return jax.block_until_ready(super().embed(embed_page, tokens))

    def layer(self, layer_page, x, cache, pos):
        return jax.block_until_ready(super().layer(layer_page, x, cache,
                                                   pos))


@pytest.mark.parametrize("prefetch", [False, True])
def test_jit_batcher_tokens_equal_jax_jit_batcher(prefetch):
    """Loopback ``ContinuousBatcher(jit_decode=True)`` in both packages
    over the same pages and join/evict churn: equal tokens, a request
    evicted mid-stream and one joining mid-run; and equal to the port's
    eager batcher.

    The JAX decoder waits for each jitted call (``_SyncJitDecoder``):
    its layer reads the streamer's window, a numpy view that the CPU
    client may alias, and the batcher releases the window to the next
    fetch once the call is dispatched, so under asynchronous dispatch
    the JAX tokens change from run to run. The port's ``upload`` copies
    before the release."""
    jcfg, jpages = _toy(jmodel)
    tcfg, tpages = _toy(tmodel)
    jb = jbatcher.ContinuousBatcher(None, jpages, jcfg, max_slots=2,
                                    prefetch=prefetch, jit_decode=True)
    assert isinstance(jb.decoder, jmodel.JitPagedDecoder)
    jb.decoder = _SyncJitDecoder(jcfg)
    want = _scenario(jb, jbatcher.Request)
    jb.close()
    tb = tbatcher.ContinuousBatcher(None, tpages, tcfg, max_slots=2,
                                    prefetch=prefetch, jit_decode=True,
                                    device="cpu")
    assert isinstance(tb.decoder, tmodel.JitPagedDecoder)
    got = _scenario(tb, tbatcher.Request)
    tb.close()
    assert got == want
    assert tb.finished[1].evicted and 0 < len(got[1]) < 8
    assert tb.finished[3].joined_step > 0 and len(got[3]) == 4
    eager = tbatcher.ContinuousBatcher(None, tpages, tcfg, max_slots=2,
                                       prefetch=prefetch, device="cpu")
    assert _scenario(eager, tbatcher.Request) == got
    eager.close()


def test_jit_decoder_cache_pool_stays_bounded():
    """12 requests through 4 slots: the pool never holds more than
    4 × n_layers pairs, one decode step each; a pool at its bound
    refuses another pair, and a foreign or twice-released cache is
    refused."""
    tcfg, tpages = _toy(tmodel)
    b = tbatcher.ContinuousBatcher(None, tpages, tcfg, max_slots=4,
                                   jit_decode=True, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(12):
        b.submit(tbatcher.Request(i + 1, rng.integers(0, 64, 2 + i % 5),
                                  3 + i % 4))
        if i % 3 == 2:
            b.step()
    b.run()
    b.close()
    dec = b.decoder
    bound = 4 * tcfg.n_layers
    pair = 2 * tcfg.n_kv_heads * tcfg.max_seq_len * tcfg.head_dim * 4
    assert len(b.finished) == 12
    assert dec.pool_bytes <= bound * pair and len(dec._steps) <= bound
    assert len(dec._free) == len(dec._caches)       # every pair returned
    caches = [dec.new_cache() for _ in range(len(dec._caches))]
    caches += [dec.new_cache() for _ in range(bound - len(caches))]
    with pytest.raises(RuntimeError, match="in use"):
        dec.new_cache()
    dec.release_cache(caches[0])
    with pytest.raises(ValueError, match="twice"):
        dec.release_cache(caches[0])
    foreign = tmodel.PagedDecoder(tcfg, "cpu").new_cache()
    with pytest.raises(ValueError, match="not one of"):
        dec.layer(dec.upload(tpages.pages[1]), torch.zeros(1, tcfg.d_model),
                  foreign, 0)


def test_batcher_arguments_keep_the_jax_positional_order():
    """``jit_decode`` sits after ``prefetch`` as in the JAX batcher; the
    port's ``device`` comes last."""
    jax_args = list(inspect.signature(
        jbatcher.ContinuousBatcher.__init__).parameters)
    port_args = list(inspect.signature(
        tbatcher.ContinuousBatcher.__init__).parameters)
    assert port_args == jax_args + ["device"]
    tcfg, tpages = _toy(tmodel)
    b = tbatcher.ContinuousBatcher(None, tpages, tcfg, 2, None, False, True,
                                   "cpu")
    assert isinstance(b.decoder, tmodel.JitPagedDecoder)
    assert b.max_slots == 2 and not b.prefetch
    b.close()


def test_generate_text_example_on_the_cpu():
    """``examples/generate_text_torch.py --cpu``: generate twice (the
    second through the memo), then the prompt through the jit batcher,
    whose greedy tokens it asserts equal to generate's."""
    proc = subprocess.run(
        [sys.executable, "examples/generate_text_torch.py", "--cpu",
         "--config", "llama-tiny", "--new", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "steady:" in proc.stdout and "marginal" in proc.stdout
    assert "batcher tokens equal to generate's: 8/8" in proc.stdout
