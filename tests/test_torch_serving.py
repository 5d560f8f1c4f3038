"""The port's serving path (rocnrdma_tpu_torch.serving) against the JAX
package's.

Loopback (``world=None``) only: the port's wire mode waits for the
transport port. On the CPU the port's decoder runs its kernels' plain
versions in f32; tokens are held equal to the JAX package's numpy
decoder and to the port's own ``generate``.
"""

import jax
import numpy as np
import pytest
import torch

from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu.serving import batcher as jbatcher
from rocnrdma_tpu.serving import model as jmodel
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.serving import model as tmodel
from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher, Request
from rocnrdma_tpu_torch.serving.stream import (CreditGate, TransferEngine,
                                               make_stream_coll,
                                               stream_coll_request,
                                               stream_coll_seq)


def _toy(pkg, seed=7):
    cfg = pkg.ServeConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq_len=32,
                          rope_theta=10000.0)
    return cfg, pkg.pack_pages(cfg, pkg.toy_param_tree(cfg, seed=seed))


def _scenario(b, req_cls):
    """Join/evict churn (tests/test_serving.py's): R1+R2 decode, R3
    queues while full, R1 is evicted mid-stream, the freed slot admits
    R3 mid-stream."""
    b.submit(req_cls(1, [3, 7, 11], 8))
    b.submit(req_cls(2, [9, 2], 6))
    for _ in range(3):
        b.step()
    b.submit(req_cls(3, [5, 1], 4))
    b.evict(1)
    b.run()
    return {rid: r.tokens for rid, r in sorted(b.finished.items())}


def test_page_layout_is_byte_identical():
    jcfg, jpages = _toy(jmodel)
    tcfg, tpages = _toy(tmodel)
    assert tmodel.page_names(tcfg) == jmodel.page_names(jcfg)
    assert len(tpages) == len(jpages)
    for a, b in zip(tpages.pages, jpages.pages):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prefetch", [False, True])
def test_batcher_tokens_equal_jax_batcher(prefetch):
    """Same pages, same join/evict sequence: the port's batcher (torch
    decoder) and the JAX package's (numpy decoder) give equal tokens."""
    jcfg, jpages = _toy(jmodel)
    tcfg, tpages = _toy(tmodel)
    jb = jbatcher.ContinuousBatcher(None, jpages, jcfg, max_slots=2)
    want = _scenario(jb, jbatcher.Request)
    jb.close()
    tb = ContinuousBatcher(None, tpages, tcfg, max_slots=2,
                           prefetch=prefetch, device="cpu")
    got = _scenario(tb, Request)
    tb.close()
    assert got == want
    assert tb.finished[1].evicted and 0 < len(got[1]) < 8
    assert tb.finished[3].joined_step > 0 and len(got[3]) == 4
    s = tb.streamer.stats()
    assert s["acquired"] == s["released"] and s["in_flight"] == 0, s


def test_batcher_requeued_eviction_before_admission():
    tcfg, tpages = _toy(tmodel)
    b = ContinuousBatcher(None, tpages, tcfg, max_slots=1, device="cpu")
    b.submit(Request(1, [4], 3))
    b.submit(Request(2, [5], 3))
    b.evict(2)
    b.run()
    b.close()
    assert b.finished[2].evicted and b.finished[2].tokens == []
    assert len(b.finished[1].tokens) == 3


def test_paged_decoder_matches_numpy_decoder():
    """Layer by layer on the same page bytes: prefill of 5 tokens at
    pos 0 (the K3 path) and two decode steps (plain GQA), f32, 1e-5."""
    jcfg, jpages = _toy(jmodel, seed=3)
    tcfg, tpages = _toy(tmodel, seed=3)
    nd, td = jmodel.PagedDecoder(jcfg), tmodel.PagedDecoder(tcfg, "cpu")
    toks = [[1, 2, 3, 4, 5], [6], [7]]
    jc = [nd.new_cache() for _ in range(jcfg.n_layers)]
    tc = [td.new_cache() for _ in range(tcfg.n_layers)]
    pos = 0
    for t in toks:
        xj = nd.embed(jpages.pages[0], np.array(t))
        xt = td.embed(td.upload(tpages.pages[0]), np.array(t))
        for li in range(jcfg.n_layers):
            xj = nd.layer(jpages.pages[1 + li], xj, jc[li], pos)
            xt = td.layer(td.upload(tpages.pages[1 + li]), xt, tc[li], pos)
            np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5, atol=1e-5)
        lj = nd.head(jpages.pages[-1], xj)
        lt = td.head(td.upload(tpages.pages[-1]), xt)
        np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5, atol=1e-5)
        pos += len(t)
    dumped = td.dump_kv(tc[0], pos)
    assert isinstance(dumped, np.ndarray)
    np.testing.assert_allclose(dumped, nd.dump_kv(jc[0], pos), rtol=1e-5,
                               atol=1e-5)
    fresh = td.new_cache()
    half = dumped.size // 2
    shape = (tcfg.n_kv_heads, pos, tcfg.head_dim)
    td.load_kv(fresh, dumped[:half].reshape(shape),
               dumped[half:].reshape(shape), pos)
    np.testing.assert_array_equal(td.dump_kv(fresh, pos), dumped)


def test_upload_copies_so_the_window_can_be_reused():
    tcfg, tpages = _toy(tmodel)
    td = tmodel.PagedDecoder(tcfg, "cpu")
    page = tpages.pages[1].copy()
    dev = td.upload(page)
    page[:] = 0.0
    np.testing.assert_array_equal(dev.numpy(), tpages.pages[1])


def test_batcher_matches_generate_on_flax_weights():
    """llama-tiny from the JAX package's init_params: pages packed from
    the port's state dict (params_to_flax) decode the same greedy tokens
    as the port's generate, which equals the JAX generate (see
    test_torch_llama.py); a second request joins mid-run."""
    jm = jllama.make_model("llama-tiny")
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jm, jax.random.PRNGKey(0)))
    state = tllama.params_from_flax(tree)
    port = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    port.load_state_dict(state)
    cfg = tmodel.ServeConfig.from_llama(tllama.LLAMA_TINY)
    pages = tmodel.pack_llama_params(cfg, tllama.params_to_flax(state))
    jpages = jmodel.pack_llama_params(jmodel.ServeConfig.from_llama(
        jllama.LLAMA_TINY), tree)
    for a, b in zip(pages.pages, jpages.pages):
        np.testing.assert_array_equal(a, b)
    prompts = {1: [5, 9, 42, 7], 2: [3, 1, 4, 1, 5, 9]}
    b = ContinuousBatcher(None, pages, cfg, max_slots=2, device="cpu")
    b.submit(Request(1, prompts[1], 8))
    b.step()
    b.submit(Request(2, prompts[2], 5))
    b.run()
    b.close()
    assert b.finished[2].joined_step > 0
    for rid, p in prompts.items():
        n = len(b.finished[rid].tokens)
        want = tllama.generate(port, [p], n, device="cpu")[0].tolist()
        assert b.finished[rid].tokens == want
    assert len(b.token_lat_us) == 8 + 5


def test_stream_copies_keep_their_contracts():
    gate = CreditGate(2, name="t")
    assert gate.acquire() and gate.acquire()
    assert not gate.acquire(timeout_s=0.01)
    gate.release()
    gate.release()
    with pytest.raises(RuntimeError, match="underflow"):
        gate.release()
    eng = TransferEngine(depth=1, name="t")
    with pytest.raises(ValueError):
        eng.submit(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert eng.gate.in_flight == 0
    inf = eng.submit(lambda: None)
    assert inf.done and eng.live == 0
    eng.close()
    coll = make_stream_coll(123, 456)
    assert (stream_coll_request(coll), stream_coll_seq(coll)) == (123, 456)
