"""The latent-attention, routed-expert model (``models/mla_moe.py``), K7
(``ops/mla_decode.py``) and the expert layer (``ops/moe.py``) against
the plain float32 reference (``benchmark/reference/mla_moe_ref.py``) and
their plain versions.

The CPU cases run at a tiny size in float32 (3 layers: 1 dense and 2 of
8 experts, 2 a token, 1 shared) on the benchmark's seeded weights. The
``gpu`` cases run only on an NVIDIA card (K7 and the grouped GEMMs have
no CPU mode) and skip, with their reason, elsewhere; the file imports
nothing of JAX:

    python -m pytest tests/test_torch_mla_moe.py -m gpu

Tolerances, with their reasons. The program and the reference compute
the same equations in float32 in another order of sums (the router's
product, the experts' sums, the absorbed decode's products through the
latent): their logits, of size ~4, agree to a few f32 steps. rtol 1e-5
with an atol of 2e-5 holds that, and bf16 arithmetic, whose steps are
2^-8 of a value, fails it (:func:`test_bf16_fails_the_tolerance`).
"""

import math

import pytest
import torch

from benchmark import weights_mla
from benchmark.reference import mla_moe_ref
from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.models import mla_moe
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops import mla_decode as mld
from rocnrdma_tpu_torch.ops import moe

TINY = {
    "name": "tiny-mla", "vocab_size": 256, "hidden_size": 64,
    "num_hidden_layers": 3, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
    "moe_intermediate_size": 24, "n_routed_experts": 8,
    "n_shared_experts": 1, "num_experts_per_tok": 2,
    "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
    "max_position_embeddings": 128, "rope_theta": 50000,
    "rms_norm_eps": 1e-05, "torch_dtype": "float32", "q_lora_rank": None,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "norm_topk_prob": True}
TOL = dict(rtol=1e-5, atol=2e-5)
SEED = 2 ** 31 + 23


def _model(cfg_json=TINY, seed=SEED, device="cpu", dtype=None):
    overrides = {} if dtype is None else {"dtype": dtype}
    cfg = mla_moe.MlaMoeConfig.from_hf(cfg_json, **overrides)
    model = mla_moe.MlaMoe(cfg, device)
    for group in weights_mla.draw_all(cfg_json, seed, device, cfg.dtype):
        model.load_state_dict(group, strict=False)
    return model


def _tokens(b, s, seed=1, vocab=256):
    return torch.randint(0, vocab, (b, s),
                         generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------- CPU


def test_config_from_published_keys_and_refusals():
    cfg = mla_moe.MlaMoeConfig.from_hf(TINY)
    assert (cfg.qk_head_dim, cfg.cache_width, cfg.top_k) == (24, 40, 2)
    for key, bad in (("q_lora_rank", 1536), ("scoring_func", "softmax"),
                     ("n_group", 8), ("rope_scaling", {"type": "yarn"})):
        with pytest.raises(ValueError, match=key):
            mla_moe.MlaMoeConfig.from_hf(dict(TINY, **{key: bad}))


def test_no_cache_forward_matches_the_reference():
    model = _model()
    tok = _tokens(2, 40)
    with torch.no_grad():
        got = model(tok)
    want = mla_moe_ref.forward(TINY, SEED, [tok[0], tok[1]], torch.float32,
                               "cpu")
    assert got.shape == (2, 40, 256) and got.dtype == torch.float32
    for j in range(2):
        torch.testing.assert_close(got[j], want[j]["f32"], **TOL)


def test_bf16_fails_the_tolerance():
    """The same forward with bf16 weights and activations lies outside
    the tolerance: it can tell bf16 arithmetic from f32."""
    model = _model(dtype=torch.bfloat16)
    tok = _tokens(2, 40)
    with torch.no_grad():
        got = model(tok)
    want = mla_moe_ref.forward(TINY, SEED, [tok[0], tok[1]], torch.float32,
                               "cpu")
    assert not torch.allclose(got[0], want[0]["f32"], **TOL)


def test_init_params_follows_the_ports_scheme():
    cfg = mla_moe.MlaMoeConfig.from_hf(TINY)
    params = mla_moe.init_params(cfg, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        mla_moe.param_shapes(cfg)
    assert torch.equal(params["layers.1.moe.router_bias"], torch.zeros(8))
    assert torch.equal(params["layers.2.attn.kv_norm.weight"],
                       torch.ones(32))
    w = params["layers.1.moe.w_up"]
    assert float(w.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    model = mla_moe.MlaMoe(cfg, "cpu")
    model.load_state_dict(params)


def test_cache_holds_the_latent():
    model = _model()
    cache = model.init_cache(3, 64)
    assert [list(c) for c in cache] == [["ckv"]] * 3
    assert cache[0]["ckv"].shape == (3, 64, 40)
    assert model.cache_nbytes(3, 64) == sum(
        t.nbytes for c in cache for t in c.values())
    big = mla_moe.MlaMoe.__new__(mla_moe.MlaMoe)
    big.cfg = mla_moe.MOONLIGHT_16B
    # 1,152 bytes a position a layer at Moonlight's widths.
    assert big.cache_nbytes(1, 1) == 27 * 1152


def test_prefill_and_decode_steps_match_the_full_forward(monkeypatch):
    """``generate``'s path by hand, uncaptured: the prefill at int pos 0
    (in chunks of 2 rows and 1), then one-token steps at a 0-d tensor pos
    through the absorbed form, each step's logits against the
    reference's full forward at that position."""
    monkeypatch.setattr(mla_moe, "PREFILL_TOKENS", 40)
    model = _model()
    b, p, new = 3, 17, 6
    prompt = _tokens(b, p, seed=2)
    cache = model.init_cache(b, 32)
    got, toks = [], []
    with torch.no_grad():
        logits = model(prompt, cache, 0)
        pos = torch.tensor(p)
        for _ in range(new):
            got.append(logits[:, -1])
            toks.append(logits[:, -1].argmax(-1))
            logits = model(toks[-1][:, None], cache, pos)
            pos += 1
    served = torch.stack(toks, 1)
    want = mla_moe_ref.served_logits(TINY, SEED, [(prompt[r], served[r])
                                                  for r in range(b)],
                                     torch.float32, "cpu")
    for r in range(b):
        torch.testing.assert_close(torch.stack([g[r] for g in got]),
                                   want[r]["f32"], **TOL)
    # The same tokens through generate (its DecodeLoop, uncaptured here).
    assert torch.equal(llama.generate(model, prompt, new, device="cpu"),
                       served)


def _plain_over_cache(attn, q_nope, q_pe, c_all, k_pe_all, q_pos):
    """The non-absorbed form for queries at ``q_pos`` over a cached
    prefix: keys and values expanded from the latent at every cached
    position, f32 scores, each query up to its own position."""
    cfg = attn.cfg
    b, t, _ = c_all.shape
    kv = (c_all @ attn.wkvb).view(b, t, cfg.n_heads, -1).transpose(1, 2)
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    sc = (q_nope.float() @ k_nope.float().transpose(-1, -2)
          + q_pe.float() @ k_pe_all[:, None].float().transpose(-1, -2))
    sc = sc / math.sqrt(cfg.qk_head_dim)
    hidden = torch.arange(t)[None, :] > q_pos[:, None]
    p = sc.masked_fill(hidden, float("-inf")).softmax(-1).to(v.dtype)
    o = (p.float() @ v.float()).to(v.dtype)
    return o.transpose(1, 2).reshape(b, q_pos.numel(), -1)


def test_absorbed_decode_equals_plain_attention_over_the_cache():
    """One position through W_UK, the latent cache and W_UV against the
    plain form (keys and values expanded from the same cache)."""
    model = _model()
    attn = model.layers[1].attn
    cfg = model.cfg
    b, p = 2, 23
    cache = model.init_cache(b, 32)[1]
    h = torch.randn(b, p + 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        attn(h[:, :p], model.freqs, cache, 0)
        q_pos = torch.tensor([p])
        q_nope, q_pe, c, k_pe = attn._project(
            h[:, p:], model.freqs.index_select(0, q_pos))
        cache["ckv"].index_copy_(1, q_pos, torch.cat([c, k_pe], -1))
        absorbed = attn._absorbed(q_nope, q_pe, cache["ckv"], q_pos)
        c_all, k_all = cache["ckv"][:, :p + 1].split([32, 8], -1)
        plain = _plain_over_cache(attn, q_nope, q_pe, c_all, k_all, q_pos)
    torch.testing.assert_close(absorbed, plain, **TOL)


@pytest.mark.parametrize("s,pos", [(3, 5), (2, torch.tensor(4))])
def test_cached_forward_refuses_what_no_path_runs(s, pos):
    """With a cache the model runs a prompt at int pos 0 or one new
    position at a tensor pos; several positions after cached ones raise
    rather than take an untested form."""
    model = _model()
    cache = model.init_cache(2, 32)
    with torch.no_grad(), pytest.raises(ValueError):
        model(_tokens(2, s, seed=3), cache, pos)


def test_latent_decode_reference_masks_past_pos():
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 16, 576, generator=g)
    ckv = torch.randn(2, 50, 576, generator=g)
    pos = torch.tensor([30])
    got = mld.mla_decode(q, ckv, pos, 0.1, 512)
    ckv2 = ckv.clone()
    ckv2[:, 31:] = torch.randn(2, 19, 576, generator=g) * 100
    assert torch.equal(mld.mla_decode(q, ckv2, pos, 0.1, 512), got)
    sc = (q.double() @ ckv[:, :31].double().transpose(1, 2)) * 0.1
    want = sc.softmax(-1) @ ckv[:, :31, :512].double()
    # f32 sums of 576 products against f64: a few f32 steps of ~1.
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_routing_bias_moves_the_picks_not_the_weights():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(10, 16, generator=g)
    router = torch.randn(16, 8, generator=g) / 4
    s = torch.sigmoid(x @ router)
    bias = torch.zeros(8)
    ids, w = moe.route(x, router, bias, 3, 2.446)
    assert torch.equal(ids, torch.topk(s, 3).indices)
    # Normalised over the picks, then scaled by 2.446.
    torch.testing.assert_close(w.sum(-1), torch.full((10,), 2.446))
    torch.testing.assert_close(w, s.gather(1, ids) / s.gather(1, ids).sum(
        -1, keepdim=True) * 2.446)
    bias[5] = 10.0
    ids_b, w_b = moe.route(x, router, bias, 3, 2.446)
    assert (ids_b == 5).any(-1).all()
    # The weights are the scores of the new picks: the bias is not in them.
    torch.testing.assert_close(w_b, s.gather(1, ids_b) / s.gather(
        1, ids_b).sum(-1, keepdim=True) * 2.446)


def _expert_weights(e, d, f, seed=7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(e, d, f, generator=g) / d ** 0.5,
            torch.randn(e, d, f, generator=g) / d ** 0.5,
            torch.randn(e, f, d, generator=g) / f ** 0.5)


def _per_token(x, ids, wts, wg, wu, wd):
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[t, j])
            h = torch.nn.functional.silu(x[t] @ wg[e]) * (x[t] @ wu[e])
            out[t] += wts[t, j] * (h @ wd[e])
    return out


@pytest.mark.parametrize("same", [False, True])
def test_experts_are_dropless(same):
    """Every pick is computed, also when every token picks the same
    experts: the plain loop equals a loop over tokens and picks."""
    n, k, e, d, f = 24, 3, 8, 16, 12
    g = torch.Generator().manual_seed(8)
    x = torch.randn(n, d, generator=g)
    ids = (torch.tensor([[2, 5, 7]]).expand(n, k) if same
           else torch.stack([torch.randperm(e, generator=g)[:k]
                             for _ in range(n)]))
    wts = torch.rand(n, k, generator=g)
    ws = _expert_weights(e, d, f)
    got = moe.grouped_swiglu(x, ids, wts, *ws)
    torch.testing.assert_close(got, _per_token(x, ids, wts, *ws), **TOL)


@pytest.mark.parametrize("same", [False, True])
def test_reference_adds_the_shared_row_after_rounding(same):
    """``add`` is the shared experts' row, added in x's dtype after the
    picks' sum is rounded: bitwise the sum, then ``+ add``."""
    n, k, e, d, f = 24, 3, 8, 16, 12
    g = torch.Generator().manual_seed(10)
    x = torch.randn(n, d, generator=g).bfloat16()
    ids = (torch.tensor([[2, 5, 7]]).expand(n, k) if same
           else torch.stack([torch.randperm(e, generator=g)[:k]
                             for _ in range(n)]))
    wts = torch.rand(n, k, generator=g)
    ws = [w.bfloat16() for w in _expert_weights(e, d, f)]
    s = torch.randn(n, d, generator=g).bfloat16()
    got = moe.grouped_swiglu_reference(x, ids, wts, *ws, add=s)
    assert torch.equal(got, moe.grouped_swiglu_reference(x, ids, wts, *ws)
                       + s)
    assert torch.equal(moe.grouped_swiglu(x, ids, wts, *ws, add=s), got)


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("bm", [4, 16])
def test_align_lays_every_pick_out_by_expert(same, bm):
    """The device-side layout the kernels read, run here on CPU tensors:
    each pick has its own padded row inside its expert's blocks, the
    padding rows hold the sentinel, the size is fixed by the shapes."""
    n, k, e = 21, 3, 8
    g = torch.Generator().manual_seed(9)
    ids = (torch.tensor([[1, 4, 6]]).expand(n, k) if same
           else torch.stack([torch.randperm(e, generator=g)[:k]
                             for _ in range(n)]))
    dest, row_slot, block_expert = moe.align(ids, e, bm)
    cap = -(-(n * k + e * (bm - 1)) // bm) * bm
    assert row_slot.shape == (cap,) and block_expert.shape == (cap // bm,)
    flat = dest.reshape(-1)
    assert flat.unique().numel() == n * k
    assert torch.equal(row_slot[flat].long(), torch.arange(n * k))
    assert int((row_slot == n * k).sum()) == cap - n * k
    assert torch.equal(block_expert[flat // bm].long(), ids.reshape(-1))
    # Blocks past the last expert's rows hold no pick.
    idle = block_expert == e
    assert (row_slot.view(-1, bm)[idle] == n * k).all()


def test_model_uses_the_dispatching_wrappers():
    assert mla_moe.mla_decode is mld.mla_decode
    assert mla_moe.grouped_swiglu is moe.grouped_swiglu


def test_registry_lists_k8_and_names_it_apart():
    """K8's C signature, its launch counter, and its device function
    named apart from the symbols the benchmark matches: no K1-K5 name
    (``roofline.kernel_of``) and not G1's (``moe_roofline`` divides by
    the time of every symbol holding ``moe_gemm``)."""
    P, I, L = _native._P, _native._I, _native._L
    assert _native.SIGNATURES["moe_combine"] == (
        "moe_combine", [P] * 4 + [I] * 3 + [L, P])
    assert "moe_combine" in _native.launches()
    fn = _native.MOE_COMBINE_FUNCTION
    src = (_native.CSRC / "moe_combine.cu").read_text()
    assert f"\n{fn}(" in src
    assert f"constexpr int kMaxPicks = {moe.MAX_PICKS};" in src
    from benchmark import roofline, roofline_mla

    assert roofline.kernel_of(fn) is None
    assert roofline_mla.MOE_GEMM not in fn
    assert roofline_mla.MLA_DECODE not in fn


def test_registry_lists_k7_and_the_grouped_gemms():
    P, I, L, F = (_native._P, _native._I, _native._L, _native._F)
    assert _native.SIGNATURES["mla_decode"] == (
        "mla_decode", [P] * 6 + [I] * 4 + [L] * 4 + [F, P])
    assert _native.SIGNATURES["moe_gemm_up"] == (
        "moe_gemm_up", [P] * 6 + [I] * 7 + [L] * 4 + [P])
    assert _native.SIGNATURES["moe_gemm_down"] == (
        "moe_gemm_down", [P] * 5 + [I] * 5 + [L] * 4 + [P])
    for name in ("mla_decode", "moe_gemm_up", "moe_gemm_down",
                 "moe_gemm_many"):
        assert name in _native.launches()
    src = (_native.CSRC / "mla_decode.cu").read_text()
    assert f"constexpr int kMinBlocks = {mld.BLOCKS_PER_SM};" in src
    assert f"constexpr int kKeys = {mld.KEYS_PER_TILE};" in src
    for fn in _native.MLA_DECODE_FUNCTIONS:
        assert f" {fn}(" in src or f"\n{fn}(" in src
    # The Few and Many instances hold the rows that block_rows picks, and
    # the many-row tiles the widths that _check asks for.
    header = (_native.CSRC / "moe_gemm.cuh").read_text()
    assert "template <int BM_, int BN_, int BK_" in header
    tc = (_native.CSRC / "moe_gemm_tc.cuh").read_text()
    assert (f"constexpr int kBM = {moe.MANY_ROWS}, "
            f"kBN = {moe.D_MULTIPLE}, kBK = 64," in tc)
    assert moe.F_MULTIPLE == moe.D_MULTIPLE // 2  # up: gate + up columns
    for name, fn, many in zip(("moe_gemm_up", "moe_gemm_down"),
                              _native.MOE_GEMM_FUNCTIONS,
                              _native.MOE_GEMM_MANY_FUNCTIONS):
        src = (_native.CSRC / f"{name}.cu").read_text()
        assert '#include "moe_gemm.cuh"' in src
        assert '#include "moe_gemm_tc.cuh"' in src
        assert f"\n{fn}(" in src
        assert f"\n{many}(" in src
        assert f"using Few = moe::Tile<{moe.FEW_ROWS}, " in src
        assert "if (bm == moe_tc::kBM)" in src
        assert "moe::Tile<128" not in src
    from benchmark import roofline, roofline_mla

    for name in (_native.MLA_DECODE_FUNCTIONS + _native.MOE_GEMM_FUNCTIONS
                 + _native.MOE_GEMM_MANY_FUNCTIONS):
        assert roofline.kernel_of(name) is None
    for name in _native.MOE_GEMM_FUNCTIONS + _native.MOE_GEMM_MANY_FUNCTIONS:
        assert roofline_mla.MOE_GEMM in name


@pytest.mark.parametrize("rows,want", [(64 * 6, 16), (32 * 64, 16),
                                       (32 * 64 + 1, 128), (4096 * 6, 128),
                                       (65536 * 6, 128)])
def test_block_rows_follow_the_rows_an_expert(rows, want):
    assert moe.block_rows(rows, 64) == want


def test_grouped_gemm_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    ids = torch.zeros(4, 2, dtype=torch.int64)
    wts = torch.ones(4, 2)
    ws = (torch.zeros(8, 256, 128, dtype=torch.bfloat16),
          torch.zeros(8, 256, 128, dtype=torch.bfloat16),
          torch.zeros(8, 128, 256, dtype=torch.bfloat16))
    moe._check(x, ids, wts, *ws)
    # Moonlight's widths: d 2048, f 1408 (11 x 128).
    moonlight = (torch.zeros(1, 2048, 1408, dtype=torch.bfloat16),
                 torch.zeros(1, 2048, 1408, dtype=torch.bfloat16),
                 torch.zeros(1, 1408, 2048, dtype=torch.bfloat16))
    moe._check(torch.zeros(4, 2048, dtype=torch.bfloat16), ids, wts,
               *moonlight)

    def widths(d, f):
        return (torch.zeros(4, d, dtype=torch.bfloat16), ids, wts,
                torch.zeros(8, d, f, dtype=torch.bfloat16),
                torch.zeros(8, d, f, dtype=torch.bfloat16),
                torch.zeros(8, f, d, dtype=torch.bfloat16))

    for bad in ((x.float(), ids, wts, *(w.float() for w in ws)),
                widths(192, 128),
                # the many-row tiles: d a multiple of 256, f of 128
                widths(384, 128), widths(256, 192), widths(2048, 1344),
                (x, ids[:, :1], wts, *ws),
                (x, ids, wts, ws[0], ws[1], ws[0]),
                # the shared row: x's shape and dtype; at most 8 picks
                (x, ids, wts, *ws, x[:2]), (x, ids, wts, *ws, x.float()),
                (x, torch.zeros(4, 9, dtype=torch.int64), torch.ones(4, 9),
                 *ws)):
        with pytest.raises((ValueError, TypeError)):
            moe._check(*bad)


@pytest.mark.parametrize("b,t,n_sm,want", [
    (64, 4224, 132, 4),        # the decode-mla cell
    (2, 300, 132, 2),          # few keys: no split under 256 keys
    (1000, 4224, 132, 1),      # more sequences than resident blocks
    (1, 1, 1, 1),
])
def test_split_count(b, t, n_sm, want):
    assert mld.mla_decode_splits(b, t, n_sm) == want


def test_kernel_checks_refuse_what_k7_does_not_take():
    q = torch.zeros(2, 16, 576, dtype=torch.bfloat16)
    ckv = torch.zeros(2, 64, 576, dtype=torch.bfloat16)
    pos = torch.tensor([5])
    mld._check(q, ckv, pos, 512)
    for bad in ((q[:, :8], ckv, pos, 512), (q.float(), ckv.float(), pos, 512),
                (q, ckv, pos.int(), 512), (q, ckv[:1], pos, 512),
                (q, ckv, torch.tensor([5, 6]), 512)):
        with pytest.raises((ValueError, TypeError)):
            mld._check(*bad)


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K7 and the grouped GEMMs have no "
                    "CPU mode)")
    return torch.device("cuda")


K7_CASES = {
    # the decode-mla cell: B 64, the 4224-long cache, its mean position
    "cell_4033": (64, 4224, 4033),
    "cell_last": (64, 4224, 4223),
    "small": (3, 300, 150),
    "pos_0": (2, 128, 0),
}


def _k7_inputs(b, t, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, 16, 576, generator=g, device=device).bfloat16()
    ckv = torch.randn(b, t, 576, generator=g, device=device).bfloat16()
    return q, ckv


def _k7_tol(want):
    """As K6's (tests/test_torch_decode_attn.py): the kernel rounds each
    probability to bf16 before normalising, relative to its running
    maximum, the plain version after; the output is rounded to bf16."""
    return dict(rtol=2 ** -6, atol=2 ** -8 * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_matches_plain_and_repeats_bitwise(cuda, case):
    b, t, pos = K7_CASES[case]
    q, ckv = _k7_inputs(b, t, cuda, seed=t + pos)
    q_pos = torch.tensor([pos], device=cuda)
    scale = 1 / math.sqrt(192)
    _native.reset_launches()
    got = mld.mla_decode(q, ckv, q_pos, scale, 512)
    again = mld.mla_decode(q, ckv, q_pos, scale, 512)
    torch.cuda.synchronize()
    assert _native.launches()["mla_decode"] == 2
    assert torch.equal(got, again)
    want = mld.mla_decode_reference(q, ckv, q_pos, scale, 512)
    torch.testing.assert_close(got, want, **_k7_tol(want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cell_4033", "small"])
def test_k7_split_counts_agree_and_never_read_past_pos(cuda, case):
    b, t, pos = K7_CASES[case]
    q, ckv = _k7_inputs(b, t, cuda, seed=3 * t + pos)
    ckv[:, pos + 1:] = 0
    q_pos = torch.tensor([pos], device=cuda)
    scale = 1 / math.sqrt(192)
    want = mld.mla_decode_reference(q, ckv, q_pos, scale, 512)
    clean = {s: mld._launch(q, ckv, q_pos, scale, s) for s in (1, 3, 8)}
    for got in clean.values():
        torch.testing.assert_close(got, want, **_k7_tol(want))
    ckv[:, pos + 1:] = float("nan")
    for s, got in clean.items():
        assert torch.equal(mld._launch(q, ckv, q_pos, scale, s), got)


G1_CASES = {
    # tokens, picks skewed: the decode step's 64 tokens (16-row blocks);
    # prefill chunks (128-row blocks), the decode-mla cell's of 65,536
    # tokens among them; and skewed picks: one expert with no rows, one
    # with a single row, one picked by a quarter of the tokens, over an
    # odd number of 128-row blocks (251).
    "decode_64": (64, False),
    "chunk_4096": (4096, False),
    "chunk_65536": (65536, False),
    "skewed_4000": (4000, True),
}


def _skewed_picks(n, e, k, g, device):
    """Distinct picks a token among experts 3..e-1, then expert 2 for the
    first quarter of the tokens and expert 1 for one more: expert 0
    takes no row, expert 1 one."""
    ids = torch.rand(n, e - 3, generator=g, device=device).argsort(1)[:, :k]
    ids += 3
    ids[: n // 4, 0] = 2
    ids[n // 4, 1] = 1
    wts = torch.rand(n, k, generator=g, device=device) + 0.1
    return ids, wts / wts.sum(1, keepdim=True) * 2.446


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(G1_CASES))
def test_grouped_gemms_match_the_per_expert_loop(cuda, case):
    """The grouped GEMMs at Moonlight's widths against the plain loop with
    the same roundings: the GEMMs' sums differ in order only (bf16
    products, f32 sums), so the outputs agree to a bf16 step; two calls
    give the same bits; the many-row instance counts one launch a GEMM
    where block_rows picks it, and none in a decode step."""
    n, skewed = G1_CASES[case]
    e, d, f, k = 64, 2048, 1408, 6
    g = torch.Generator(device=cuda).manual_seed(n + skewed)
    x = torch.randn(n, d, generator=g, device=cuda).bfloat16()
    if skewed:
        ids, wts = _skewed_picks(n, e, k, g, cuda)
        counts = torch.bincount(ids.reshape(-1), minlength=e)
        assert counts[0] == 0 and counts[1] == 1 and counts[2] == n // 4
    else:
        router = (torch.randn(d, e, generator=g, device=cuda) / d ** 0.5
                  ).bfloat16()
        ids, wts = moe.route(x, router, torch.zeros(e, device=cuda), k,
                             2.446)
    ws = [(torch.randn(e, d, f, generator=g, device=cuda) / d ** 0.5
           ).bfloat16(),
          (torch.randn(e, d, f, generator=g, device=cuda) / d ** 0.5
           ).bfloat16(),
          (torch.randn(e, f, d, generator=g, device=cuda) / f ** 0.5
           ).bfloat16()]
    _native.reset_launches()
    got = moe.grouped_swiglu(x, ids, wts, *ws)
    again = moe.grouped_swiglu(x, ids, wts, *ws)
    torch.cuda.synchronize()
    launches = _native.launches()
    assert launches["moe_gemm_up"] == 2
    assert launches["moe_gemm_down"] == 2
    many = moe.block_rows(n * k, e) == moe.MANY_ROWS
    assert many == (n > 64)
    assert launches["moe_gemm_many"] == (4 if many else 0)
    assert torch.equal(got, again)
    want = moe.grouped_swiglu_reference(x, ids, wts, *ws)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got, want, rtol=2 ** -6, atol=2 ** -8 * scale)


K8_CASES = {
    # tokens, rows a block: the decode step's 64 (16-row blocks), a
    # 62,400-token prefill chunk (128-row blocks), each also with every
    # pick on one expert.
    "decode_64": (64, 16, False),
    "chunk_62400": (62400, 128, False),
    "decode_64_one_expert": (64, 16, True),
    "chunk_62400_one_expert": (62400, 128, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_equals_the_torch_combine_bitwise(cuda, case):
    """K8 over ``align``'s layout of seeded picks (6 of 64 experts, d
    2048) against the torch combine it replaced: gathers, f32 adds in
    pick order, one rounding, then ``+ shared``. Bitwise, with and
    without the shared row, and bitwise again on a second call; one
    launch a call."""
    n, bm, one_expert = K8_CASES[case]
    e, d, k = 64, 2048, 6
    assert moe.block_rows(n * k, e) == bm
    g = torch.Generator(device=cuda).manual_seed(n + 7 * one_expert)
    ids = torch.rand(n, e, generator=g, device=cuda).argsort(1)[:, :k]
    if one_expert:
        ids[:] = 5
    dest, row_slot, _ = moe.align(ids, e, bm)
    out = torch.randn(row_slot.numel(), d, generator=g,
                      device=cuda).bfloat16()
    shared = torch.randn(n, d, generator=g, device=cuda).bfloat16()
    _native.reset_launches()
    got = moe.combine(out, dest, shared)
    again = moe.combine(out, dest, shared)
    alone = moe.combine(out, dest)
    torch.cuda.synchronize()
    assert _native.launches()["moe_combine"] == 3
    acc = out.index_select(0, dest[:, 0]).float()
    for j in range(1, k):
        acc += out.index_select(0, dest[:, j]).float()
    routed = acc.to(torch.bfloat16)
    assert torch.equal(alone, routed)
    assert torch.equal(got, routed + shared)
    assert torch.equal(again, got)


# A bf16 model K7 takes (16 heads of 512 + 64), small elsewhere.
SMALL = dict(TINY, name="mla-small", hidden_size=256, num_attention_heads=16,
             num_key_value_heads=16, kv_lora_rank=512, qk_nope_head_dim=128,
             qk_rope_head_dim=64, v_head_dim=128, intermediate_size=512,
             moe_intermediate_size=128, n_routed_experts=16,
             num_experts_per_tok=4, vocab_size=512,
             max_position_embeddings=512, torch_dtype="bfloat16")


@pytest.mark.gpu
def test_graph_replay_equals_uncaptured_step_and_counts(cuda):
    """A ``DecodeLoop`` whose step is a captured graph against the same
    step uncaptured: bitwise the same tokens and latent caches. Each
    replayed step counts K7 once a layer and each grouped GEMM and K8
    once an expert layer."""
    model = _model(SMALL, device=cuda)
    prompt = torch.randint(0, 512, (3, 70), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    new = 9
    graphed = llama.DecodeLoop(model, 3, 128, capture=True)
    plain = llama.DecodeLoop(model, 3, 128, capture=False)
    want = plain.run(prompt, new)
    got = graphed.run(prompt, new)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(graphed.cache, plain.cache):
        assert torch.equal(a["ckv"], b["ckv"])
    graphed.start_sequence(prompt)
    _native.reset_launches()
    for i in range(1, 4):
        graphed.step()
        torch.cuda.synchronize()
        counts = _native.launches()
        assert counts["mla_decode"] == 3 * i
        assert counts["moe_gemm_up"] == counts["moe_gemm_down"] == 2 * i
        assert counts["moe_combine"] == 2 * i
    assert graphed.step.graph is not None


@pytest.mark.gpu
def test_the_card_matches_the_reference_in_bf16(cuda):
    """The small bf16 model through generate on the card, its logits at
    every served position against the float32 reference on the same
    weights: the served tokens sit within bf16's reach of the
    reference's best."""
    model = _model(SMALL, device=cuda)
    prompt = torch.randint(0, 512, (2, 90), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(8))
    served = llama.generate(model, prompt, 6, device=cuda)
    want = mla_moe_ref.served_logits(SMALL, SEED, [(prompt[r], served[r])
                                                   for r in range(2)],
                                     torch.bfloat16, cuda)
    from benchmark.reference import llama_ref

    for r in range(2):
        gap = float(llama_ref.served_gaps(want[r]["f32"], served[r]).max())
        assert gap < 0.25
