"""Kimi Linear's hybrid model (``models/kimi_linear.py``), its KDA mixer
and K9 (``ops/kda.py``), K7 at 32 heads and the expert layer that holds
part of the experts, against the plain float32 reference
(``benchmark/reference/kimi_linear_ref.py``) and their plain versions.

The CPU cases run at a tiny size of the published shape in float32 (6
layers: two periods of 2 KDA and 1 MLA layer, the first dense; 16
experts, 8 of them held, 4 a token, 1 shared) on the benchmark's seeded
weights. The ``gpu`` cases run only on an NVIDIA card (K7, K9 and the
grouped GEMMs have no CPU mode) and skip, with their reason, elsewhere;
the file imports nothing of JAX:

    python -m pytest tests/test_torch_kimi_linear.py -m gpu

Tolerances, with their reasons. The program and the reference compute
the same equations in float32 in another order of sums (the recurrence's
einsums against the reference's, the absorbed decode through the latent,
the router's product): their logits, of size ~4, agree to a few f32
steps. rtol 1e-5 with an atol of 2e-5 holds that, and bf16 arithmetic,
whose steps are 2^-8 of a value, fails it
(:func:`test_bf16_fails_the_tolerance`).
"""

import math

import pytest
import torch

from benchmark import weights_kimi
from benchmark.reference import kimi_linear_ref
from rocnrdma_tpu_torch.models import kimi_linear, llama
from rocnrdma_tpu_torch.models import mla_moe
from rocnrdma_tpu_torch.ops import _native, kda, moe
from rocnrdma_tpu_torch.ops import mla_decode as mld
from rocnrdma_tpu_torch.utils.trace import trace

TINY = {
    "name": "tiny-kimi", "vocab_size": 256, "hidden_size": 64,
    "num_hidden_layers": 6, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
    "moe_intermediate_size": 24, "num_experts": 8, "router_experts": 16,
    "first_expert": 0, "num_shared_experts": 1, "num_experts_per_token": 4,
    "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
    "max_position_embeddings": 128, "rope_theta": 10000,
    "rms_norm_eps": 1e-05, "torch_dtype": "float32", "q_lora_rank": None,
    "mla_use_nope": True, "moe_router_activation_func": "sigmoid",
    "num_expert_group": 1, "topk_group": 1, "moe_renormalize": True,
    "linear_attn_config": {"full_attn_layers": [3, 6],
                           "kda_layers": [1, 2, 4, 5], "head_dim": 16,
                           "num_heads": 4, "short_conv_kernel_size": 4}}
TOL = dict(rtol=1e-5, atol=2e-5)
SEED = 2 ** 31 + 29


def _model(cfg_json=TINY, seed=SEED, device="cpu", dtype=None):
    overrides = {} if dtype is None else {"dtype": dtype}
    cfg = kimi_linear.KimiLinearConfig.from_hf(cfg_json, **overrides)
    model = kimi_linear.KimiLinear(cfg, device)
    for group in weights_kimi.draw_all(cfg_json, seed, device, cfg.dtype):
        model.load_state_dict(group, strict=False)
    return model


def _tokens(b, s, seed=1, vocab=256):
    return torch.randint(0, vocab, (b, s),
                         generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------- CPU


def test_config_from_published_keys_and_refusals():
    cfg = kimi_linear.KimiLinearConfig.from_hf(TINY)
    assert cfg.kda_layers == (0, 1, 3, 4)
    assert (cfg.n_experts, cfg.n_routed, cfg.first_expert, cfg.top_k) == \
        (8, 16, 0, 4)
    assert cfg.mla_use_nope and cfg.cache_width == 40
    for key, bad in (("q_lora_rank", 1536),
                     ("moe_router_activation_func", "softmax"),
                     ("num_expert_group", 8),
                     ("rope_scaling", {"type": "yarn"})):
        with pytest.raises(ValueError, match=key):
            kimi_linear.KimiLinearConfig.from_hf(dict(TINY, **{key: bad}))
    lin = dict(TINY["linear_attn_config"], kda_layers=[1, 2, 4])
    with pytest.raises(ValueError, match="every layer"):
        kimi_linear.KimiLinearConfig.from_hf(
            dict(TINY, linear_attn_config=lin))
    with pytest.raises(ValueError, match="router"):
        kimi_linear.KimiLinearConfig.from_hf(dict(TINY, first_expert=9))


def test_weight_names_are_the_models():
    model = kimi_linear.KimiLinear(
        kimi_linear.KimiLinearConfig.from_hf(TINY), "cpu")
    names = {n for _, leaves in weights_kimi.groups(TINY)
             for n, _, _ in leaves}
    assert names == set(model.state_dict())
    layer0 = weights_kimi.draw_group(TINY, SEED, 1, "cpu", torch.float32)
    # A uniform on [1, 16]; dt_bias the inverse softplus of dt in
    # [1e-3, 1e-1].
    a = layer0["layers.0.kda.A_log"].exp()
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(layer0["layers.0.kda.dt_bias"])
    assert bool(((dt > 0.999e-3) & (dt < 0.1001)).all())


def test_no_cache_forward_matches_the_reference():
    model = _model()
    tok = _tokens(2, 40)
    with torch.no_grad():
        got = model(tok)
    want = kimi_linear_ref.forward(TINY, SEED, [tok[0], tok[1]],
                                   torch.float32, "cpu")
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
    want = kimi_linear_ref.forward(TINY, SEED, [tok[0], tok[1]],
                                   torch.float32, "cpu")
    assert not torch.allclose(got[0], want[0]["f32"], **TOL)


def test_cache_mixes_latent_rows_and_recurrent_state():
    model = _model()
    cache = model.init_cache(3, 64)
    kinds = [sorted(c) for c in cache]
    assert kinds == [["conv", "state"], ["conv", "state"], ["ckv"],
                     ["conv", "state"], ["conv", "state"], ["ckv"]]
    assert cache[0]["state"].shape == (3, 4, 16, 16)
    assert cache[0]["state"].dtype == torch.float32
    assert cache[0]["conv"].shape == (3, 3, 3 * 64)
    assert cache[2]["ckv"].shape == (3, 64, 40)
    assert model.cache_nbytes(3, 64) == sum(
        t.nbytes for c in cache for t in c.values())


def test_published_cache_size():
    """At the decode-hybrid cell's batch and cache length: 5.37 GB of KDA
    state, 0.19 GB of convolution state and 2.11 GB of latent rows, under
    the decode-loop memo's 8 GiB."""
    big = kimi_linear.KimiLinear.__new__(kimi_linear.KimiLinear)
    import json
    from pathlib import Path

    path = (Path(__file__).resolve().parent.parent / "benchmark" / "configs"
            / "kimi-linear-48b-a3b.json")
    big.cfg = kimi_linear.KimiLinearConfig.from_hf(
        json.loads(path.read_text()))
    assert big.cfg.n_experts == 128 and big.cfg.n_routed == 256
    assert big.cfg.kda_layers == tuple(
        i for i in range(27) if i not in (3, 7, 11, 15, 19, 23, 26))
    state = 20 * 128 * 32 * 128 * 128 * 4
    conv = 20 * 128 * 3 * 3 * 4096 * 2
    latent = 7 * 128 * 2048 * 576 * 2
    assert big.cache_nbytes(128, 2048) == state + conv + latent
    assert big.cache_nbytes(128, 2048) < llama._GEN_CACHE_MAX_BYTES


def test_prefill_and_decode_steps_match_the_full_forward(monkeypatch):
    """``generate``'s path by hand, uncaptured: the prefill at int pos 0
    (in chunks of 2 rows and 1), then one-token steps at a 0-d tensor pos
    through the recurrent state and the absorbed latent decode, each
    step's logits against the reference's full forward at that
    position."""
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
    want = kimi_linear_ref.served_logits(
        TINY, SEED, [(prompt[r], served[r]) for r in range(b)],
        torch.float32, "cpu")
    for r in range(b):
        torch.testing.assert_close(torch.stack([g[r] for g in got]),
                                   want[r]["f32"], **TOL)
    # The same tokens through generate (its DecodeLoop, uncaptured here).
    assert torch.equal(llama.generate(model, prompt, new, device="cpu"),
                       served)


@pytest.mark.parametrize("cut", [1, 2, 9])
def test_a_prompt_split_in_two_prefills_equals_one(cut):
    """A KDA mixer over a prompt in two calls through its cache (the
    state and the convolution's last inputs carried) gives one call's
    outputs and leaves the same cache; a cut shorter than the
    convolution's width reaches back into the zeros before position 0."""
    model = _model()
    mixer = model.layers[1].kda
    h = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(3))
    whole, parts = mixer.init_cache(2, "cpu"), mixer.init_cache(2, "cpu")
    with torch.no_grad():
        one = mixer(h, whole)
        two = torch.cat([mixer(h[:, :cut], parts), mixer(h[:, cut:], parts)],
                        dim=1)
    torch.testing.assert_close(two, one, **TOL)
    for key in ("state", "conv"):
        torch.testing.assert_close(parts[key], whole[key], **TOL)
    # Without a cache the mixer starts from zeros: the whole call's.
    with torch.no_grad():
        torch.testing.assert_close(mixer(h), one, rtol=0, atol=0)


def test_kda_reference_matches_the_references_recurrence():
    """``ops/kda.py``'s plain recurrence against the reference's, from a
    zero state, with the state it leaves."""
    g = torch.Generator().manual_seed(4)
    b, t, h, d = 2, 23, 3, 16
    q = kda.l2norm(torch.randn(b, t, h, d, generator=g))
    k = kda.l2norm(torch.randn(b, t, h, d, generator=g))
    v = torch.randn(b, t, h, d, generator=g)
    log_a = -torch.rand(b, t, h, d, generator=g)
    beta = torch.rand(b, t, h, generator=g)
    state = torch.zeros(b, h, d, d)
    got = kda.recurrence_reference(q, k, v, log_a, beta, state, d ** -0.5)
    want = kimi_linear_ref.recurrence(q, k, v, log_a, beta)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("cut", [1, 2, 9])
def test_k9s_plain_version_carries_both_states(cut):
    """K9's CPU path over raw projections in two calls (the convolution's
    raw rows and the recurrent state carried) equals one call, outputs
    and both states; from zero states it is the convolution, SiLU, the
    l2norms and the reference's recurrence."""
    g = torch.Generator().manual_seed(13)
    b, t, h, d = 2, 14, 3, 16
    x = torch.randn(b, t, 3 * h * d, generator=g)
    w = torch.randn(3 * h * d, 4, generator=g) / 2
    log_a = -torch.rand(b, t, h, d, generator=g)
    beta = torch.rand(b, t, h, generator=g)

    def states():
        return torch.zeros(b, 3, 3 * h * d), torch.zeros(b, h, d, d)

    conv1, st1 = states()
    one = kda.kda_recurrent(x, w, conv1, log_a, beta, st1, d ** -0.5)
    conv2, st2 = states()
    two = torch.cat([kda.kda_recurrent(x[:, :cut], w, conv2, log_a[:, :cut],
                                       beta[:, :cut], st2, d ** -0.5),
                     kda.kda_recurrent(x[:, cut:], w, conv2, log_a[:, cut:],
                                       beta[:, cut:], st2, d ** -0.5)], 1)
    torch.testing.assert_close(two, one, **TOL)
    torch.testing.assert_close(st2, st1, **TOL)
    assert torch.equal(conv2, conv1) and torch.equal(conv1, x[:, -3:])
    y = torch.nn.functional.silu(sum(
        torch.nn.functional.pad(x, (0, 0, 3, 0))[:, j:j + t] * w[:, j]
        for j in range(4))).view(b, t, 3, h, d)
    want = kimi_linear_ref.recurrence(
        y[:, :, 0] / y[:, :, 0].norm(dim=-1, keepdim=True),
        y[:, :, 1] / y[:, :, 1].norm(dim=-1, keepdim=True), y[:, :, 2],
        log_a, beta)
    torch.testing.assert_close(one, want, rtol=1e-4, atol=1e-5)


def test_the_expert_shares_sum_to_the_uncut_layer():
    """The share test: an expert layer of 16 routed experts divided
    between two "cards" (experts 0-7 and 8-15). Each card's ``MoE``
    routes over all 16 and computes its own experts' picks and the shared
    expert; the two shares, the shared expert counted once, add up to the
    uncut reference's layer."""
    uncut = dict(TINY, num_experts=16, router_experts=16)
    w = weights_kimi.draw_group(uncut, SEED, 2, "cpu", torch.float32)
    g = torch.randn(30, 64, generator=torch.Generator().manual_seed(5))
    want = kimi_linear_ref.experts(g, w, uncut, "f32", "layers.1.")
    p = "layers.1.moe."
    shares = []
    for first in (0, 8):
        cfg = kimi_linear.KimiLinearConfig.from_hf(
            dict(TINY, first_expert=first))
        layer = mla_moe.MoE(cfg, "cpu")
        layer.load_state_dict({
            "router": w[p + "router"], "router_bias": w[p + "router_bias"],
            **{n: w[p + n][first:first + 8]
               for n in ("w_gate", "w_up", "w_down")},
            **{f"shared.{n}": w[p + f"shared.{n}"]
               for n in ("w_gate", "w_up", "w_down")}})
        with torch.no_grad():
            shares.append(layer(g[None])[0])
        shared = layer.shared(g)
    got = shares[0] + shares[1] - shared
    torch.testing.assert_close(got, want, **TOL)
    # And each share is the reference's share on its held experts.
    half = dict(uncut, num_experts=8, first_expert=8)
    w_half = dict(w, **{p + n: w[p + n][8:]
                        for n in ("w_gate", "w_up", "w_down")})
    torch.testing.assert_close(
        shares[1], kimi_linear_ref.experts(g, w_half, half, "f32",
                                           "layers.1."), **TOL)


@pytest.mark.parametrize("bm", [4, 16])
def test_align_gives_another_cards_picks_no_row(bm):
    """A pick of id -1 (another card's expert) has dest -1 and no padded
    row; the held picks are laid out as without it."""
    n, k, e = 21, 3, 8
    g = torch.Generator().manual_seed(9)
    ids = torch.stack([torch.randperm(2 * e, generator=g)[:k]
                       for _ in range(n)])
    local = ids.masked_fill(ids >= e, -1)
    dest, row_slot, block_expert = moe.align(local, e, bm)
    cap = -(-(n * k + e * (bm - 1)) // bm) * bm
    assert row_slot.shape == (cap,) and block_expert.shape == (cap // bm,)
    held = local >= 0
    assert bool((dest[~held] == -1).all())
    rows = dest[held]
    assert rows.unique().numel() == int(held.sum())
    slots = torch.arange(n * k).view(n, k)[held]
    assert torch.equal(row_slot[rows].long(), slots)
    assert int((row_slot == n * k).sum()) == cap - int(held.sum())
    assert torch.equal(block_expert[rows // bm].long(), local[held])


def test_align_counts_the_held_rows_and_the_experts_they_touch():
    """``count_held`` adds the rows :func:`align` lays out for the held
    picks and the held experts they touch to the device counters of the
    instance that computes them (by the rows a block), which ``launches``
    reads and ``reset_launches`` zeroes; ``align`` itself counts
    nothing, and an expert layer that holds every expert calls no
    ``count_held``."""
    n, k, e = 10, 3, 8
    g = torch.Generator().manual_seed(12)
    ids = torch.stack([torch.randperm(2 * e, generator=g)[:k]
                       for _ in range(n)])
    local = ids.masked_fill(ids >= e, -1)
    _native.reset_launches()
    with torch.inference_mode():
        moe.count_held(local, e)
    moe.count_held(local, e)
    # 270 picks over 8 experts: past 32 an expert, the many-row instance.
    moe.count_held(local.repeat(9, 1), e)
    dest, row_slot, _ = moe.align(local, e, moe.FEW_ROWS)
    got = _native.launches()
    rows, touched = int((local >= 0).sum()), local[local >= 0].unique().numel()
    assert int((row_slot < n * k).sum()) == rows
    assert (got["moe_rows_few"], got["moe_experts_few"]) == (2 * rows,
                                                             2 * touched)
    assert (got["moe_rows_many"], got["moe_experts_many"]) == (9 * rows,
                                                               touched)
    # The model's expert layers, 8 of 16 experts held, count theirs.
    _native.reset_launches()
    with torch.no_grad():
        _model()(_tokens(2, 9))
    got = _native.launches()
    assert got["moe_rows_few"] > 0 and got["moe_experts_few"] > 0
    assert got["moe_rows_many"] == got["moe_experts_many"] == 0
    _native.reset_launches()
    assert all(_native.launches()[name] == 0
               for name in _native.DEVICE_COUNTERS)


def test_combine_reads_another_cards_picks_as_zeros():
    g = torch.Generator().manual_seed(10)
    out = torch.randn(12, 8, generator=g).bfloat16()
    dest = torch.tensor([[0, -1, 3], [-1, -1, 5], [2, 4, 6]])
    got = moe.combine(out, dest)
    want = torch.stack([out[0].float() + out[3].float(), out[5].float(),
                        out[2].float() + out[4].float() + out[6].float()]
                       ).bfloat16()
    assert torch.equal(got, want)


def test_held_picks_alone_are_computed():
    """The plain grouped SwiGLU over local ids with -1 for another card's
    picks: each token's held picks, weighed, and nothing of the others."""
    n, k, e, d, f = 24, 4, 8, 16, 12
    g = torch.Generator().manual_seed(11)
    x = torch.randn(n, d, generator=g)
    ids = torch.stack([torch.randperm(2 * e, generator=g)[:k]
                       for _ in range(n)])
    local = ids.masked_fill(ids >= e, -1)
    wts = torch.rand(n, k, generator=g)
    ws = [torch.randn(e, d, f, generator=g), torch.randn(e, d, f, generator=g),
          torch.randn(e, f, d, generator=g)]
    got = moe.grouped_swiglu(x, local, wts, *ws)
    want = torch.zeros_like(x)
    for t in range(n):
        for j in range(k):
            i = int(local[t, j])
            if i >= 0:
                hid = torch.nn.functional.silu(x[t] @ ws[0][i]) * (
                    x[t] @ ws[1][i])
                want[t] += wts[t, j] * (hid @ ws[2][i])
    torch.testing.assert_close(got, want, **TOL)


def test_kda_mixer_is_a_span():
    model = _model()
    trace.reset()
    with torch.no_grad():
        model(_tokens(2, 9))
    spans = trace.events("kda.mix")
    assert len(spans) == 4
    assert all(f["rows"] == 18 for _, _, f in spans)


def test_registry_lists_k9_and_names_it_apart():
    P, I, F = _native._P, _native._I, _native._F
    assert _native.SIGNATURES["kda_recurrent"] == (
        "kda_recurrent", [P] * 7 + [I] * 4 + [F, P])
    assert "kda_recurrent" in _native.launches()
    fn = _native.KDA_RECURRENT_FUNCTION
    src = (_native.CSRC / "kda_recurrent.cu").read_text()
    assert f"\n{fn}(" in src
    assert f"constexpr int kDim = {kda.DIM};" in src
    from benchmark import roofline, roofline_kimi, roofline_mla

    assert roofline.kernel_of(fn) is None
    assert roofline_kimi.KDA_RECURRENT in fn
    assert roofline_mla.MOE_GEMM not in fn
    assert roofline_mla.MLA_DECODE not in fn


def test_model_uses_the_dispatching_wrappers():
    assert kimi_linear.KdaMixer is kda.KdaMixer
    assert kda.kda_recurrent.__module__ == "rocnrdma_tpu_torch.ops.kda"


def test_kernel_checks_refuse_what_k7_and_k9_do_not_take():
    ckv = torch.zeros(2, 64, 576, dtype=torch.bfloat16)
    pos = torch.tensor([5])
    for heads in mld.HEAD_COUNTS:
        mld._check(torch.zeros(2, heads, 576, dtype=torch.bfloat16), ckv,
                   pos, 512)
    with pytest.raises(ValueError):
        mld._check(torch.zeros(2, 24, 576, dtype=torch.bfloat16), ckv, pos,
                   512)
    bf = torch.bfloat16
    x = torch.zeros(2, 3, 3 * 4 * 128, dtype=bf)
    w = torch.zeros(3 * 4 * 128, 4, dtype=bf)
    conv = torch.zeros(2, 3, 3 * 4 * 128, dtype=bf)
    g32 = torch.zeros(2, 3, 4, 128)
    beta = torch.zeros(2, 3, 4)
    state = torch.zeros(2, 4, 128, 128)
    kda._check(x, w, conv, g32, beta, state)
    for bad in ((x[..., :768], w[:768], conv[..., :768], g32[..., :64],
                 beta, state[..., :64, :64]),
                (x.float(), w, conv, g32, beta, state),
                (x, w, conv, g32.bfloat16(), beta, state),
                (x, w, conv, g32, beta[:, :2], state),
                (x, w[:, :3], conv, g32, beta, state),
                (x, w, conv[:, :2], g32, beta, state),
                (x.transpose(0, 1), w, conv, g32.transpose(0, 1),
                 beta.transpose(0, 1), state)):
        with pytest.raises((ValueError, TypeError)):
            kda._check(*bad)


@pytest.mark.parametrize("b,heads,t,n_sm,want", [
    (128, 32, 2048, 132, 1),    # the decode-hybrid cell: 256 blocks
    (4, 32, 2048, 132, 8),      # few sequences: split over the keys
])
def test_split_count_takes_the_head_groups(b, heads, t, n_sm, want):
    assert mld.mla_decode_splits(b * heads // mld.HEADS, t, n_sm) == want


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K7, K9 and the grouped GEMMs have "
                    "no CPU mode)")
    return torch.device("cuda")


def _k9_inputs(b, t, device, seed, state_scale=0.1, heads=32):
    """Inputs as the mixer makes them: raw projections of O(1) in bf16,
    convolution taps of std 1/2 and raw rows before them, a decay in
    (0.5, 1] per channel, beta in [0, 1), a state of O(0.1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = heads * 128
    x = torch.randn(b, t, 3 * c, generator=g, device=device).bfloat16()
    w = (torch.randn(3 * c, 4, generator=g, device=device) / 2).bfloat16()
    conv = torch.randn(b, 3, 3 * c, generator=g, device=device).bfloat16()
    log_a = -0.7 * torch.rand(b, t, heads, 128, generator=g, device=device)
    beta = torch.rand(b, t, heads, generator=g, device=device)
    state = state_scale * torch.randn(b, heads, 128, 128, generator=g,
                                      device=device)
    return x, w, conv, log_a, beta, state


def _k9_tol(want):
    """K9 and the plain version read the same bf16 inputs and sum the
    same f32 products in another order (the convolution's taps, four
    partial sums of the recurrence); o is rounded to bf16: a bf16 step of
    o's largest magnitude, and f32 steps of the state's after 1,600
    tokens."""
    return dict(rtol=2 ** -7, atol=2 ** -8 * float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,heads", [(128, 1, 32), (2, 1600, 32),
                                       (3, 37, 32), (3, 37, 2)])
def test_k9_matches_the_plain_recurrence(cuda, b, t, heads):
    """At the decode step's 128 sequences and one token, over a prompt of
    1,600 tokens, and at 2 heads: o and the states K9 leaves against the
    plain version from the same states; two launches from the same states
    give the same bits; one launch a call."""
    x, w, conv, log_a, beta, s0 = _k9_inputs(b, t, cuda, seed=b * t,
                                             heads=heads)
    scale = 128 ** -0.5
    state, again, plain = s0.clone(), s0.clone(), s0.clone()
    c1, c2, cp = conv.clone(), conv.clone(), conv.clone()
    _native.reset_launches()
    got = kda.kda_recurrent(x, w, c1, log_a, beta, state, scale)
    got2 = kda.kda_recurrent(x, w, c2, log_a, beta, again, scale)
    torch.cuda.synchronize()
    assert _native.launches()["kda_recurrent"] == 2
    assert torch.equal(got, got2) and torch.equal(state, again)
    want = kda.kda_reference(x, w, cp, log_a, beta, plain, scale)
    torch.testing.assert_close(got, want, **_k9_tol(want))
    torch.testing.assert_close(state, plain, rtol=1e-4, atol=1e-5)
    assert torch.equal(c1, cp) and torch.equal(c1, c2)


@pytest.mark.gpu
def test_k9_carries_the_state_across_launches(cuda):
    """A 1,600-token prompt in two launches (1,000 then 600) gives the
    outputs and states of one launch, bitwise: K9 keeps the state in f32,
    carries the raw rows the convolution reaches back to, and each
    (sequence, head) sums in the same order either way."""
    x, w, conv, log_a, beta, s0 = _k9_inputs(2, 1600, cuda, seed=5,
                                             state_scale=0.0)
    conv.zero_()
    scale = 128 ** -0.5
    one, two = s0.clone(), s0.clone()
    c1, c2 = conv.clone(), conv.clone()
    whole = kda.kda_recurrent(x, w, c1, log_a, beta, one, scale)
    parts = [kda.kda_recurrent(x[:, a:z].contiguous(), w, c2,
                               log_a[:, a:z].contiguous(),
                               beta[:, a:z].contiguous(), two, scale)
             for a, z in ((0, 1000), (1000, 1600))]
    assert torch.equal(torch.cat(parts, 1), whole)
    assert torch.equal(two, one) and torch.equal(c2, c1)


@pytest.mark.gpu
def test_k9_in_a_captured_graph_after_a_prefill(cuda):
    """T = 1 after a prefilled state, inside a captured graph and
    replayed: each replay's o and states against the plain version's
    steps, and one launch a replay."""
    from rocnrdma_tpu_torch.utils.graphs import CapturedStep

    x, w, conv, log_a, beta, s0 = _k9_inputs(8, 200, cuda, seed=6,
                                             state_scale=0.0)
    conv.zero_()
    scale = 128 ** -0.5
    state, plain = s0.clone(), s0.clone()
    c_k9, c_plain = conv.clone(), conv.clone()
    kda.kda_recurrent(x[:, :196].contiguous(), w, c_k9,
                      log_a[:, :196].contiguous(),
                      beta[:, :196].contiguous(), state, scale)
    kda.kda_reference(x[:, :196], w, c_plain, log_a[:, :196],
                      beta[:, :196], plain, scale)
    ins = [t[:, 196:197].clone() for t in (x, log_a, beta)]
    out = torch.empty(8, 1, 32, 128, dtype=torch.bfloat16, device=cuda)

    def step():
        out.copy_(kda.kda_recurrent(ins[0], w, c_k9, ins[1], ins[2], state,
                                    scale))

    graphed = CapturedStep(step, cuda)
    _native.reset_launches()
    for j in range(196, 200):
        for buf, t in zip(ins, (x, log_a, beta)):
            buf.copy_(t[:, j:j + 1])
        graphed()
        torch.cuda.synchronize()
        want = kda.kda_reference(x[:, j:j + 1], w, c_plain,
                                 log_a[:, j:j + 1], beta[:, j:j + 1], plain,
                                 scale)
        torch.testing.assert_close(out, want, **_k9_tol(want))
        torch.testing.assert_close(state, plain, rtol=1e-4, atol=1e-5)
        assert torch.equal(c_k9, c_plain)
    assert graphed.graph is not None
    assert _native.launches()["kda_recurrent"] == 4


K7_32_CASES = {
    # the decode-hybrid cell: B 128 over its 2048-long cache (one split),
    # at a mean and the last position; few sequences (several splits).
    "cell_1800": (128, 2048, 1800),
    "cell_last": (128, 2048, 2047),
    "small": (3, 300, 150),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K7_32_CASES))
def test_k7_at_32_heads_matches_plain_and_repeats_bitwise(cuda, case):
    """K7 over 32 query heads (two head groups a sequence) against its
    plain version, with K6's tolerance (tests/test_torch_mla_moe.py:
    probabilities rounded to bf16 before normalising), and each head
    group bitwise the 16-head launch over its own heads."""
    b, t, pos = K7_32_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(t + pos)
    q = torch.randn(b, 32, 576, generator=g, device=cuda).bfloat16()
    ckv = torch.randn(b, t, 576, generator=g, device=cuda).bfloat16()
    q_pos = torch.tensor([pos], device=cuda)
    scale = 1 / math.sqrt(192)
    got = mld.mla_decode(q, ckv, q_pos, scale, 512)
    assert torch.equal(mld.mla_decode(q, ckv, q_pos, scale, 512), got)
    want = mld.mla_decode_reference(q, ckv, q_pos, scale, 512)
    torch.testing.assert_close(got, want, rtol=2 ** -6,
                               atol=2 ** -8 * float(want.float().abs().max()))
    splits = mld.mla_decode_splits(2 * b, t, mld._sm_count(0))
    for grp in range(2):
        half = q[:, 16 * grp:16 * (grp + 1)]
        assert torch.equal(mld._launch(half, ckv, q_pos, scale, splits),
                           got[:, 16 * grp:16 * (grp + 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 4096])
def test_held_experts_match_the_loop_over_held_picks(cuda, n):
    """The grouped GEMMs and K8 over 128 held experts of 256 at Kimi
    Linear's widths (d 2304, f 1024, 8 a token), the other card's picks
    -1: against the plain loop, which computes the held picks alone, to
    the grouped GEMMs' tolerance (tests/test_torch_mla_moe.py); no row
    is laid out for another card's pick."""
    e, d, f, k = 128, 2304, 1024, 8
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, generator=g, device=cuda).bfloat16()
    router = (torch.randn(d, 256, generator=g, device=cuda) / d ** 0.5
              ).bfloat16()
    ids, wts = moe.route(x, router, torch.zeros(256, device=cuda), k, 2.446)
    local = ids.masked_fill(ids >= e, -1)
    assert 0 < int((local >= 0).sum()) < n * k
    ws = [(torch.randn(e, d, f, generator=g, device=cuda) / d ** 0.5
           ).bfloat16(),
          (torch.randn(e, d, f, generator=g, device=cuda) / d ** 0.5
           ).bfloat16(),
          (torch.randn(e, f, d, generator=g, device=cuda) / f ** 0.5
           ).bfloat16()]
    got = moe.grouped_swiglu(x, local, wts, *ws)
    assert torch.equal(moe.grouped_swiglu(x, local, wts, *ws), got)
    want = moe.grouped_swiglu_reference(x, local, wts, *ws)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got, want, rtol=2 ** -6, atol=2 ** -8 * scale)
    dest, row_slot, _ = moe.align(local, e, moe.block_rows(n * k, e))
    assert int((row_slot < n * k).sum()) == int((local >= 0).sum())


# A bf16 model K7 and K9 take (32 heads of 512 + 64; KDA heads of 128),
# small elsewhere.
SMALL = dict(TINY, name="kimi-small", hidden_size=256,
             num_attention_heads=32, num_key_value_heads=32,
             kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
             v_head_dim=128, intermediate_size=512, moe_intermediate_size=128,
             num_experts=8, router_experts=16, vocab_size=512,
             max_position_embeddings=512, torch_dtype="bfloat16",
             linear_attn_config=dict(TINY["linear_attn_config"],
                                     head_dim=128, num_heads=2))


@pytest.mark.gpu
def test_graph_replay_equals_uncaptured_step_and_counts(cuda):
    """A ``DecodeLoop`` whose step is a captured graph against the same
    step uncaptured: bitwise the same tokens and caches, KDA state and
    latent rows alike. Each replayed step counts K9 once a KDA layer, K7
    once an MLA layer and each grouped GEMM and K8 once an expert
    layer."""
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
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key])
    graphed.start_sequence(prompt)
    _native.reset_launches()
    for i in range(1, 4):
        graphed.step()
        torch.cuda.synchronize()
        counts = _native.launches()
        assert counts["kda_recurrent"] == 4 * i
        assert counts["mla_decode"] == 2 * i
        assert counts["moe_gemm_up"] == counts["moe_gemm_down"] == 5 * i
        assert counts["moe_combine"] == 5 * i
        # The held rows of the step's 3 tokens, counted by every replay.
        assert 0 < counts["moe_rows_few"] <= 5 * 3 * 4 * i
    assert graphed.step.graph is not None


@pytest.mark.gpu
def test_the_card_matches_the_reference_in_bf16(cuda):
    """The small bf16 model through generate on the card, its logits at
    every served position against the float32 reference on the same
    weights: each request's median gap (the decode-hybrid cell's
    ``logit_gap``) within bf16's reach of the reference's best. Not the
    widest gap: at random weights near-tied router scores and logits flip
    single tokens under bf16 (K9's plain version on the card flips one by
    0.42 at another prompt), as the cell's check allows."""
    from benchmark.drivers.generate_mla import gap_numbers
    from benchmark.reference import llama_ref

    model = _model(SMALL, device=cuda)
    prompt = torch.randint(0, 512, (2, 90), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(8))
    served = llama.generate(model, prompt, 6, device=cuda)
    want = kimi_linear_ref.served_logits(
        SMALL, SEED, [(prompt[r], served[r]) for r in range(2)],
        torch.bfloat16, cuda)
    gaps = gap_numbers([llama_ref.served_gaps(want[r]["f32"], served[r])
                        for r in range(2)])
    assert gaps["logit_gap"] < 0.25
