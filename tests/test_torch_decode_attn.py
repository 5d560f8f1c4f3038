"""K6, the decode step's cached attention (``csrc/decode_attn.cu``),
against its plain version.

The CPU tests hold the wrapper's dispatch, checks and split count, and
the registry entries that the benchmark's trace reader relies on. The
``gpu`` tests run only on an NVIDIA card (a CUDA kernel has no CPU mode)
and skip, with their reason, elsewhere; the file imports nothing of JAX:

    python -m pytest tests/test_torch_decode_attn.py -m gpu

Tolerances against the plain version, with their reasons. Both sides
take the same bf16 (or f32) q and k into f32 products and sums, in
another order: the kernel sums a row's products lane by lane and then
over a butterfly, and merges key groups and splits by their running
maxima; the plain version is one f32 GEMM. In f32 that moves the
output by a few f32 steps (rtol 1e-4, and an atol of 1e-5 of the
output's largest entry). In bf16 the kernel rounds each probability to
bf16 before normalising, relative to its running maximum, where the
plain version rounds after normalising: both round every probability by
up to 2^-9 of itself, at different places, and the output is rounded to
bf16 at the end (2^-8 of the value), so the two may differ by a bf16
step of the output plus the rounding of the probabilities summed over
the keys: rtol 2^-6, atol 2^-8 of the output's largest entry.
"""

import re
from pathlib import Path

import pytest
import torch

from benchmark import roofline
from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops import decode_attention as da

CSRC = Path(da.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132


def _tol(want: torch.Tensor):
    scale = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-5 * scale)
    return dict(rtol=2 ** -6, atol=2 ** -8 * scale)


def _inputs(b, h, kvh, t, d, dtype, device, seed, s=1, q_scale=2.0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(b, h, s, d, generator=g, device=device)
         * q_scale).to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device=device).to(dtype)
    return q, k, v


def _plain_by_heads(q, k, v, q_pos):
    """The same function written the long way: heads repeated, one
    softmax a head, in f64."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    kk = k.double().repeat_interleave(rep, dim=1)
    vv = v.double().repeat_interleave(rep, dim=1)
    sc = q.double() @ kk.transpose(-1, -2) / d ** 0.5
    keys = torch.arange(k.shape[2])
    sc = sc.masked_fill(keys[None, :] > q_pos[:, None], float("-inf"))
    return torch.softmax(sc, dim=-1) @ vv


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("b,h,kvh,t,d,dtype,pos,s", [
    (2, 4, 2, 32, 16, torch.float32, 20, 1),       # llama-tiny's step
    (1, 8, 2, 40, 32, torch.float32, 35, 3),       # an int-pos chunk
    (2, 8, 8, 24, 64, torch.bfloat16, 0, 1),       # pos 0
    (1, 4, 1, 16, 128, torch.bfloat16, 15, 1),     # pos T - 1
])
def test_cpu_takes_the_plain_version(b, h, kvh, t, d, dtype, pos, s):
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing; the plain version is the attention it always was
    (against the same function in f64, heads repeated)."""
    q, k, v = _inputs(b, h, kvh, t, d, dtype, "cpu", seed=pos + t, s=s)
    q_pos = torch.arange(pos, pos + s)
    _native.reset_launches()
    got = da.cached_attention(q, k, v, q_pos)
    assert torch.equal(got, da.cached_attention_reference(q, k, v, q_pos))
    assert got.dtype == dtype and got.shape == q.shape
    assert _native.launches()["decode_attn"] == 0
    want = _plain_by_heads(q, k, v, q_pos)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2 ** -6, atol=2 ** -8))
    torch.testing.assert_close(got.double(), want, **tol)


def test_model_uses_the_wrapper():
    """``models/llama.py``'s cached step calls the dispatching wrapper."""
    assert llama.cached_attention is da.cached_attention


@pytest.mark.parametrize("groups,t,n_sm,want", [
    (128 * 8, 1152, H100_SMS, 1),     # the decode cell: B 128, KVH 8
    (16 * 8, 8320, H100_SMS, 4),      # the prefill cell: B 16, KVH 8
    (4 * 8, 640, H100_SMS, 5),        # chip_smoke's path (a): B 4
    (2 * 2, 128, H100_SMS, 1),        # llama-tiny
    (10 ** 6, 1, H100_SMS, 1),        # never zero
    (1, 1, 1, 1),
    (1, 10 ** 6, 1, 4),               # one SM: its resident blocks
])
def test_split_count_at_the_cells_shapes(groups, t, n_sm, want):
    got = da.decode_splits(groups, t, n_sm)
    assert got == want
    assert got >= 1
    assert -(-t // got) >= min(t, da.MIN_KEYS_PER_SPLIT)
    # One wave: a second split only where the blocks still fit at once.
    assert got == 1 or groups * got <= da.BLOCKS_PER_SM * n_sm


def test_wrapper_constants_match_the_source():
    """The rows a block holds and the blocks an SM runs, by which the
    wrapper sizes the grid and the splits, are the kernel's."""
    text = (CSRC / "decode_attn.cu").read_text()
    assert f"constexpr int kRows = {da.BLOCK_ROWS};" in text
    assert f"constexpr int kMinBlocks = {da.BLOCKS_PER_SM};" in text
    assert "__launch_bounds__(kThreads, kMinBlocks)" in text


def test_registry_lists_decode_attn():
    """K6 is registered like K1-K5: its C entry and argument types, a
    launch counter, a build of its own source."""
    P, I, L, F = (_native._P, _native._I, _native._L, _native._F)
    assert "decode_attn" in _native.KERNELS
    assert _native.SIGNATURES["decode_attn"] == (
        "decode_attn", [P] * 7 + [I] * 7 + [L] * 9 + [F, I, P])
    assert "decode_attn" in _native.launches()
    assert _native._source("decode_attn") == CSRC / "decode_attn.cu"
    assert _native.library_path("decode_attn").name.startswith(
        "libdecode_attn-")


def _device_functions(source: Path):
    text = source.read_text()
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                          r"\)\s+)?(\w+)\s*\(", text))


def test_k6_device_functions_are_declared_and_named_apart():
    """Every ``__global__`` of K6's source is declared in ``_native`` and
    starts with ``decode_attn``; none contains a name of K1-K5, by which
    the benchmark finds those in a trace."""
    found = _device_functions(CSRC / "decode_attn.cu")
    assert found == set(_native.DECODE_ATTN_FUNCTIONS)
    for name in found:
        assert name.startswith("decode_attn")
        assert not any(k in name for k in roofline.KERNELS)


@pytest.mark.parametrize("symbol", [
    *_native.DECODE_ATTN_FUNCTIONS,
    "void (anonymous namespace)::decode_attn_split<__nv_bfloat16, 128>"
    "(__nv_bfloat16 const*, __nv_bfloat16 const*)",
    "void (anonymous namespace)::decode_attn_combine<float>(float const*)",
    "decode_attn",
])
def test_roofline_kernel_of_ignores_k6(symbol):
    assert roofline.kernel_of(symbol) is None


def _bad(case):
    q, k, v = _inputs(2, 4, 2, 16, 64, torch.bfloat16, "cpu", 0)
    pos = torch.tensor([5])
    if case == "head_dim":
        q, k, v = _inputs(2, 4, 2, 16, 48, torch.bfloat16, "cpu", 0)
    elif case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "mixed_dtype":
        k = k.float()
    elif case == "groups":
        q = torch.zeros(2, 3, 1, 64, dtype=torch.bfloat16)
    elif case == "pos_dtype":
        pos = pos.int()
    elif case == "pos_shape":
        pos = torch.tensor([5, 6])
    elif case == "row_stride":
        k = torch.zeros(2, 2, 16, 68, dtype=torch.bfloat16)[..., :64]
        v = k
    elif case == "unit_stride":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "misaligned":
        k = torch.zeros(2 * 2 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 2, 16, 64)
    return q, k, v, pos


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed_dtype",
                                  "groups", "pos_dtype", "pos_shape",
                                  "row_stride", "unit_stride", "misaligned"])
def test_kernel_checks_refuse(case):
    """What the kernel does not take raises before a launch (on the card
    there is no fallback to the plain version)."""
    with pytest.raises((ValueError, TypeError)):
        da._check(*_bad(case))


def test_kernel_checks_take_the_caches_views():
    """The prefix view of a cache (the int-pos step) and a one-token q
    pass the checks as they are, with no copy."""
    cache = torch.zeros(2, 2, 64, 128, dtype=torch.bfloat16)
    q = torch.zeros(2, 8, 1, 128, dtype=torch.bfloat16)
    da._check(q, cache[:, :, :37], cache[:, :, :37], torch.tensor([36]))
    assert da._strides(cache[:, :, :37]) == (2 * 64 * 128, 64 * 128, 128)
    assert da._strides(q) == (8 * 128, 128, 0)


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = {
    # the decode cell: B 128, Mistral's 32/8 heads, the 1152-long cache
    "decode_777": (128, 32, 8, 1152, 128, torch.bfloat16, 777),
    "decode_1145": (128, 32, 8, 1152, 128, torch.bfloat16, 1145),
    # the prefill cell's decode steps: B 16, 8320 positions
    "prefill_8200": (16, 32, 8, 8320, 128, torch.bfloat16, 8200),
    # chip_smoke's path (a): llama3-8b at B 4, a 640-long cache
    "path_a": (4, 32, 8, 640, 128, torch.bfloat16, 540),
    # llama-tiny, f32 at hd 16
    "tiny_f32": (2, 4, 2, 128, 16, torch.float32, 37),
    "pos_0": (3, 8, 2, 256, 64, torch.bfloat16, 0),
    "pos_last": (3, 8, 2, 256, 64, torch.bfloat16, 255),
    "bf16_hd32": (2, 6, 3, 200, 32, torch.bfloat16, 150),
    "bf16_hd16": (2, 4, 4, 96, 16, torch.bfloat16, 60),
    "f32_hd128": (2, 16, 8, 700, 128, torch.float32, 650),
    "f32_hd64": (1, 4, 2, 300, 64, torch.float32, 299),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_k6_matches_plain_and_repeats_bitwise(cuda, case):
    """The whole cache passed (the graphed step's static shape) with
    ``pos`` a device tensor; two calls give the same bits; one launch a
    call."""
    b, h, kvh, t, d, dtype, pos = CARD_CASES[case]
    q, k, v = _inputs(b, h, kvh, t, d, dtype, cuda, seed=t + pos)
    q_pos = torch.tensor([pos], device=cuda)
    _native.reset_launches()
    got = da.cached_attention(q, k, v, q_pos)
    again = da.cached_attention(q, k, v, q_pos)
    torch.cuda.synchronize()
    assert _native.launches()["decode_attn"] == 2
    assert torch.equal(got, again)
    want = da.cached_attention_reference(q, k, v, q_pos)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **_tol(want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["decode_777", "prefill_8200", "tiny_f32",
                                  "f32_hd128"])
def test_k6_split_counts_agree(cuda, case):
    """One split (no combine pass) and several give the plain version's
    result within the tolerance, each bitwise repeatable."""
    b, h, kvh, t, d, dtype, pos = CARD_CASES[case]
    q, k, v = _inputs(b, h, kvh, t, d, dtype, cuda, seed=3 * t + pos)
    q_pos = torch.tensor([pos], device=cuda)
    want = da.cached_attention_reference(q, k, v, q_pos)
    for splits in (1, 2, 7, 32):
        got = da._launch(q, k, v, q_pos, splits)
        assert torch.equal(got, da._launch(q, k, v, q_pos, splits))
        torch.testing.assert_close(got, want, **_tol(want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float32, 16),
                                     (torch.bfloat16, 64)])
def test_k6_int_pos_prefix_view_with_several_queries(cuda, dtype, d):
    """The int-pos step: s = 5 queries at pos .. pos + 4, each with its
    own last key, against a ``[:, :, :t]`` view of a longer cache (its
    strides are the whole cache's), q a transposed view."""
    b, h, kvh, s, cache_len, pos = 3, 8, 2, 5, 512, 301
    q, k, v = _inputs(b, h, kvh, cache_len, d, dtype, cuda, seed=d, s=s)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    t = pos + s
    q_pos = torch.arange(pos, t, device=cuda)
    kv, vv = k[:, :, :t], v[:, :, :t]
    assert not kv.is_contiguous()
    got = da.cached_attention(q, kv, vv, q_pos)
    want = da.cached_attention_reference(q, kv, vv, q_pos)
    torch.testing.assert_close(got, want, **_tol(want))
    # Row i sees keys up to pos + i: its output differs from the next's.
    assert not torch.equal(got[:, :, 0], got[:, :, 1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["decode_777", "prefill_8200", "tiny_f32"])
def test_k6_never_reads_past_pos(cuda, case):
    """Cache rows past ``pos`` filled with NaN leave the output bitwise
    as it is with zeros there: the kernel does not read them."""
    b, h, kvh, t, d, dtype, pos = CARD_CASES[case]
    q, k, v = _inputs(b, h, kvh, t, d, dtype, cuda, seed=5 * t + pos)
    k[:, :, pos + 1:] = 0
    v[:, :, pos + 1:] = 0
    q_pos = torch.tensor([pos], device=cuda)
    clean = da.cached_attention(q, k, v, q_pos)
    k[:, :, pos + 1:] = float("nan")
    v[:, :, pos + 1:] = float("nan")
    dirty = da.cached_attention(q, k, v, q_pos)
    assert torch.isfinite(dirty.float()).all()
    assert torch.equal(dirty, clean)


def _bf16_model(cuda):
    cfg = llama.LlamaConfig(name="decode-bf16", vocab_size=512, d_model=512,
                            n_layers=3, n_heads=4, n_kv_heads=1, d_ff=1024,
                            max_seq_len=1024)
    model = llama.Llama(cfg, device=cuda)
    model.load_state_dict(llama.init_params(cfg, seed=2, device=cuda),
                          assign=True)
    return model


def _tiny_model(cuda):
    model = llama.Llama(llama.LLAMA_TINY, device=cuda)
    model.load_state_dict(llama.init_params(llama.LLAMA_TINY, seed=0,
                                            device=cuda), assign=True)
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tiny_f32", "bf16_hd128"])
def test_graph_replay_equals_uncaptured_step_and_counts(cuda, which):
    """A ``DecodeLoop`` whose step is a captured graph against the same
    step run uncaptured: bitwise the same tokens and caches. Each replayed
    step counts K6 ``n_layers`` times."""
    model = _tiny_model(cuda) if which == "tiny_f32" else _bf16_model(cuda)
    cfg = model.cfg
    prompt = torch.randint(0, cfg.vocab_size, (3, 70), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    new = 9
    graphed = llama.DecodeLoop(model, 3, 128, capture=True)
    plain = llama.DecodeLoop(model, 3, 128, capture=False)
    want = plain.run(prompt, new)
    got = graphed.run(prompt, new)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(graphed.cache, plain.cache):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    _native.reset_launches()
    graphed.start_sequence(prompt)
    for i in range(1, 4):
        graphed.step()
        torch.cuda.synchronize()
        assert _native.launches()["decode_attn"] == cfg.n_layers * i
    assert graphed.step.graph is not None


@pytest.mark.gpu
def test_int_pos_chunk_on_the_card_matches_the_cpu(cuda):
    """llama-tiny f32: a 6-token prefill then a 3-token chunk at int pos
    6 and one token at pos 9 (K6 with s = 3, then 1, on prefix views),
    logits against the same model on the CPU (plain versions)."""
    model = _tiny_model(cuda)
    cpu = llama.Llama(llama.LLAMA_TINY, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tok = torch.randint(0, 256, (2, 10),
                        generator=torch.Generator().manual_seed(6))
    c_gpu = llama.init_cache(model.cfg, 2, 64, device=cuda)
    c_cpu = llama.init_cache(model.cfg, 2, 64, device="cpu")
    with torch.inference_mode():
        for lo, hi in ((0, 6), (6, 9), (9, 10)):
            got = model(tok[:, lo:hi].to(cuda), c_gpu, lo)
            want = cpu(tok[:, lo:hi], c_cpu, lo)
            torch.testing.assert_close(got.cpu(), want, rtol=2e-4,
                                       atol=2e-4)
