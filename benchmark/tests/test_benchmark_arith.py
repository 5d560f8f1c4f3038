"""The yardstick's arithmetic against hand counts at small shapes."""

import types

import pytest

from benchmark import roofline as rl

HBM, BF16 = rl.HBM_BYTES_PER_S, rl.PEAK_FLOPS["bfloat16"]

# d 8, 2 layers, 2 heads of 4, 1 KV head, FFN 16, vocab 10.
TOY = types.SimpleNamespace(d_model=8, n_layers=2, n_heads=2, n_kv_heads=1,
                            d_ff=16, vocab_size=10, head_dim=4)


def test_norm_bounds_count_each_byte_once():
    # 4 rows of 8 in bf16 read and written, the f32 weight read.
    assert rl.rmsnorm_fwd_bound_s(4, 8, "bfloat16") == \
        pytest.approx((64 + 64 + 32) / HBM)
    # x, dy read and dx written; the weight read and its gradient written.
    assert rl.rmsnorm_bwd_bound_s(4, 8, "bfloat16") == \
        pytest.approx((3 * 64 + 64) / HBM)


def test_flash_forward_bound_by_bytes_and_by_operations():
    # B1 H2 KVH1 S4 D8 causal: 10 visible pairs a head.
    flops = 4 * 8 * 10 * 2
    nbytes = (2 * 2 * 4 * 8 + 2 * 4 * 8) * 2 + 2 * 4 * 4
    assert rl.flash_fwd_bound_s(1, 2, 1, 4, 8, True, "bfloat16") == \
        pytest.approx(max(flops / BF16, nbytes / HBM))
    assert nbytes / HBM > flops / BF16
    # At S 4096, D 128 the products bound it.
    s, d = 4096, 128
    t = rl.flash_fwd_bound_s(1, 16, 8, s, d, True, "bfloat16")
    assert t == pytest.approx(4 * d * s * (s + 1) / 2 * 16 / BF16)


def test_flash_backward_bounds():
    got = rl.flash_bwd_bounds_s(1, 2, 1, 4, 8, False, "bfloat16")
    q, kv, lse = 2 * 4 * 8 * 2, 4 * 8 * 2, 2 * 4 * 4
    inb = 2 * q + 2 * kv + 2 * lse
    assert got["flash_bwd_dkv"] == pytest.approx(
        max(8 * 8 * 16 * 2 / BF16, (inb + 2 * kv) / HBM))
    assert got["flash_bwd_dq"] == pytest.approx(
        max(6 * 8 * 16 * 2 / BF16, (inb + q) / HBM))


def test_model_flops_by_hand():
    # q, k, v, o: 8 × 4 × (2 + 1 + 1 + 2) = 192; MLP 3 × 8 × 16 = 384.
    assert rl.layer_matmul_params(TOY) == 192 + 384
    assert rl.matmul_params(TOY) == 2 * 576 + 80
    b, s = 3, 5
    attn = 3 * 4 * 4 * (5 * 6 // 2) * 2 * b * 2
    assert rl.train_step_flops(TOY, b, s) == 6 * 1232 * b * s + attn


def test_forward_work_by_hand():
    # Two rows, one new position after 6 cached ones, logits once a row.
    flops, nbytes = rl.forward_work(TOY, 2, 1, 6, 1, "bfloat16")
    assert flops == 2 * 576 * 2 * 2 * 1 + 4 * 4 * 7 * 2 * 2 * 2 \
        + 2 * 8 * 10 * 2
    kv_row = 2 * 1 * 4 * 2 * 2
    assert nbytes == 576 * 2 * 2 + 80 * 2 + 5 * 8 * 4 + 2 * 8 * 2 \
        + 2 * 6 * kv_row + 2 * kv_row


def test_generate_call_is_its_forwards():
    want = rl.bound_s(*rl.forward_work(TOY, 2, 5, 0, 1, "bfloat16"),
                      "bfloat16")[0]
    for j in range(1, 3):
        want += rl.bound_s(*rl.forward_work(TOY, 2, 1, 5 + j - 1, 1,
                                            "bfloat16"), "bfloat16")[0]
    assert rl.generate_call_min_s(TOY, 2, 5, 3, "bfloat16") == \
        pytest.approx(want)


@pytest.mark.parametrize("symbol,kernel", [
    ("void (anonymous namespace)::tc::flash_bwd_dkv_tc_kernel<128>(...)",
     "flash_bwd_dkv"),
    ("void (anonymous namespace)::tc::flash_bwd_dq_tc_kernel<128>(...)",
     "flash_bwd_dq"),
    ("void (anonymous namespace)::tc::flash_fwd_tc_kernel<128>(...)",
     "flash_fwd"),
    ("void rmsnorm_fwd_vec<__nv_bfloat16>(...)", "rmsnorm_fwd"),
    ("void rmsnorm_bwd_reduce(float const*, int, int, float*)",
     "rmsnorm_bwd"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", None),
])
def test_kernel_symbols(symbol, kernel):
    assert rl.kernel_of(symbol) == kernel


def test_kernels_roofline_reads_nothing_it_cannot_bound():
    from benchmark import readers

    shape = types.SimpleNamespace(**vars(TOY), dtype="bfloat16")
    seg = {"ops": {"void rmsnorm_fwd_vec<float>(...)": [1e-3, 12]},
           "units": [{"b": 2, "p": 5, "new": 3,
                      "launches": {"rmsnorm_fwd": 15, "flash_fwd": 2}}],
           "busy_s": 1.0, "window_s": 2.0, "kernels": 30}
    run = types.SimpleNamespace(shape=shape, trace=seg, window=None)
    per = 5
    want = per * (rl.rmsnorm_fwd_bound_s(10, 8, "bfloat16")
                  + 2 * rl.rmsnorm_fwd_bound_s(2, 8, "bfloat16")) \
        + 2 * rl.flash_fwd_bound_s(2, 2, 1, 5, 4, True, "bfloat16")
    assert readers.kernels_roofline(run) == pytest.approx(100 * want / 1e-3)
    assert readers.idle_share(run) == pytest.approx(50.0)
    assert readers.launches_per_unit(run) == 30
    seg["units"][0]["launches"]["rmsnorm_bwd"] = 1     # not a generate call's
    assert readers.kernels_roofline(run) is None
    seg["busy_s"] = 0.0
    assert readers.idle_share(run) is None
