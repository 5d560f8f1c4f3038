"""The Kimi Linear cell's files and the train-long cell's: the
configuration's keys against the catalog's and its ``reduced``, the mixes
readable by their drivers, the weights the same for the same seed, the
reference against the program at a tiny size and clean of the program's
imports, a tiny cell of the ``generate_hybrid`` entry run through the
harness, and the arithmetic of ``roofline_kimi`` and its readers (K9's
bound by hand at one shape)."""

import copy
import json
import shutil
import time

import pytest
import torch

from benchmark import harness, readers_kimi, roofline_kimi, weights_kimi
from benchmark.reference import kimi_linear_ref
from conftest import ROOT

CELL = "decode-hybrid.kimi-linear-48b-a3b"
LONG = "train-long.internlm2-1.8b"
NEW_METRICS = ("mfu.decode-hybrid", "prefill_ms.decode-hybrid",
               "decode_step_ms.decode-hybrid", "kda_ms.decode-hybrid",
               "kda_roofline.decode-hybrid",
               "mla_decode_roofline.decode-hybrid",
               "moe_roofline.decode-hybrid", "idle_share.decode-hybrid",
               "moe_ms.decode-hybrid")
LONG_METRICS = ("mfu.train-long", "backward_ms.train-long",
                "kernels_roofline.train-long", "idle_share.train-long",
                "forward_ms.train-long", "optimizer_ms.train-long",
                "launches_per_step.train-long")

# Kimi-Linear-48B-A3B-Instruct's published config.json, the keys that say
# something of its shape.
CATALOG = {
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu",
    "hidden_size": 2304, "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                       21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "model_max_length": 1048576,
    "model_type": "kimi_linear", "moe_intermediate_size": 1024,
    "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
    "num_expert_group": 1, "num_experts": 256, "num_experts_per_token": 8,
    "num_hidden_layers": 27, "num_key_value_heads": 32,
    "num_nextn_predict_layers": 0, "num_shared_experts": 1,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000,
    "routed_scaling_factor": 2.446, "tie_word_embeddings": False,
    "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840}

# Kimi Linear's keys at a tiny size: two periods of 2 KDA and 1 MLA
# layer, the first dense; 16 experts, 8 held, 4 a token, 1 shared.
TINY_KIMI = {
    "name": "tiny-kimi", "source": "a throwaway test configuration",
    "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 6,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "intermediate_size": 96, "moe_intermediate_size": 24, "num_experts": 8,
    "router_experts": 16, "first_expert": 0, "num_shared_experts": 1,
    "num_experts_per_token": 4, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "max_position_embeddings": 128,
    "rope_theta": 10000, "rms_norm_eps": 1e-05, "torch_dtype": "float32",
    "q_lora_rank": None, "mla_use_nope": True,
    "linear_attn_config": {"full_attn_layers": [3, 6],
                           "kda_layers": [1, 2, 4, 5], "head_dim": 16,
                           "num_heads": 4, "short_conv_kernel_size": 4},
    "reduced": ["num_experts"]}


def test_the_cells_load_by_name():
    bench = harness.Bench()
    cell = bench.cell(CELL)
    assert cell["chips"] == 1
    cfg = bench.config(cell["config"])
    shape = harness.shape_of(cfg)
    assert (shape.d_model, shape.n_layers, shape.n_heads, shape.vocab_size,
            shape.dtype) == (2304, 27, 32, 163840, "bfloat16")
    traffic = bench.traffic(cell["traffic"])
    assert traffic["entry"] == "generate_hybrid"
    assert (traffic["batch"], traffic["new_tokens"]) == (128, 384)
    assert callable(bench.driver(traffic["entry"]))
    assert set(bench.limits(CELL)) == {"logit_gap"}
    assert {m["name"] for m in bench.metrics("per_layer", CELL)} == set(
        NEW_METRICS)
    assert [m["name"] for m in bench.metrics("end_to_end", CELL)] == [
        "setup_s", "decode_tok_s"]
    long = bench.cell(LONG)
    assert (long["config"], long["chips"]) == ("internlm2-1.8b", 1)
    t = bench.traffic(long["traffic"])
    assert t["entry"] == "train" and callable(bench.driver(t["entry"]))
    assert (t["batch"], t["seq_len"], t["remat"], t["check_steps"],
            t["trace_units"]) == (1, 16384, False, 3, 3)
    assert (t["learning_rate"], t["weight_decay"]) == (3e-4, 0.1)
    assert set(bench.limits(LONG)) == {"loss_gap", "grad_gap", "update_gap"}
    assert {m["name"] for m in bench.metrics("per_layer", LONG)} == set(
        LONG_METRICS)
    assert [m["name"] for m in bench.metrics("end_to_end", LONG)] == [
        "setup_s", "train_tok_s"]
    for name in NEW_METRICS + LONG_METRICS:
        assert callable(bench.reader(name))


def test_the_traffic_files_are_readable_by_their_drivers():
    """Each mix's keys are those its entry reads: the hybrid mix's
    prompt lengths all fit one cache length of 2,048 with their 384 new
    tokens, in pairs that sum alike; the long mix is the train mix's keys
    at 1 × 16,384."""
    bench = harness.Bench()
    hybrid = bench.traffic("decode-hybrid")
    decode_mla = bench.traffic("decode-mla")
    assert set(hybrid) == set(decode_mla)
    gen = bench.driver(hybrid["entry"])
    d = gen.__new__(gen)
    d.shape = harness.shape_of(bench.config("kimi-linear-48b-a3b"))
    lens = sum(hybrid["prompt_lens"], [])
    assert {d.cache_len(p, hybrid["new_tokens"]) for p in lens} == {2048}
    assert len({sum(g) for g in hybrid["prompt_lens"]}) == 1
    assert set(bench.traffic("train-long")) == set(bench.traffic("train"))


def test_the_config_holds_the_catalog_entry_with_the_held_experts():
    """Every key of the published config, with its value, but the one the
    cut changes: ``num_experts`` 128 of the router's 256, listed in
    ``reduced`` here and in ``BENCHMARK.json``, with the deployment
    stated beside it."""
    bench = harness.Bench()
    cfg = bench.config("kimi-linear-48b-a3b")
    for key, value in CATALOG.items():
        if key == "num_experts":
            continue
        assert cfg[key] == value, key
    assert (cfg["num_experts"], cfg["router_experts"],
            cfg["first_expert"]) == (128, 256, 0)
    assert cfg["reduced"] == ["num_experts"]
    spec = {c["name"]: c for c in bench.spec["configs"]}
    assert spec["kimi-linear-48b-a3b"]["reduced"] == ["num_experts"]
    assert cfg["source"].startswith(spec["kimi-linear-48b-a3b"]["source"]
                                    + "/blob/main/config.json")
    assert "expert parallel 2" in cfg["deployment"]
    assert any(a.startswith("max_position_embeddings") for a in
               cfg["assumed"])
    # 25.6 B parameters held: 23.55 B in the held experts.
    total = experts = 0
    for _, leaves in weights_kimi.groups(cfg):
        for name, shape, _ in leaves:
            n = torch.Size(shape).numel()
            total += n
            experts += n if ".moe.w_" in name else 0
    assert experts == 26 * 128 * 3 * 2304 * 1024
    assert 25.5e9 < total < 25.7e9


def test_weights_are_the_same_for_the_same_seed():
    g1 = weights_kimi.draw_group(TINY_KIMI, 7, 1, "cpu", torch.float32)
    g2 = weights_kimi.draw_group(TINY_KIMI, 7, 1, "cpu", torch.float32)
    g3 = weights_kimi.draw_group(TINY_KIMI, 8, 1, "cpu", torch.float32)
    for k in g1:
        assert torch.equal(g1[k], g2[k])
    assert not torch.equal(g1["layers.0.kda.wqkv"], g3["layers.0.kda.wqkv"])
    assert g1["layers.0.kda.A_log"].dtype == torch.float32
    layer1 = weights_kimi.draw_group(TINY_KIMI, 7, 2, "cpu", torch.float32)
    assert layer1["layers.1.moe.router"].shape == (64, 16)
    assert layer1["layers.1.moe.w_gate"].shape == (8, 64, 24)


def test_reference_matches_the_program_at_a_tiny_size():
    """The reference's full forward against the program's no-cache
    forward on the seed's weights, in float32 on the CPU: the same
    equations in another order of sums."""
    from rocnrdma_tpu_torch.models.kimi_linear import (KimiLinear,
                                                       KimiLinearConfig)

    model = KimiLinear(KimiLinearConfig.from_hf(TINY_KIMI), "cpu")
    for group in weights_kimi.draw_all(TINY_KIMI, 9, "cpu", torch.float32):
        model.load_state_dict(group, strict=False)
    tok = torch.randint(0, 256, (2, 30), generator=torch.Generator()
                        .manual_seed(3))
    with torch.no_grad():
        got = model(tok)
    want = kimi_linear_ref.forward(TINY_KIMI, 9, [tok[0], tok[1]],
                                   torch.float32, "cpu")
    for j in range(2):
        torch.testing.assert_close(got[j], want[j]["f32"], rtol=1e-5,
                                   atol=2e-5)


def test_reference_imports_are_clean():
    """The Kimi reference imports neither JAX, the JAX package nor the
    program, nor does any benchmark module it reaches."""
    assert harness.reference_imports() == []
    src = (ROOT / "benchmark" / "reference" / "kimi_linear_ref.py"
           ).read_text()
    assert "rocnrdma_tpu" not in src.replace(
        "benchmark.harness.reference_imports", "")


def _tiny_kimi_bench(tmp_path):
    src = ROOT / "benchmark"
    dst = tmp_path / "benchmark"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "configs" / "tiny-kimi.json").write_text(json.dumps(TINY_KIMI))
    (dst / "traffic" / "tiny_kimi.json").write_text(json.dumps({
        "entry": "generate_hybrid", "batch": 3, "prompt_lens": [[9, 20], 14],
        "new_tokens": 5, "check_requests": 4, "trace_units": 1}))
    (dst / "limits" / "tiny-kimi.gen.json").write_text(
        json.dumps({"logit_gap": 0.4}))
    spec["configs"].append({"name": "tiny-kimi", "source": "test",
                            "file": "benchmark/configs/tiny-kimi.json",
                            "reduced": ["num_experts"], "why": "test"})
    spec["workloads"].append({"name": "tiny-kimi.gen", "config": "tiny-kimi",
                              "traffic": "tiny_kimi", "chips": 1,
                              "why": "a throwaway test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "decode_tok_s":
            m["workloads"].append("tiny-kimi.gen")
    # The span readers; those of the yardstick read the cell's
    # configuration from the checkout's own BENCHMARK.json.
    for m in spec["per_layer"]:
        if m["name"] in ("prefill_ms.decode-hybrid", "kda_ms.decode-hybrid",
                         "decode_step_ms.decode-hybrid",
                         "idle_share.decode-hybrid", "moe_ms.decode-hybrid"):
            m["workloads"].append("tiny-kimi.gen")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(dst)


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_of_the_entry_runs(tmp_path, trace):
    """The ``generate_hybrid`` entry through the harness on the CPU: the
    program's served tokens against the reference, correct; traced, the
    readers find no device time and say so."""
    bench = _tiny_kimi_bench(tmp_path)
    res = harness.run_cell(bench, "tiny-kimi.gen", 2 ** 31 + 7, 0.3, trace,
                           time.perf_counter(), "cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["logit_gap"]["value"] == 0.0
    assert res["readings"]["logit_gap_widest"] == 0.0
    assert res["readings"]["logit_gap_median"] == 0.0
    if trace:
        # On the CPU the spans carry no device time and the segment no
        # device operation: every reader finds nothing, and says so.
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"setup_s", "decode_tok_s"}


def test_gap_numbers_read_each_requests_tenth_percentile():
    """``logit_gap`` is the widest request's gap at its tenth percentile
    of positions: a request that serves the reference's best token at
    more than a tenth of them reads 0, however wide its other gaps; the
    median (``generate_mla``'s number) and the rest are readings."""
    from benchmark.drivers.generate_hybrid import QUANTILE, gap_numbers

    hits = torch.tensor([0.0] * 2 + [5.0] * 8)
    misses = torch.arange(1.0, 11.0)
    got = gap_numbers([hits, misses])
    assert QUANTILE == 0.1
    assert got["logit_gap"] == pytest.approx(float(misses.quantile(0.1)))
    assert gap_numbers([hits])["logit_gap"] == 0.0
    assert got["logit_gap_median"] == 5.5
    assert set(got) == {"logit_gap", "logit_gap_median", "logit_gap_mean",
                        "argmax_miss_share", "logit_gap_widest"}


def _run(units, trace_units=None, ops=None):
    shape = harness.shape_of(harness.Bench().config("kimi-linear-48b-a3b"))
    win = {"elapsed": 30.0, "units": units}
    seg = None if trace_units is None else {
        "units": trace_units, "ops": ops or {}, "busy_s": 1.0,
        "window_s": 1.0, "kernels": 1}
    return harness.Run(shape, {}, win, seg)


def test_k9_bound_by_hand():
    """K9 at the decode step's 128 sequences of one token: the state
    (128 × 32 heads × 128² f32) read and written, and each token-head's
    q, k, v, o in bf16 (4 × 256 B), its decay (512 B) and beta (4 B):
    bytes bound it, over 3.35 TB/s. Over 40 × 1,600 tokens it is still
    bytes: 7·128² operations a token-head (~74 an operation's byte)."""
    cfg = harness.Bench().config("kimi-linear-48b-a3b")
    state = 2 * 4 * 128 * 32 * 128 * 128
    per = 128 * 32 * (4 * 128 * 2 + 128 * 4 + 4)
    assert roofline_kimi.kda_bound_s(cfg, 128, 1, "bfloat16") == \
        pytest.approx((state + per) / 3.35e12)
    chunk = 2 * 4 * 40 * 32 * 128 * 128 + 40 * 1600 * 32 * 1540
    assert roofline_kimi.kda_bound_s(cfg, 40, 1600, "bfloat16") == \
        pytest.approx(chunk / 3.35e12)
    assert 7 * 128 * 128 * 40 * 1600 * 32 / 989e12 < chunk / 3.35e12


def test_mfu_counts_each_forward_at_its_least_time():
    cfg = harness.Bench().config("kimi-linear-48b-a3b")
    u = {"b": 128, "p": 1600, "new": 384}
    need = roofline_kimi.generate_call_min_s(cfg, 128, 1600, 384, "bfloat16")
    got = readers_kimi.mfu_generate(_run([u, dict(u)]))
    assert got == pytest.approx(100 * 2 * need / 30.0)
    # A decode step at the cell's shape is bound by its bytes: the 51.1 GB
    # held but the embedding's 0.75 GB (counted by the rows looked up),
    # 10.7 GB of KDA state read and written, the live latent rows.
    flops, nbytes = roofline_kimi.forward_work(cfg, 128, 1, 1800, 1,
                                               "bfloat16")
    assert flops / 989e12 < nbytes / 3.35e12
    assert 50.2e9 < roofline_kimi.weight_bytes(roofline_kimi.dims(cfg),
                                               "bfloat16") < 50.6e9
    assert 17.5e-3 < nbytes / 3.35e12 < 20.0e-3
    assert readers_kimi.mfu_generate(_run([])) is None


def test_kernel_readers_count_launches_from_the_units_shapes():
    cfg = harness.Bench().config("kimi-linear-48b-a3b")
    b, p, new = 128, 1600, 4
    few, many = (3 * 470, 3 * 110), (26 * 4 * 102400, 26 * 4 * 127)
    launches = {"kda_recurrent": 20 * (new - 1) + 20 * 4,
                "mla_decode": 7 * (new - 1),
                "moe_gemm_up": 26 * (new - 1) + 26 * 4,
                "moe_gemm_down": 26 * (new - 1) + 26 * 4,
                "moe_gemm_many": 2 * 26 * 4,
                "moe_rows_few": few[0], "moe_experts_few": few[1],
                "moe_rows_many": many[0], "moe_experts_many": many[1]}
    unit = {"b": b, "p": p, "new": new, "launches": launches}
    k9 = 20 * ((new - 1) * roofline_kimi.kda_bound_s(cfg, b, 1, "bfloat16")
               + roofline_kimi.kda_bound_s(cfg, b, p, "bfloat16"))
    k7 = 7 * sum(roofline_kimi.mla_decode_bound_s(cfg, b, p + j, "bfloat16")
                 for j in range(1, new))
    moe = (sum(roofline_kimi.moe_gemm_bounds_s(cfg, 26 * 3 * b, *few,
                                               "bfloat16"))
           + sum(roofline_kimi.moe_gemm_bounds_s(cfg, 26 * b * p, *many,
                                                 "bfloat16")))
    ops = {"void kda_recurrent_kernel(...)": [2 * k9, 140],
           "void mla_decode_split(...)": [4 * k7, 21],
           "moe_gemm_up": [moe, 182], "moe_gemm_down": [moe, 182]}
    run = _run([], [unit], ops)
    assert readers_kimi.kda_roofline(run) == pytest.approx(50.0)
    assert readers_kimi.mla_decode_roofline(run) == pytest.approx(25.0)
    assert readers_kimi.moe_roofline(run) == pytest.approx(50.0)
    # K7 at 32 heads: each live latent row once a sequence, q and out.
    assert roofline_kimi.mla_decode_bound_s(cfg, 128, 1801, "bfloat16") == \
        pytest.approx((128 * 1801 * 576 + 128 * 32 * 1088) * 2 / 3.35e12)
    # G1 by hand: a decode step's launch over 128 tokens, 520 rows of 120
    # touched experts (bytes), and a prefill chunk's (operations).
    up, down = roofline_kimi.moe_gemm_bounds_s(cfg, 128, 520, 120,
                                               "bfloat16")
    assert up == pytest.approx((120 * 2304 * 2048 + 128 * 2304 + 520 * 1024)
                               * 2 / 3.35e12)
    assert down == pytest.approx((120 * 1024 * 2304 + 520 * (1024 + 2304))
                                 * 2 / 3.35e12)
    up, _ = roofline_kimi.moe_gemm_bounds_s(cfg, 51200, 204800, 128,
                                            "bfloat16")
    assert up == pytest.approx(2.0 * 204800 * 2304 * 2048 / 989e12)
    # Counts the shapes do not account for read as None, not as a share;
    # so does a program without the device counters.
    bad = copy.deepcopy(unit)
    for key in ("kda_recurrent", "mla_decode", "moe_gemm_up"):
        bad["launches"][key] += 1
    run = _run([], [bad], ops)
    assert readers_kimi.kda_roofline(run) is None
    assert readers_kimi.mla_decode_roofline(run) is None
    assert readers_kimi.moe_roofline(run) is None
    bare = copy.deepcopy(unit)
    for key in ("moe_rows_few", "moe_experts_few", "moe_rows_many",
                "moe_experts_many"):
        del bare["launches"][key]
    assert readers_kimi.moe_roofline(_run([], [bare], ops)) is None
    assert readers_kimi.kda_roofline(_run([], [unit], {})) is None
