"""The latent-attention, routed-expert cell's files: the configuration,
mix, driver, limit and readers found by name, the weights the same for
the same seed, the reference against the program at a tiny size, a tiny
cell of the same entry run through the harness, and the arithmetic of
``roofline_mla`` and its readers."""

import copy
import json
import shutil
import time

import pytest
import torch

from benchmark import harness, readers_mla, roofline_mla, weights_mla
from benchmark.reference import mla_moe_ref
from conftest import ROOT

CELL = "decode-mla.moonlight-16b-a3b"
NEW_METRICS = ("mfu.decode-mla", "prefill_ms.decode-mla",
               "decode_step_ms.decode-mla", "moe_ms.decode-mla",
               "mla_decode_roofline.decode-mla", "moe_roofline.decode-mla",
               "idle_share.decode-mla")

# Moonlight's published keys at a tiny size: 1 dense and 2 expert layers,
# 8 experts, 2 a token, 1 shared.
TINY_MLA = {
    "name": "tiny-mla", "source": "a throwaway test configuration",
    "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "intermediate_size": 96, "moe_intermediate_size": 24,
    "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
    "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
    "max_position_embeddings": 128, "rope_theta": 50000,
    "rms_norm_eps": 1e-05, "torch_dtype": "float32", "q_lora_rank": None,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "norm_topk_prob": True, "reduced": []}


def test_the_cell_loads_by_name():
    bench = harness.Bench()
    cell = bench.cell(CELL)
    cfg = bench.config(cell["config"])
    shape = harness.shape_of(cfg)
    assert (shape.d_model, shape.n_layers, shape.n_heads, shape.vocab_size,
            shape.dtype) == (2048, 27, 16, 163840, "bfloat16")
    traffic = bench.traffic(cell["traffic"])
    assert traffic["entry"] == "generate_mla" and traffic["batch"] == 64
    assert callable(bench.driver(traffic["entry"]))
    assert set(bench.limits(CELL)) == {"logit_gap"}
    assert {m["name"] for m in bench.metrics("per_layer", CELL)} == set(
        NEW_METRICS)
    for name in NEW_METRICS:
        assert callable(bench.reader(name))
    assert [m["name"] for m in bench.metrics("end_to_end", CELL)] == [
        "setup_s", "decode_tok_s"]


def test_decode_long_is_data_over_the_generate_entry():
    bench = harness.Bench()
    cell = bench.cell("decode-long.mistral-7b-v0.3")
    traffic = bench.traffic(cell["traffic"])
    assert traffic["entry"] == "generate" and traffic["batch"] == 12
    assert {m["name"] for m in bench.metrics(
        "per_layer", "decode-long.mistral-7b-v0.3")} == {
        "decode_step_ms.decode-long", "mfu.decode-long",
        "idle_share.decode-long", "prefill_ms.decode-long",
        "kernels_roofline.decode-long"}
    assert set(bench.limits("decode-long.mistral-7b-v0.3")) == {"logit_gap"}


def test_the_config_holds_the_catalog_entry_uncut():
    """Every published number of Moonlight-16B-A3B under its own key, and
    the model the program builds from them at their widths."""
    from rocnrdma_tpu_torch.models.mla_moe import MOONLIGHT_16B, MlaMoeConfig

    cfg = harness.Bench().config("moonlight-16b-a3b")
    assert cfg["reduced"] == [] and cfg["cut"].startswith("no cut")
    want = {"hidden_size": 2048, "num_hidden_layers": 27,
            "num_attention_heads": 16, "kv_lora_rank": 512,
            "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "v_head_dim": 128, "intermediate_size": 11264,
            "moe_intermediate_size": 1408, "n_routed_experts": 64,
            "n_shared_experts": 2, "num_experts_per_tok": 6,
            "routed_scaling_factor": 2.446, "rope_theta": 50000,
            "vocab_size": 163840, "max_position_embeddings": 8192,
            "first_k_dense_replace": 1, "q_lora_rank": None}
    assert {k: cfg[k] for k in want} == want
    built = MlaMoeConfig.from_hf(cfg)
    assert built == MOONLIGHT_16B
    assert round(built.param_count() / 1e9, 2) == 15.96


def test_weights_are_the_same_for_the_same_seed():
    seed = 2 ** 31 + 17
    g1 = weights_mla.draw_group(TINY_MLA, seed, 2, "cpu", torch.float32)
    g2 = weights_mla.draw_group(TINY_MLA, seed, 2, "cpu", torch.float32)
    g3 = weights_mla.draw_group(TINY_MLA, seed + 1, 2, "cpu", torch.float32)
    for k in g1:
        assert torch.equal(g1[k], g2[k])
    w = "layers.1.moe.w_down"
    assert not torch.equal(g1[w], g3[w])
    assert g1[w].shape == (8, 24, 64)
    assert float(g1[w].std()) == pytest.approx(24 ** -0.5, rel=0.2)
    assert torch.equal(g1["layers.1.moe.router_bias"], torch.zeros(8))


def test_weight_names_are_the_programs():
    from rocnrdma_tpu_torch.models.mla_moe import (MlaMoe, MlaMoeConfig,
                                                   param_shapes)

    cfg = MlaMoeConfig.from_hf(TINY_MLA)
    drawn = {name: s for _, leaves in weights_mla.groups(TINY_MLA)
             for name, s, _ in leaves}
    assert drawn == param_shapes(cfg)
    model = MlaMoe(cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == drawn


def test_reference_matches_the_program_at_a_tiny_size():
    """The reference's full forward against the program's no-cache
    forward on the seed's weights, in float32 on the CPU: the same
    equations in another order of sums."""
    from rocnrdma_tpu_torch.models.mla_moe import MlaMoe, MlaMoeConfig

    model = MlaMoe(MlaMoeConfig.from_hf(TINY_MLA), "cpu")
    for group in weights_mla.draw_all(TINY_MLA, 9, "cpu", torch.float32):
        model.load_state_dict(group, strict=False)
    tok = torch.randint(0, 256, (2, 30), generator=torch.Generator()
                        .manual_seed(3))
    with torch.no_grad():
        got = model(tok)
    want = mla_moe_ref.forward(TINY_MLA, 9, [tok[0], tok[1]],
                               torch.float32, "cpu")
    for j in range(2):
        torch.testing.assert_close(got[j], want[j]["f32"], rtol=1e-5,
                                   atol=2e-5)


def test_reference_imports_are_clean():
    assert harness.reference_imports() == []


def _tiny_mla_bench(tmp_path):
    src = ROOT / "benchmark"
    dst = tmp_path / "benchmark"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "configs" / "tiny-mla.json").write_text(json.dumps(TINY_MLA))
    (dst / "traffic" / "tiny_mla.json").write_text(json.dumps({
        "entry": "generate_mla", "batch": 3, "prompt_lens": [[9, 20], 14],
        "new_tokens": 5, "check_requests": 4, "trace_units": 1}))
    (dst / "limits" / "tiny-mla.gen.json").write_text(
        json.dumps({"logit_gap": 0.4}))
    spec["configs"].append({"name": "tiny-mla", "source": "test",
                            "file": "benchmark/configs/tiny-mla.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-mla.gen", "config": "tiny-mla",
                              "traffic": "tiny_mla", "chips": 1,
                              "why": "a throwaway test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "decode_tok_s":
            m["workloads"].append("tiny-mla.gen")
    for m in spec["per_layer"]:
        if m["name"] in ("prefill_ms.decode-mla", "decode_step_ms.decode-mla",
                         "idle_share.decode-mla"):
            m["workloads"].append("tiny-mla.gen")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(dst)


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_of_the_entry_runs(tmp_path, trace):
    """The ``generate_mla`` entry through the harness on the CPU: the
    program's served tokens against the reference, correct; traced, the
    spans' readers find the calls (the device's share needs a card)."""
    bench = _tiny_mla_bench(tmp_path)
    res = harness.run_cell(bench, "tiny-mla.gen", 2 ** 31 + 7, 0.3, trace,
                           time.perf_counter(), "cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["logit_gap"]["value"] == 0.0
    assert res["readings"]["logit_gap_widest"] == 0.0
    if trace:
        # On the CPU the spans carry no device time and the segment no
        # device operation: every reader finds nothing, and says so.
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"setup_s", "decode_tok_s"}


def _run(units, trace_units=None, ops=None):
    shape = harness.shape_of(harness.Bench().config("moonlight-16b-a3b"))
    win = {"elapsed": 30.0, "units": units}
    seg = None if trace_units is None else {
        "units": trace_units, "ops": ops or {}, "busy_s": 1.0,
        "window_s": 1.0, "kernels": 1}
    return harness.Run(shape, {}, win, seg)


def test_mfu_counts_each_forward_at_its_least_time():
    cfg = harness.Bench().config("moonlight-16b-a3b")
    u = {"b": 64, "p": 3968, "new": 256}
    need = roofline_mla.generate_call_min_s(cfg, 64, 3968, 256, "bfloat16")
    got = readers_mla.mfu_generate(_run([u, dict(u)]))
    assert got == pytest.approx(100 * 2 * need / 30.0)
    # A decode step at the cell's shape is bound by its bytes: every
    # weight but the embedding's (31.2 GB) and the live latent cache.
    flops, nbytes = roofline_mla.forward_work(cfg, 64, 1, 4032, 1,
                                              "bfloat16")
    assert flops / 989e12 < nbytes / 3.35e12
    assert 31.0e9 < roofline_mla.weight_bytes(roofline_mla.dims(cfg),
                                              "bfloat16") < 31.5e9
    assert 11.0e-3 < nbytes / 3.35e12 < 12.5e-3
    assert readers_mla.mfu_generate(_run([])) is None


def test_kernel_readers_count_launches_from_the_units_shapes():
    cfg = harness.Bench().config("moonlight-16b-a3b")
    b, p, new = 64, 3900, 4
    launches = {"mla_decode": 27 * (new - 1),
                "moe_gemm_up": 26 * (new - 1) + 26 * 4,
                "moe_gemm_down": 26 * (new - 1) + 26 * 4}
    unit = {"b": b, "p": p, "new": new, "launches": launches}
    k7 = 27 * sum(roofline_mla.mla_decode_bound_s(cfg, b, p + j, "bfloat16")
                  for j in range(1, new))
    dec = sum(roofline_mla.moe_gemm_bounds_s(cfg, b, "bfloat16"))
    pre = sum(roofline_mla.moe_gemm_bounds_s(cfg, b * p // 4, "bfloat16"))
    moe = 26 * (new - 1) * dec + 4 * 26 * pre
    ops = {"void mla_decode_split(...)": [2 * k7, 81],
           "moe_gemm_up": [moe, 182], "moe_gemm_down": [moe, 182],
           "flash_fwd_kernel": [5.0, 27]}
    run = _run([], [unit], ops)
    assert readers_mla.mla_decode_roofline(run) == pytest.approx(50.0)
    assert readers_mla.moe_roofline(run) == pytest.approx(50.0)
    # K7 at the cell's shape is bound by its bytes: 64 x 4034 x 1152 B.
    assert roofline_mla.mla_decode_bound_s(cfg, 64, 4034, "bfloat16") == \
        pytest.approx((64 * 4034 * 576 + 64 * 16 * 1088) * 2 / 3.35e12)
    # Counts the shapes do not account for read as None, not as a share.
    bad = copy.deepcopy(unit)
    bad["launches"]["mla_decode"] += 1
    bad["launches"]["moe_gemm_up"] += 1
    run = _run([], [bad], ops)
    assert readers_mla.mla_decode_roofline(run) is None
    assert readers_mla.moe_roofline(run) is None
    assert readers_mla.mla_decode_roofline(_run([], [unit], {})) is None


def test_gap_numbers_take_each_requests_median_and_the_widest():
    """``logit_gap`` is the widest request's median gap; the mean, the
    share off the best token and the widest single gap are readings."""
    from benchmark.drivers.generate_mla import gap_numbers

    got = gap_numbers([torch.tensor([0.0, 0.0, 0.0, 9.0]),
                       torch.tensor([0.0, 1.0, 2.0, 3.0])])
    assert got == {"logit_gap": 1.5, "logit_gap_mean": 2.25,
                   "argmax_miss_share": 0.75, "logit_gap_widest": 9.0}
