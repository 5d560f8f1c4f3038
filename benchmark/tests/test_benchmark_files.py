"""The benchmark's files: ``BENCHMARK.json`` against its contract, every
configuration, mix, driver, metric and limit found by name, the traffic
the same for the same seed, a new cell added as new files only, the
result's last line, and the look for JAX."""

import json
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, weights
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:      # the cell reports what it moves
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in cells:                  # setup_s, a rate and a layer each
        assert len(harness.Bench().metrics("end_to_end", cell)) >= 2
        assert harness.Bench().metrics("per_layer", cell)


def test_every_file_loads_by_name():
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        shape = harness.shape_of(bench.config(w["config"]))
        assert shape.head_dim == 128
        traffic = bench.traffic(w["traffic"])
        assert callable(bench.driver(traffic["entry"]))
        assert set(bench.limits(w["name"])) in (
            {"loss_gap", "grad_gap", "update_gap"}, {"logit_gap"})
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_config_files_name_their_source():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"].startswith(c["source"] + "/blob/main/config.json")
        assert len(cfg["source"]) <= 200
        assert cfg["reduced"] == [] and cfg["cut"].startswith("no cut")
    intern = json.loads((ROOT / "benchmark/configs/internlm2-1.8b.json")
                        .read_text())
    assert any(a.startswith("wqkv") for a in intern["assumed"])


def test_published_sizes():
    bench = harness.Bench()
    m = harness.shape_of(bench.config("mistral-7b-v0.3"))
    assert (m.d_model, m.n_layers, m.n_heads, m.n_kv_heads, m.d_ff,
            m.vocab_size) == (4096, 32, 32, 8, 14336, 32768)
    i = harness.shape_of(bench.config("internlm2-1.8b"))
    assert (i.d_model, i.n_layers, i.n_heads, i.n_kv_heads, i.d_ff,
            i.vocab_size) == (2048, 24, 16, 8, 8192, 92544)


def test_traffic_is_the_same_for_the_same_seed():
    seed = 2 ** 31 + 11
    a = weights.tokens("cpu", 1000, 3, 7, seed, weights.PROMPT, 4)
    b = weights.tokens("cpu", 1000, 3, 7, seed, weights.PROMPT, 4)
    c = weights.tokens("cpu", 1000, 3, 7, seed + 1, weights.PROMPT, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    bench = harness.Bench()
    gen = bench.driver("generate")
    groups = bench.traffic("decode")["prompt_lens"]
    lens = sum(groups, [])

    def order(s):
        d = gen.__new__(gen)
        d.seed, d.groups = s, groups
        return [d.prompt_len(i) for i in range(2 * len(lens))]

    assert order(seed) == order(seed)
    # Every seed runs the same lengths, each cycle in its own order, and
    # every even prefix of a cycle the same work (pairs summing alike).
    for s in (seed, seed + 1, 5):
        got = order(s)
        assert sorted(got[:len(lens)]) == sorted(lens)
        for k in range(2, len(lens) + 1, 2):
            assert sum(got[:k]) == k // 2 * sum(groups[0])
    assert order(seed) != order(seed + 1)


def test_weights_are_the_same_for_the_same_seed(tiny):
    shape = harness.shape_of(tiny.config("tiny"))
    g1 = weights.draw_group(shape, 7, 1, "cpu", torch.float32)
    g2 = weights.draw_group(shape, 7, 1, "cpu", torch.float32)
    g3 = weights.draw_group(shape, 8, 1, "cpu", torch.float32)
    for k in g1:
        assert torch.equal(g1[k], g2[k])
    assert not torch.equal(g1["layers.0.attn.wq"], g3["layers.0.attn.wq"])
    assert float(g1["layers.0.attn.wq"].std()) == pytest.approx(1 / 8,
                                                                rel=0.2)


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_added_as_new_files_runs(tiny, trace):
    """The tiny configuration, its mixes, the throwaway metric and the
    two cells are new files and entries of a copy; nothing is edited."""
    for cell, rate in (("tiny.train", "train_tok_s"),
                       ("tiny.gen", "decode_tok_s")):
        res = harness.run_cell(tiny, cell, 2 ** 31 + 5, 0.2, trace,
                               time.perf_counter(), "cpu")
        assert res["correct"] is True and res["failed"] == 0
        if trace:
            assert res["metrics"]["units.tiny"]["value"] == 2.0
            assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(res["metrics"]) >= {"setup_s", rate}


def test_last_line_keys(tiny, capsys):
    res = harness.run_cell(tiny, "tiny.gen", 3, 0.1, False,
                           time.perf_counter(), "cpu")
    assert harness.emit(res) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert err.strip().splitlines()[-1] == "correct True"
    assert err.strip().splitlines()[-2].startswith("check logit_gap ")


def test_jax_is_looked_for_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "rocnrdma_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "rocnrdma_tpu.fake", sys)
    assert "rocnrdma_tpu.fake" in harness.forbidden_modules()
    assert "rocnrdma_tpu_torch_fake" not in harness.forbidden_modules()


def test_reference_imports_neither_jax_nor_the_program(tmp_path):
    assert harness.reference_imports() == []
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "x.py").write_text("import jax.numpy\n"
                              "from rocnrdma_tpu_torch.ops import rmsnorm\n")
    assert harness.reference_imports(tmp_path) == [
        "x.py: jax.numpy", "x.py: rocnrdma_tpu_torch.ops",
        "x.py: rocnrdma_tpu_torch.ops.rmsnorm"]


def test_no_result_without_a_card():
    """Here there is no card: exit 2 and no last line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "train.internlm2-1.8b", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""
