"""Fixtures of the benchmark's own tests: a throwaway copy of the
benchmark's folder with tiny cells added as new files and new
``BENCHMARK.json`` entries, no file of the copy edited."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "name": "tiny", "source": "a throwaway test configuration",
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "vocab_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
    "max_position_embeddings": 128, "torch_dtype": "float32", "reduced": []}

TRAFFIC = {
    "tiny_train": {"entry": "train", "batch": 4, "seq_len": 32,
                   "learning_rate": 0.0003, "weight_decay": 0.1,
                   "remat": True, "remat_policy": "full", "check_steps": 3,
                   "trace_units": 2},
    "tiny_gen": {"entry": "generate", "batch": 3, "prompt_lens": [9, 14, 20],
                 "new_tokens": 6, "check_requests": 4, "trace_units": 2},
}

# The throwaway per-layer metric: steps per traced segment.
READER = '''"""units.tiny: units in the traced segment."""


def read(run):
    return float(len(run.trace["units"])) if run.trace else None
'''


def make_tiny(tmp_path: Path, limits=None) -> Path:
    """A copy of the benchmark's folder under ``tmp_path`` with the tiny
    configuration, its two mixes, a throwaway metric and two cells
    added; returns the copy's folder."""
    src = ROOT / "benchmark"
    dst = tmp_path / "benchmark"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, t in TRAFFIC.items():
        (dst / "traffic" / f"{name}.json").write_text(json.dumps(t))
    (dst / "metrics" / "units.tiny.py").write_text(READER)
    limits = limits or {}
    cells = {"tiny.train": "tiny_train", "tiny.gen": "tiny_gen"}
    for cell, mix in cells.items():
        lim = limits.get(cell) or json.loads(
            (src / "limits" / ("train.internlm2-1.8b.json" if "train" in mix
                               else "decode.mistral-7b-v0.3.json")
             ).read_text())
        (dst / "limits" / f"{cell}.json").write_text(json.dumps(lim))
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": mix, "chips": 1,
                                  "why": "a throwaway test cell"})
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["end_to_end"][1]["workloads"].append("tiny.train")
    spec["end_to_end"][2]["workloads"].append("tiny.gen")
    spec["end_to_end"][3]["workloads"].append("tiny.gen")
    spec["per_layer"].append({"name": "units.tiny", "unit": "units",
                              "better": "higher", "source": "program_counter",
                              "layer": "model step", "moves": "train_tok_s",
                              "workloads": ["tiny.train", "tiny.gen"]})
    for m in spec["per_layer"]:
        if m["name"] in ("mfu.train",):
            m["workloads"].append("tiny.train")
        if m["name"] in ("mfu.decode", "mfu.prefill"):
            m["workloads"].append("tiny.gen")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture
def tiny(tmp_path):
    from benchmark import harness

    return harness.Bench(make_tiny(tmp_path))
