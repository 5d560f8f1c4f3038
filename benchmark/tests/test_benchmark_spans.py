"""The readers of the program's device-timed spans: each returns the
device ms its phase took a unit where the spans that carry ``dev_s``
match the traced segment's units one to one, and None where they do not
(or where none does); through the harness, a traced tiny cell reports
them once its spans are timed."""

import json
import time

import pytest

from benchmark import harness, spans
from conftest import make_tiny
from rocnrdma_tpu_torch.utils import trace as trace_mod
from rocnrdma_tpu_torch.utils.trace import trace

SPEC = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
TRAIN = {"forward_ms.train": "trainer.forward",
         "backward_ms.train": "trainer.backward",
         "optimizer_ms.train": "trainer.apply"}
GEN = ("prefill_ms.decode", "decode_step_ms.decode", "prefill_ms.prefill",
       "decode_step_ms.prefill")


def _run(units):
    return harness.Run(shape=None, traffic={}, window={},
                       trace={"units": units})


@pytest.fixture(autouse=True)
def clean_ring():
    trace.reset()
    yield
    trace.reset()


def _train_spans(dev, n=None):
    for i, d in enumerate(dev):
        for k, name in enumerate(TRAIN.values()):
            trace.event(name, dur_s=1.0, dev_s=d * (k + 1), step=i + 1)
    for _ in range(n or 0):              # spans outside the segment
        for name in TRAIN.values():
            trace.event(name, dur_s=1.0, step=0)


def test_train_readers_average_over_the_steps():
    bench = harness.Bench()
    _train_spans([0.1, 0.3], n=2)
    run = _run([{"b": 4, "s": 8}] * 2)
    got = {m: bench.reader(m)(run) for m in TRAIN}
    assert got == pytest.approx({"forward_ms.train": 200.0,
                                 "backward_ms.train": 400.0,
                                 "optimizer_ms.train": 600.0})


@pytest.mark.parametrize("steps", [1, 3])
def test_train_readers_refuse_a_count_off_the_steps(steps):
    _train_spans([0.1, 0.2])
    run = _run([{"b": 4, "s": 8}] * steps)
    assert all(spans.train_ms(run, n) is None for n in TRAIN.values())


def test_readers_return_none_without_timed_spans():
    trace.event("trainer.forward", dur_s=1.0, step=1)
    trace.event("generate.prefill", dur_s=1.0, b=2, p=5)
    trace.event("generate.decode", dur_s=1.0, steps=3)
    bench = harness.Bench()
    train = _run([{"b": 4, "s": 8}])
    call = _run([{"b": 2, "p": 5, "new": 4}])
    assert all(bench.reader(m)(train) is None for m in TRAIN)
    assert all(bench.reader(m)(call) is None for m in GEN)
    assert all(bench.reader(m)(harness.Run(None, {}, {}, None)) is None
               for m in tuple(TRAIN) + GEN)


def _calls(calls):
    for b, p, new, pre, dec in calls:
        trace.event("generate.prefill", dur_s=1.0, dev_s=pre, b=b, p=p)
        trace.event("generate.decode", dur_s=1.0, dev_s=dec, steps=new - 1)


def test_generate_readers_split_a_call():
    _calls([(2, 5, 4, 0.5, 0.3), (2, 7, 4, 0.7, 0.6)])
    run = _run([{"b": 2, "p": 5, "new": 4}, {"b": 2, "p": 7, "new": 4}])
    bench = harness.Bench()
    for cell in ("decode", "prefill"):
        assert bench.reader(f"prefill_ms.{cell}")(run) == pytest.approx(600.0)
        assert bench.reader(f"decode_step_ms.{cell}")(run) == \
            pytest.approx(150.0)


@pytest.mark.parametrize("units", [
    [{"b": 2, "p": 5, "new": 4}],                               # one call fewer
    [{"b": 2, "p": 5, "new": 4}] * 3,                           # one more
    [{"b": 2, "p": 5, "new": 5}, {"b": 2, "p": 7, "new": 4}],   # other steps
    [{"b": 3, "p": 5, "new": 4}, {"b": 2, "p": 7, "new": 4}],   # other rows
    [{"b": 2, "s": 5}, {"b": 2, "s": 7}],                       # train steps
])
def test_generate_readers_refuse_calls_that_do_not_match(units):
    _calls([(2, 5, 4, 0.5, 0.3), (2, 7, 4, 0.7, 0.6)])
    run = _run(units)
    assert spans.prefill_ms(run) is None and spans.decode_step_ms(run) is None


def test_one_token_calls_have_no_decode_step():
    _calls([(2, 5, 1, 0.5, 0.0)])
    run = _run([{"b": 2, "p": 5, "new": 1}])
    assert spans.prefill_ms(run) == pytest.approx(500.0)
    assert spans.decode_step_ms(run) is None


def test_the_entries_read_their_cells():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in tuple(TRAIN) + GEN:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"]) == (
            "ms", "lower", "program_span")
        cell = {"train": "train.internlm2-1.8b",
                "decode": "decode.mistral-7b-v0.3",
                "prefill": "prefill.mistral-7b-v0.3"}[name.split(".")[1]]
        assert m["workloads"] == [cell]


class ClockEvent:
    """A timing event on the host's clock, done at once (the CPU has no
    CUDA events; the spans are opened with the run's device)."""

    def __init__(self):
        self.at = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def test_a_traced_tiny_cell_reports_the_span_metrics(tmp_path, monkeypatch):
    folder = make_tiny(tmp_path)
    spec = json.loads((folder.parent / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in TRAIN:
            m["workloads"].append("tiny.train")
        if m["name"] in GEN:
            m["workloads"].append("tiny.gen")
    (folder.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    tiny = harness.Bench(folder)
    seed = 2 ** 31 + 7
    # Without device times (the CPU's own case) the metrics are left out.
    res = harness.run_cell(tiny, "tiny.train", seed, 0.2, True,
                           time.perf_counter(), "cpu")
    assert not set(TRAIN) & set(res["metrics"])
    monkeypatch.setattr(trace_mod, "_device_event",
                        lambda device: ClockEvent())
    for cell, names in (("tiny.train", TRAIN), ("tiny.gen", GEN)):
        trace.reset()
        res = harness.run_cell(tiny, cell, seed, 0.2, True,
                               time.perf_counter(), "cpu")
        assert res["correct"] is True
        for name in names:
            assert res["metrics"][name]["value"] > 0
            assert res["metrics"][name]["unit"] == "ms"
