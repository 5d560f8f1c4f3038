"""The port's tracer: spans as profiler ranges, device-timed spans, and
the spans of the model path.

On the CPU: under ``torch.profiler`` a span opens a ``record_function``
range of its name, and the train step's ``trainer.forward``,
``trainer.backward`` and ``trainer.apply`` nest in its
``trainer.fused_step``; outside it no range opens and the ring's events
keep their fields; ``generate`` records its prefill and its decode steps;
the memo's evictions, the kernel builds and the mesh's operations are
named events; a device span's ``dev_s`` is read back by ``query()`` at a
later close, or when the ring is read, and reaches the Perfetto export
as an argument; importing the tracer loads no torch. On the card
(``-m gpu``): the device times add up to a synchronised step's wall time,
and reading them adds no host synchronisation.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.parallel import mesh as tmesh
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from rocnrdma_tpu_torch.telemetry import perfetto, recorder
from rocnrdma_tpu_torch.utils import trace as trace_mod
from rocnrdma_tpu_torch.utils.trace import trace

TRAIN_SPANS = ("trainer.forward", "trainer.backward", "trainer.apply")


def _tokens(seed, shape, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


def _ranges(prof, name):
    """(start, end) in µs of every profiler range named ``name``."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


@pytest.fixture
def tiny_model():
    model = tllama.Llama(tllama.LLAMA_TINY, device="cpu")
    model.load_state_dict(tllama.init_params(tllama.LLAMA_TINY, seed=1,
                                             device="cpu"))
    return model


@pytest.fixture
def opened(monkeypatch):
    """The names of the ``record_function`` ranges the tracer opens."""
    names = []
    real = autograd_profiler.record_function

    class Counting(real):
        def __init__(self, name, *args, **kwargs):
            names.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    return names


def test_span_is_a_profiler_range_of_its_name():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.outer", k=1):
            with trace.span("test.inner"):
                torch.ones(8).sum()
    (outer,), (inner,) = _ranges(prof, "test.outer"), _ranges(prof,
                                                               "test.inner")
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]
    (_, _, fields), = trace.events("test.outer")
    assert set(fields) == {"dur_s", "k"}


def test_train_spans_nest_in_the_fused_step_on_every_step():
    trace.reset()
    tr = Trainer("llama-tiny", device="cpu", seed=3)
    steps = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(steps):
            tr.step(_tokens(i, (2, 17)))
    fused = _ranges(prof, "trainer.fused_step")
    assert len(fused) == steps
    for a, b in fused:
        inside = [[r for r in _ranges(prof, n) if a <= r[0] and r[1] <= b]
                  for n in TRAIN_SPANS]
        assert [len(r) for r in inside] == [1, 1, 1]
        (fwd,), (bwd,), (app,) = inside
        assert fwd[1] <= bwd[0] and bwd[1] <= app[0]
    # Each step then reads its loss and drops its graph.
    finish = _ranges(prof, "trainer.finish")
    assert len(finish) == steps
    assert all(f[1] <= a for f, (a, _) in zip(fused, finish))
    assert [f["step"] for _, _, f in trace.events("trainer.finish")] == [
        1, 2, 3]
    for name in ("trainer.fused_step",) + TRAIN_SPANS:
        evs = trace.events(name)
        assert [f["step"] for _, _, f in evs] == [1, 2, 3]
        # On the CPU no span has a device time.
        assert all(set(f) == {"dur_s", "step"} for _, _, f in evs)


def test_no_range_opens_outside_the_profiler(opened, tiny_model):
    trace.reset()
    tr = Trainer("llama-tiny", device="cpu", seed=3)
    tr.step(_tokens(0, (2, 9)))
    tllama.generate(tiny_model, _tokens(1, (2, 5)), 3, device="cpu")
    ours = [n for n in opened if n.startswith(("trainer.", "generate."))]
    assert ours == []
    (_, _, fused), = trace.events("trainer.fused_step")
    assert set(fused) == {"dur_s", "step"} and fused["dur_s"] > 0
    (_, _, pre), = trace.events("generate.prefill")
    assert set(pre) == {"dur_s", "b", "p"}
    # The same calls under the profiler open them, each once.
    with profile(activities=[ProfilerActivity.CPU]):
        tr.step(_tokens(2, (2, 9)))
    assert [n for n in opened if n.startswith("trainer.")] == [
        "trainer.fused_step", *TRAIN_SPANS, "trainer.finish"]


@pytest.mark.parametrize("new", [1, 4])
def test_generate_records_its_prefill_and_decode(tiny_model, new):
    trace.reset()
    out = tllama.generate(tiny_model, _tokens(4, (3, 6)), new, device="cpu")
    assert out.shape == (3, new)
    (_, _, pre), = trace.events("generate.prefill")
    (_, _, dec), = trace.events("generate.decode")
    assert (pre["b"], pre["p"], dec["steps"]) == (3, 6, new - 1)
    assert "dev_s" not in pre and "dev_s" not in dec


def test_loop_eviction_is_counted_with_its_bytes(tiny_model, monkeypatch):
    monkeypatch.setattr(tllama, "_GEN_CACHE", {})
    monkeypatch.setattr(tllama, "_GEN_CACHE_MAX_BYTES", 1)
    trace.reset()
    tllama.generate(tiny_model, _tokens(5, (1, 4)), 2, device="cpu")
    (first,) = tllama._GEN_CACHE.values()
    assert trace.counter("generate.loop_evict") == 0
    tllama.generate(tiny_model, _tokens(6, (2, 4)), 2, device="cpu")
    assert trace.counter("generate.loop_evict") == 1
    (_, _, ev), = trace.events("generate.loop_evict")
    assert ev == {"bytes": first.nbytes} and first.nbytes > 0


def test_kernel_build_is_a_span_with_the_names_built(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_native, "nvcc_command", lambda name, out: [
        sys.executable, "-c", f"open({str(out)!r}, 'w').close()"])
    trace.reset()
    secs = _native.build(["rmsnorm_fwd", "flash_fwd"])
    assert set(secs) == {"rmsnorm_fwd", "flash_fwd"}
    (_, _, ev), = trace.events("kernels.build")
    assert ev["names"] == ["rmsnorm_fwd", "flash_fwd"]
    # Nothing left to compile: no build, no span.
    assert _native.build(["rmsnorm_fwd"]) == {"rmsnorm_fwd": 0.0}
    assert trace.counter("kernels.build") == 1


def test_mesh_operations_are_spans():
    trace.reset()
    mesh = tmesh.make_mesh({"dp": 1, "tp": 2}, ["cpu"] * 2)
    xs = [torch.randn(3, requires_grad=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ys = tmesh.psum(xs, mesh, "tp")
        torch.autograd.grad(ys, xs, [torch.ones(3)] * 2)
    assert len(_ranges(prof, "mesh.psum")) == 2      # forward and back
    assert trace.counter("mesh.psum") == 2


class FakeEvent:
    """A CUDA timing event stand-in: done once ``done`` is set; counts
    synchronisations."""

    clock = 0.0
    syncs = 0

    def __init__(self):
        self.done = False
        self.at = FakeEvent.clock

    def query(self):
        return self.done

    def synchronize(self):
        FakeEvent.syncs += 1
        self.done = True

    def elapsed_time(self, end):
        assert end.done                   # the start is done before it
        return (end.at - self.at) * 1e3


@pytest.fixture
def fake_device(monkeypatch):
    """Device spans on: the telemetry recorder's switch, timing events
    faked."""
    made = []

    def device_event(device):
        if torch.device(device).type != "cuda":
            return None
        made.append(FakeEvent())
        return made[-1]

    FakeEvent.clock, FakeEvent.syncs = 0.0, 0
    monkeypatch.setattr(trace_mod, "_device_event", device_event)
    monkeypatch.setattr(trace, "_telemetry", True)
    trace.reset()
    yield made
    trace.reset()


def test_device_time_is_read_by_query_at_a_later_close(fake_device):
    with trace.span("dev.a", "cuda", k=1):
        FakeEvent.clock = 0.25
    (_, _, a), = list(trace._ring)
    assert "dev_s" not in a and len(trace._pending) == 1
    for ev in fake_device:
        ev.done = True
    with trace.span("dev.b", "cpu"):
        pass
    assert a["dev_s"] == pytest.approx(0.25) and not trace._pending
    assert FakeEvent.syncs == 0
    # The CPU span is timed on the host only.
    assert "dev_s" not in trace.events("dev.b")[0][2]


def test_reading_the_ring_settles_device_time(fake_device):
    with trace.span("dev.c", "cuda", step=7):
        FakeEvent.clock = 0.5
    (_, _, c), = trace.events("dev.c")
    assert c["dev_s"] == pytest.approx(0.5) and c["step"] == 7
    assert FakeEvent.syncs == 1 and not trace._pending


def test_device_time_reaches_the_wire_and_perfetto_as_a_number(fake_device):
    with trace.span("dev.d", "cuda"):
        FakeEvent.clock = 0.125
    events = recorder.python_events()
    (ev,) = [e for e in events if e.name == "dev.d"]
    assert ev.fields["dev_s"] == pytest.approx(0.125)
    (wire,) = [w for w in recorder.events_to_wire(events) if w[1] == "dev.d"]
    assert set(wire[2]) == {"dur_s", "dev_s"}
    doc = perfetto.export_trace(events=events)
    (sl,) = [e for e in doc["traceEvents"] if e["name"] == "dev.d"]
    assert sl["ph"] == "X" and sl["args"] == {"dev_s": ev.fields["dev_s"]}
    perfetto.dumps(doc)                   # JSON throughout


def test_off_a_span_times_no_device(monkeypatch):
    made = []
    monkeypatch.setattr(trace_mod, "_device_event",
                        lambda device: made.append(device))
    monkeypatch.setattr(trace, "_telemetry", False)
    with trace.span("dev.off", "cuda"):
        pass
    assert made == [] and not trace._pending


def test_importing_the_tracer_loads_no_torch():
    code = ("import sys\n"
            "import rocnrdma_tpu_torch.utils.trace\n"
            "import rocnrdma_tpu_torch\n"
            "assert 'torch' not in sys.modules, sorted(sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mid_trainer(device):
    """A step long enough on the card (~200 ms on an H100) that the
    host's share of it (the gradients zeroed, the loss read) is well
    under 2%."""
    cfg = tllama.LlamaConfig(
        name="trace-mid", vocab_size=32000, d_model=2048, n_layers=24,
        n_heads=16, n_kv_heads=8, d_ff=5632, max_seq_len=2048,
        dtype=torch.bfloat16)
    return Trainer(cfg, device=device, seed=0)


SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


def _syncs(prof):
    return {n: sum(1 for e in prof.events() if e.name == n) for n in SYNCS}


@pytest.mark.gpu
def test_device_spans_add_up_to_the_step_on_the_card(cuda, monkeypatch):
    tr = _mid_trainer(cuda)
    batch = [_tokens(i, (4, 2049), 32000).to(cuda) for i in range(5)]
    for tok in batch[:2]:                       # builds and warms
        tr.step(tok)
    monkeypatch.setattr(trace, "_telemetry", True)
    trace.reset()
    walls = []
    for tok in batch[2:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step(tok)                            # ends on the host's float
        walls.append(time.perf_counter() - t0)
    dev = {n: [f["dev_s"] for _, _, f in trace.events(n)]
           for n in ("trainer.fused_step",) + TRAIN_SPANS}
    for i, wall in enumerate(walls):
        parts = sum(dev[n][i] for n in TRAIN_SPANS)
        assert abs(dev["trainer.fused_step"][i] - wall) <= 0.02 * wall, \
            (i, dev, walls)
        assert abs(parts - wall) <= 0.02 * wall, (i, parts, walls)


@pytest.mark.gpu
def test_reading_device_time_adds_no_synchronisation(cuda, monkeypatch):
    tr = _mid_trainer(cuda)
    batch = [_tokens(i, (2, 1025), 32000).to(cuda) for i in range(5)]
    tr.step(batch[0])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):              # the profiler's first use
        tr.step(batch[0])
    counts = {}
    for timed in (True, False):
        with monkeypatch.context() as m:
            if not timed:
                m.setattr(trace_mod, "_device_event", lambda device: None)
            trace.reset()
            with profile(activities=acts) as prof:
                for tok in batch[1:3] if timed else batch[3:5]:
                    tr.step(tok)
            counts[timed] = _syncs(prof)
            fused = trace.events("trainer.fused_step")
            assert all(("dev_s" in f) == timed for _, _, f in fused)
    assert counts[True] == counts[False], counts
    assert counts[True]["cudaEventSynchronize"] == 0


@pytest.mark.gpu
def test_generate_spans_cover_the_call_on_the_card(cuda, monkeypatch):
    cfg = tllama.LlamaConfig(
        name="trace-gen", vocab_size=32000, d_model=1024, n_layers=4,
        n_heads=8, n_kv_heads=4, d_ff=2816, max_seq_len=1024,
        dtype=torch.bfloat16)
    model = tllama.Llama(cfg, device=cuda)
    model.load_state_dict(tllama.init_params(cfg, seed=2, device=cuda))
    prompt = _tokens(9, (8, 500), 32000).to(cuda)
    tllama.generate(model, prompt, 12, device=cuda)      # builds, captures
    monkeypatch.setattr(trace, "_telemetry", True)
    trace.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tllama.generate(model, prompt, 12, device=cuda).cpu()
    wall = time.perf_counter() - t0
    (_, _, pre), = trace.events("generate.prefill")
    (_, _, dec), = trace.events("generate.decode")
    assert dec["steps"] == 11 and trace.counter("graph.capture") == 0
    assert 0 < pre["dev_s"] and 0 < dec["dev_s"]
    assert pre["dev_s"] + dec["dev_s"] <= 1.02 * wall
