"""``tools/torch_overlap_smoke.py`` against ``tools/overlap_smoke.py``,
and the per-layer trainer's backward span it measures.

Tier-1 (each drive in a ``python -c`` subprocess: the tool sets
``TDR_TELEMETRY_RING``, ``TDR_TRACE_RING``, ``TDR_PROGRESS_SHARDS`` and
``TDR_RING_CHANNELS`` before the port loads; ring ports from
``tests/test_hier.py``'s ``port_band``), at the reference's quick
setting (2 steps):

- the lite drive: bitwise buckets and ``pending_async`` zero (asserted
  in the drive), wire events, and the reference's lite keys;
- the full drive on the CPU, ranks as threads: the censuses,
  ``pending_async`` zero and the int8 losses within 5e-3 of the fused
  pair's (asserted in the drive), wire events, and the reference's full
  keys with its ``compute_gate`` keys;
- the full drive as two rank processes (the card's shape) on the CPU:
  each rank's censuses and record, the merged ``OVERLAP`` record's keys,
  and on a card's record the gate reported, not held, with its bound
  note;
- the per-layer trainer's ``trainer.backward`` span closes only once
  every bucket has been posted, as the JAX trainer's closes once its
  taps have staged and launched every bucket.

The reference's keys are read off its source. The two timing gates
(``overlap_fraction > 0.3``, ``compute_overlap_fraction > 0.7``) stay
out of tier-1; the CLI with every gate runs as a ``slow`` test (the
port's ``make overlap-smoke``), and lite mode's too.
"""

import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rocnrdma_tpu_torch.collectives import torch_shim
from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import port_band
from test_torch_smokes import _line, _run
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
TOOL = os.path.join(TOOLS, "torch_overlap_smoke.py")


def _dict_keys(node):
    return [k.value for k in node.keys if k is not None]


def _reference_keys():
    """(the full record's keys, the lite record's literal keys, the
    ``compute_gate`` keys) of ``tools/overlap_smoke.py``."""
    with open(os.path.join(TOOLS, "overlap_smoke.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def returned(name):
        rets = [n for n in ast.walk(funcs[name]) if isinstance(n, ast.Return)
                and isinstance(n.value, ast.Dict)]
        return _dict_keys(rets[-1].value)

    gate = next(n.value for n in ast.walk(funcs["main"])
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Subscript)
                and n.targets[0].slice.value == "compute_gate")
    return returned("full_main"), returned("lite_main"), _dict_keys(gate)


def _overlap_keys():
    """The keys ``telemetry.overlap_fraction`` returns (the lite record
    spreads them in), from the reference's recorder."""
    out = _run("import json\n"
               "from rocnrdma_tpu import telemetry\n"
               "print('KEYS ' + json.dumps(list("
               "telemetry.overlap_fraction([], dropped=0))))",
               JAX_PLATFORMS="cpu")
    return _line(out, "KEYS ")


_LITE = """
import json
import torch_overlap_smoke as m
out = m.lite_main(port={port})
m.gate(out, True, False)
print("OVERLAP " + json.dumps(out))
"""


def test_lite_drive_bitwise_with_the_references_keys():
    out = _line(_run(_LITE.format(port=port_band(8)), TDR_OVERLAP_QUICK="1"),
                "OVERLAP ")
    _, lite, gate = _reference_keys()
    assert list(out) == lite + _overlap_keys() + ["compute_gate"]
    assert list(out["compute_gate"]) == gate
    assert out["mode"] == "lite" and out["steps"] == 2
    assert out["wire_events"] > 0
    assert len(out["windows"]) == 2
    # Lite mode's compute gate follows the coarse one, as the
    # reference's does.
    assert out["compute_gate"]["threshold"] == 0.3


_FULL_THREADS = """
import json
import torch_overlap_smoke as m
out, detail = m.full_main(port={port})
m.gate(out, False, False, detail)
print("OVERLAP " + json.dumps(out))
print("DETAIL " + json.dumps(detail))
"""


def test_full_drive_cpu_threads_holds_the_untimed_gates():
    stdout = _run(_FULL_THREADS.format(port=port_band(16)),
                  TDR_OVERLAP_QUICK="1")
    out, detail = _line(stdout, "OVERLAP "), _line(stdout, "DETAIL ")
    full, _, gate = _reference_keys()
    assert list(out) == full + ["compute_gate"]
    assert list(out["compute_gate"]) == gate
    assert out["wire_events"] > 0
    assert out["per_layer"] is True and out["wire_dtype"] == "int8"
    assert len(out["windows"]) == len(out["compute_windows"]) == 2
    assert detail["device"] == "cpu" and detail["ranks"] == "threads"
    assert detail["pending_async"] == [0, 0]
    c = detail["census"]
    assert c["steady"] <= c["baseline"] and c["closed"] < c["baseline"]
    assert c["after_fused"] <= c["closed"]
    for losses, fused in zip(detail["losses"], detail["fused_losses"]):
        assert len(losses) == 5 and len(fused) == 3
        assert max(abs(a - b) for a, b in zip(losses, fused)) < 5e-3


_FULL_PROCS = """
import json
import torch_overlap_smoke as m
out, detail = m.full_main_procs(port={port}, device="cpu")
print("OVERLAP " + json.dumps(out))
print("DETAIL " + json.dumps(detail))
# A card's record: the fractions reported with their bound note, not
# gated; wire events still are.
card = dict(out)
g, timing = m.gate(card, False, True, detail)
print("CARD " + json.dumps({{"gate": card["compute_gate"],
                             "timing": timing}}))
low = dict(card, overlap_fraction=0.0, compute_overlap_fraction=0.0)
errs = []
for rec, bind in ((low, timing), (dict(low, wire_events=0), timing),
                  (low, True)):
    try:
        m.check(rec, g, bind)
        errs.append(None)
    except AssertionError as e:
        errs.append(str(e))
print("CHECKS " + json.dumps(errs))
"""


def test_full_drive_as_rank_processes():
    """The card's shape, two rank processes of the tool, run here on
    the CPU (one intra-op thread a process): each rank checked its own
    censuses and losses; the parent merged both ranks' windows. On a
    card's record the gate is reported with its bound note and only the
    wire events bind."""
    stdout = _run(_FULL_PROCS.format(port=port_band(16)), timeout=600,
                  TDR_OVERLAP_QUICK="1", OMP_NUM_THREADS="1")
    out, detail = _line(stdout, "OVERLAP "), _line(stdout, "DETAIL ")
    full, _, gate = _reference_keys()
    assert list(out) == full
    assert out["wire_events"] > 0
    assert len(out["windows"]) == 4          # 2 windows from each rank
    assert detail["ranks"] == "processes" and detail["device"] == "cpu"
    assert [rk["rank"] for rk in detail["per_rank"]] == [0, 1]
    for rk in detail["per_rank"]:
        assert rk["pending_async"] == [0]
        c = rk["census"]
        assert c["steady"] <= c["baseline"] and c["closed"] < c["baseline"]
        assert rk["steps_run"] == 8
        assert set(rk["launches"].values()) == {0}   # plain versions
        assert rk["ring_ms_per_step"] > 0
    card = _line(stdout, "CARD ")
    assert card["timing"] is False
    assert list(card["gate"]) == gate
    assert "not gated" in card["gate"]["bound_note"]
    assert "ms" in card["gate"]["bound_note"]
    held, no_wire, timed = _line(stdout, "CHECKS ")
    assert held is None
    assert "no wire events" in no_wire
    assert "overlap_fraction" in timed


def test_backward_span_closes_after_every_bucket_is_posted(monkeypatch):
    """Every bucket's launch falls inside a ``trainer.backward`` span: the
    trainer waits for the shim's posting worker before the span closes,
    as the JAX trainer's span closes after its ordered taps have staged
    and launched every bucket. (Before, the span closed when torch's
    backward returned, and the last buckets went on the wire after it.)"""
    launched = []
    real = torch_shim._LayeredSync._launch

    def launch(self, b):
        real(self, b)
        launched.append(time.monotonic())   # the tracer's clock

    monkeypatch.setattr(torch_shim._LayeredSync, "_launch", launch)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 255, (2, 17)) for _ in range(2)]
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(w, mean=True, per_layer=True,
                                 wire_dtype="int8") for w in worlds]
    trainers = [Trainer("llama-tiny", device="cpu", seed=3,
                        cross_slice_sync=s) for s in shims]
    t0 = time.monotonic()
    try:
        run_ranks(worlds, lambda w, r: [trainers[r].step(
            torch.from_numpy(batches[r])) for _ in range(2)])
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    spans = [(ts - fields["dur_s"], ts)
             for ts, _name, fields in trace.events("trainer.backward")
             if ts > t0]
    assert len(spans) == 4
    assert len(launched) == 2 * 2 * len(trainers[0].layer_plan)
    for ts in launched:
        assert any(a <= ts <= b for a, b in spans), (ts, spans)


def test_wait_posted_raises_for_a_bucket_never_pushed(monkeypatch):
    """A bucket whose hook never fired makes ``wait_posted`` raise the
    "never delivered" error once its wait runs out, so the trainer's
    backward fails after one wait, not after a second one in
    ``finish()``."""
    monkeypatch.setattr(torch_shim, "_POST_WAIT_S", 0.2)
    plan = [("a", [(4, "float32")]), ("b", [(4, "float32")])]
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(w, mean=True, per_layer=True)
             for w in worlds]
    errors = [None, None]

    def rank(w, r):
        pending = shims[r].start_layered(plan)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="never delivered") as e:
            pending.wait_posted()
        errors[r] = (str(e.value), time.monotonic() - t0)

    try:
        run_ranks(worlds, rank)
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    for msg, waited in errors:
        assert "buckets [0, 1]" in msg and waited < 5, (msg, waited)


# ---------------------------------------------------- the CLIs (slow)

@pytest.mark.slow
@pytest.mark.parametrize("argv,env", [
    (["--cpu"], {}),
    ([], {"TDR_OVERLAP_SMOKE_LITE": "1"}),
])
def test_overlap_smoke_cli_holds_every_gate(argv, env):
    """``make overlap-smoke``'s counterpart: the CLI on the CPU with the
    reference's gates, the timing gates included."""
    proc = subprocess.run([sys.executable, TOOL] + argv, cwd=REPO,
                          capture_output=True, text=True, timeout=900,
                          env={**os.environ, **env})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "overlap-smoke OK" in proc.stdout
    assert "timing_gates=bound" in proc.stdout
