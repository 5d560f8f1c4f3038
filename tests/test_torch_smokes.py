"""The port's numpy-only smokes against the reference's:
``tools/torch_hier_smoke.py``, ``tools/torch_perf_smoke.py`` and
``tools/torch_telemetry_smoke.py`` beside ``tools/hier_smoke.py``,
``tools/perf_smoke.py`` and ``tools/telemetry_smoke.py``.

Tier-1 calls each port tool's drive function (not its CLI) with the
reference's quick setting, in a ``python -c`` subprocess, because each
tool sets variables (``TDR_TOPOLOGY``, ``TDR_FAULT_PLAN``,
``TDR_PROGRESS_SHARDS``, ``TDR_FOLD_THREADS``, ...) that must precede
the port's library load, and another test in the same worker may
already have loaded it. It holds every gate that is not a timing gate,
and checks that the record's keys equal the reference tool's. For hier
and telemetry the fields that do not depend on timing also equal the
reference's on the same host: the seal payload flag of each tier, the
bitwise parities, the lifecycle's event names and the Perfetto event
schema. Ring ports come from ``tests/test_hier.py``'s ``port_band``.

The timing gates (hier's ``hier >= flat``, perf's fold occupancy
> 0.5) stay out of tier-1: each tool's CLI, with all its gates, runs as
a ``slow`` test, the port's counterpart of ``make <name>-smoke``.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from test_hier import port_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _run(script, timeout=300, **env):
    full = dict(os.environ)
    full.pop("TDR_NATIVE_LIB", None)
    full["PYTHONPATH"] = os.pathsep.join(
        [REPO, TOOLS, full.get("PYTHONPATH", "")])
    full.update(env)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=full)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def _line(stdout, prefix):
    line = next(ln for ln in stdout.splitlines() if ln.startswith(prefix))
    return json.loads(line[len(prefix):])


# ---------------------------------------------------------------- hier

_HIER_PORT = """
import json
import torch_hier_smoke as m
print("HIER " + json.dumps(m.hier_smoke(base_port={base})))
"""

# Timing fields: measured, so they differ between any two runs.
_HIER_TIMED = {"flat_GBps", "hier_GBps", "hier_vs_flat",
               "hier_beats_flat", "ok"}


@pytest.fixture(scope="module")
def hier_records():
    port = _line(_run(_HIER_PORT.format(base=port_band(40)),
                      TDR_HIER_QUICK="1"), "HIER ")
    # The reference's smoke exits 1 where its timing gate fails; its
    # record line is read either way.
    ref = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "hier_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "TDR_HIER_QUICK": "1", "JAX_PLATFORMS": "cpu"})
    return port, _line(ref.stdout, "HIER ")


def test_hier_drive_holds_every_untimed_gate(hier_records):
    rec, _ = hier_records
    assert rec["quick"] is True and rec["world"] == 8
    assert rec["parity_flat_correct"]
    assert rec["parity_hier_bitwise"] and rec["parity_hier_async_bitwise"]
    assert rec["pending_async"] == 0
    assert rec["intra_seal_payload"] is False
    assert rec["inter_seal_payload"] is True
    assert rec["fault_hits"] > 0
    assert rec["integrity_failed"] > 0 and rec["retransmits"] > 0
    assert rec["large_message_bytes"] == 1 << 20


def test_hier_record_matches_the_reference(hier_records):
    rec, ref = hier_records
    assert list(rec) == list(ref)
    untimed = [k for k in ref if k not in _HIER_TIMED
               and k not in ("fault_hits", "integrity_failed",
                             "retransmits")]
    assert {k: rec[k] for k in untimed} == {k: ref[k] for k in untimed}


# ---------------------------------------------------------------- perf

_PERF_PORT = """
import json
import torch_perf_smoke as m
print("PERF " + json.dumps(m.perf_smoke(port={port})))
"""


def _perf_reference_keys():
    """The keys the reference's ``perf-smoke OK`` line prints, read off
    its source."""
    with open(os.path.join(TOOLS, "perf_smoke.py")) as f:
        src = f.read()
    ok = src[src.index('print(f"perf-smoke OK:'):]
    ok = ok[:ok.index("\n    return 0")]
    return re.findall(r"(\w+)=", ok)


def test_perf_drive_holds_every_untimed_gate():
    rec = _line(_run(_PERF_PORT.format(port=port_band(8))), "PERF ")
    # perf_smoke asserts the bitwise result, the generic schedule over 4
    # channels, the lanes and the counters itself; the occupancy is the
    # CLI's timing gate.
    assert rec["channels"] == 4
    assert rec["shards"] > 0 and rec["shard_wc"] > 0
    assert rec["fold_workers"] > 0 and rec["fold_jobs"] > 0
    assert rec["qp_lanes"] >= 4 and rec["shard_lanes"] > 0
    keys = _perf_reference_keys()
    assert keys == ["channels", "shards", "shard_wc", "fold_workers",
                    "fold_jobs", "occupancy", "qp_lanes", "shard_lanes"]
    assert set(keys) <= set(rec)


# ----------------------------------------------------------- telemetry

_TEL_PORT = """
import json
import torch_telemetry_smoke as m
events, doc, sealed = m.recorded_run({port0})
names = sorted({{e.name for e in events if e.source == "native"}})
schema = {{}}
for ev in doc["traceEvents"]:
    schema.setdefault(ev["ph"], set()).update(ev)
schema = {{ph: sorted(keys) for ph, keys in schema.items()}}
m.check_lifecycle(events, doc, sealed)
print("LIFECYCLE " + json.dumps({{"names": names, "schema": schema,
                                  "sealed": sealed}}))
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.transport.engine import (telemetry_dropped,
                                                 telemetry_recorded)
telemetry.disable()
m.drive_world2({port1})
print("OFF " + json.dumps([telemetry_recorded(), telemetry_dropped()]))
"""

_TEL_REF = """
import json
import telemetry_smoke as ref
ref.free_port = lambda: {port0}
from rocnrdma_tpu import telemetry
telemetry.enable()
labels = ref.drive_world2()
events = telemetry.timeline()
doc = telemetry.export_trace(None, events=events, engine_labels=labels)
names = sorted({{e.name for e in events if e.source == "native"}})
schema = {{}}
for ev in doc["traceEvents"]:
    schema.setdefault(ev["ph"], set()).update(ev)
schema = {{ph: sorted(keys) for ph, keys in schema.items()}}
print("LIFECYCLE " + json.dumps({{"names": names, "schema": schema}}))
"""


def test_telemetry_drive_matches_the_reference():
    base = port_band(24)
    out = _run(_TEL_PORT.format(port0=base, port1=base + 8))
    port = _line(out, "LIFECYCLE ")
    assert port["sealed"] is True
    assert _line(out, "OFF ") == [0, 0]
    ref = _line(_run(_TEL_REF.format(port0=base + 16), JAX_PLATFORMS="cpu"),
                "LIFECYCLE ")
    assert port["names"] == ref["names"]
    assert port["schema"] == ref["schema"]
    for name in ("land", "verify_ok", "wire_tx", "wire_rx", "wc"):
        assert name in port["names"]


def test_telemetry_verdict_keys_are_the_references():
    with open(os.path.join(TOOLS, "telemetry_smoke.py")) as f:
        tree = ast.parse(f.read())
    ref_keys = [node.slice.value for node in ast.walk(tree)
                if isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "verdict"
                and isinstance(node.ctx, ast.Store)]
    base = port_band(16)
    out = _run("import json, torch_telemetry_smoke as m\n"
               f"print('TEL ' + json.dumps(m.telemetry_smoke(({base}, "
               f"{base + 8}))))")
    verdict = _line(out, "TEL ")
    assert list(verdict) == ref_keys
    assert verdict["events_while_disabled"] == 0
    assert verdict["dropped_while_disabled"] == 0
    assert verdict["trace_events"] > 0 and verdict["tracks"] > 0


# ---------------------------------------------------- the CLIs (slow)

@pytest.mark.slow
@pytest.mark.parametrize("tool,env,marker", [
    ("torch_hier_smoke.py", {}, '"ok": true'),
    ("torch_perf_smoke.py", {}, "perf-smoke OK"),
    ("torch_telemetry_smoke.py", {}, '"ok": true'),
])
def test_smoke_cli_holds_every_gate(tool, env, marker):
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, tool)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600, env={**os.environ, **env})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert marker in proc.stdout, proc.stdout[-2000:]
