"""The port's elastic-fleet soak (``tools/torch_fleet_soak.py``) against
the reference's (``tools/fleet_soak.py``), as ``tests/test_fleet_soak.py``
holds the reference.

Tier-1 pins the soak's own tooling, so that a broken harness cannot
pass the gate silently:

- ``metric_sum`` / ``metric_world`` return what the reference's return,
  on the reference's exposition cases and on a real ``/metrics`` scrape
  of the port's coordinator;
- the coordinator child (``python -m rocnrdma_tpu_torch.tools.rendezvous``)
  comes up healthy, dies to SIGKILL and comes back healthy under
  ``--restore`` on the same port; the reference's child is run the same
  way beside it, and both children's seconds to a healthy ``/healthz``
  are recorded;
- the functions keep the reference's names and parameters, and the
  verdict keeps its keys and its ``ok`` conjunction, read from both
  sources.

Slow: the whole soak at 6 rounds with the reference's asserts, and both
packages' lite soaks in turns, each in its own process, with their
seconds and their coordinator children's seconds to health. Ports come
from ``tests/test_hier.py``'s ``port_band``.
"""

import ast
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from rocnrdma_tpu_torch.control import ControlClient, Coordinator

from test_hier import port_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import fleet_soak as ref  # noqa: E402
import torch_fleet_soak as soak  # noqa: E402

# ``tests/test_fleet_soak.py``'s exposition: label blocks to sum, exact
# worlds to pick ("a" must not swallow "ab"), junk to skip.
_EXPOSITION = "\n".join([
    "# comment",
    'tdr_ctl_resizes_total{world="a"} 2',
    'tdr_ctl_resizes_total{world="ab"} 3',
    "tdr_ctl_failovers_total 1",
    "garbage line",
    'tdr_ctl_qp_share{world="a"} nope',
])


def _scrape(snapshot_dir):
    """The text of a real ``/metrics`` scrape of the port's coordinator
    after the soak's kinds of calls: snapshots on, a fair-share pool,
    two worlds (one resizable with weight 2), a heartbeat, a refused
    join."""
    c = Coordinator(port=0, lease_ms=5000, port_base=port_band(64),
                    snapshot_dir=snapshot_dir, qp_budget=130,
                    qp_fair=True, qp_floor=2).start()
    try:
        client = ControlClient(c.address)
        views = {}
        for name, kw in (("fleet-00", {}),
                         ("elastic-grow", {"resizable": True,
                                           "max_size": 3,
                                           "weight": 2.0})):
            out = [None, None]
            ts = [threading.Thread(target=lambda r=r, n=name, k=kw:
                                   out.__setitem__(r, client.join(
                                       n, 2, rank=r, **k)))
                  for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            views[name] = out
        v = views["fleet-00"][0]
        client.heartbeat("fleet-00", 0, v["incarnation"], v["generation"],
                         counters={"integrity.sealed": 9})
        refused = client.join("fleet-00", 2, rank=-1, timeout_s=3.0)
        assert not refused["ok"] and refused["retryable"]
        return client.metrics()
    finally:
        c.stop()


_SCRAPE_QUERIES = [
    ("sum", "tdr_ctl_resizes_total{"), ("sum", "tdr_ctl_failovers_total "),
    ("sum", "tdr_ctl_worlds "), ("sum", "tdr_ctl_qp_share{"),
    ("world", "tdr_ctl_qp_share", "elastic-grow"),
    ("world", "tdr_ctl_qp_share", "fleet-00"),
    ("world", "tdr_ctl_members", "elastic-grow"),
    ("world", "tdr_ctl_rebuilds_total", "fleet-00"),
    ("world", "tdr_ctl_admission_rejects_total", "fleet-00"),
    ("world", "tdr_ctl_generation", "no-such-world"),
]


def _ask(mod, text, q):
    if q[0] == "sum":
        return mod.metric_sum(text, q[1])
    return mod.metric_world(text, q[1], q[2])


def test_metric_helpers_parse_exposition_as_the_reference():
    assert soak.metric_sum(_EXPOSITION, "tdr_ctl_resizes_total{") == 5.0
    assert soak.metric_sum(_EXPOSITION, "tdr_ctl_failovers_total") == 1.0
    assert soak.metric_world(_EXPOSITION, "tdr_ctl_resizes_total",
                             "a") == 2.0
    assert soak.metric_world(_EXPOSITION, "tdr_ctl_resizes_total",
                             "ab") == 3.0
    assert soak.metric_world(_EXPOSITION, "tdr_ctl_qp_share", "a") == 0.0
    for q in [("sum", "tdr_ctl_resizes_total{"),
              ("sum", "tdr_ctl_failovers_total"), ("sum", "garbage"),
              ("world", "tdr_ctl_resizes_total", "a"),
              ("world", "tdr_ctl_resizes_total", "ab"),
              ("world", "tdr_ctl_qp_share", "a")]:
        assert _ask(soak, _EXPOSITION, q) == _ask(ref, _EXPOSITION, q), q


def test_metric_helpers_read_a_port_scrape_as_the_reference(tmp_path):
    text = _scrape(str(tmp_path))
    for name in soak.PINNED:
        assert name in text, name
    got = {q: _ask(soak, text, q) for q in _SCRAPE_QUERIES}
    assert got == {q: _ask(ref, text, q) for q in _SCRAPE_QUERIES}
    # The gate's reading of this scrape: the weight-2 world's share
    # beats the weight-1 world's, inside the pool.
    share_grow = got[("world", "tdr_ctl_qp_share", "elastic-grow")]
    share_flat = got[("world", "tdr_ctl_qp_share", "fleet-00")]
    assert 0 < share_flat < 130 and share_grow > share_flat
    assert got[("world", "tdr_ctl_admission_rejects_total",
                "fleet-00")] == 1.0
    assert got[("sum", "tdr_ctl_worlds ")] == 2.0
    assert got[("world", "tdr_ctl_generation", "no-such-world")] == 0.0


@pytest.mark.parametrize("mod", [soak, ref], ids=["torch", "jax"])
def test_subprocess_coordinator_health_and_kill(mod, tmp_path,
                                                record_property):
    """The soak's coordinator child comes up healthy, dies to SIGKILL
    (the mid-soak failover injection), and a ``--restore`` respawn on
    the same port comes back healthy from the snapshot dir. Each
    child's seconds from spawn to health are recorded."""
    port = port_band(1)
    times = []
    t0 = time.monotonic()
    proc = mod.spawn_coordinator(port, port_band(64), str(tmp_path),
                                 lease_ms=2000, qp_budget=64)
    try:
        assert mod.wait_health(port, timeout_s=30)
        times.append(round(time.monotonic() - t0, 3))
        # Its first periodic snapshot (every 0.25 s) is what the
        # respawn restores.
        snap = tmp_path / Coordinator.SNAPSHOT_FILE
        deadline = time.monotonic() + 10
        while not snap.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert snap.exists()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        assert proc.returncode == -signal.SIGKILL
        t0 = time.monotonic()
        proc = mod.spawn_coordinator(port, port_band(64), str(tmp_path),
                                     lease_ms=2000, qp_budget=64,
                                     restore=True)
        assert mod.wait_health(port, timeout_s=30)
        times.append(round(time.monotonic() - t0, 3))
        # The restored child is the same fleet: it counts the failover.
        body = ControlClient(f"127.0.0.1:{port}").metrics()
        assert mod.metric_sum(body, "tdr_ctl_failovers_total ") == 1.0
    finally:
        proc.kill()
        proc.wait(timeout=10)
    record_property("healthy_s", times)
    print(f"{mod.__name__} coordinator child healthy after "
          f"{times[0]} s, restored after {times[1]} s")


def _signature(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", [
    "_free_port", "spawn_coordinator", "wait_health", "metric_sum",
    "metric_world", "_boot_world", "_checked_allreduce", "run_fleet",
    "main"])
def test_functions_keep_the_reference_names_and_parameters(name):
    got, want = _signature(getattr(soak, name)), _signature(getattr(ref,
                                                                     name))
    if name == "run_fleet":
        # The port's soak also hands back the coordinator child's times.
        assert got[-1] == ("runs", None)
        got = got[:-1]
    assert got == want


def _verdict_keys(mod):
    """The verdict's keys in the order the source sets them: the
    ``verdict = {...}`` literal, each ``verdict[...] =`` and each
    ``verdict.update({...})``."""
    keys = []
    fn = ast.parse(inspect.getsource(mod.run_fleet))
    for node in sorted((n for n in ast.walk(fn) if hasattr(n, "lineno")),
                       key=lambda n: (n.lineno, n.col_offset)):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "verdict":
                keys += [k.value for k in node.value.keys]
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.value, ast.Name)
                  and t.value.id == "verdict"):
                keys.append(t.slice.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "verdict"):
            keys += [k.value for k in node.args[0].keys]
    return keys


def _ok_conjunction(mod):
    fn = ast.parse(inspect.getsource(mod.run_fleet))
    return next(ast.dump(node.value) for node in ast.walk(fn)
                if isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and node.targets[0].slice.value == "ok")


def test_verdict_keys_and_ok_equal_the_reference():
    keys = _verdict_keys(soak)
    assert keys == _verdict_keys(ref)
    assert len(keys) == len(set(keys)) and keys[-1] == "ok"
    for k in ("parity", "resizes_served_on_metrics", "fair_share",
              "admission", "hb_threads_leaked", "pinned_names_scraped"):
        assert k in keys
    assert _ok_conjunction(soak) == _ok_conjunction(ref)
    assert soak.PINNED == ref.PINNED


def test_lite_switch_and_rounds_as_the_reference(monkeypatch):
    seen = []
    monkeypatch.setattr(soak, "run_fleet",
                        lambda rounds, runs: seen.append(rounds) or
                        {"ok": False})
    for lite, rounds in ((True, 6), (False, 8)):
        monkeypatch.setattr(soak, "LITE", lite)
        assert soak.main() == 1
        assert seen[-1] == rounds


# ------------------------------------------------------------ slow

# The soak in its own process with its coordinator children timed from
# the outside, the same way for either package: each spawn's seconds to
# a healthy /healthz, and where in the drive each came.
_TIMED = """
import json, sys, time
import {mod} as m
t0 = time.monotonic()
spawned, healthy = [], []
real_spawn, real_wait = m.spawn_coordinator, m.wait_health
def spawn(*a, **kw):
    spawned.append(time.monotonic())
    return real_spawn(*a, **kw)
def wait(port, timeout_s=20.0):
    ok = real_wait(port, timeout_s)
    healthy.append({{"at_s": round(spawned[-1] - t0, 3),
                     "healthy_s": round(time.monotonic() - spawned[-1], 3),
                     "ok": ok}})
    return ok
m.spawn_coordinator, m.wait_health = spawn, wait
v = m.run_fleet(rounds=6)
v.pop("collectives_completed")
print("TIMED " + json.dumps({{"seconds": round(time.monotonic() - t0, 3),
                             "children": healthy, "ok": v["ok"],
                             "verdict": v}}, default=str))
"""


def _timed_lite_soak(mod):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TDR_NATIVE_LIB", "TDR_RING_TIMEOUT_MS")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, TOOLS,
                                         env.get("PYTHONPATH", "")])
    env["TDR_FLEET_SOAK_LITE"] = "1"
    proc = subprocess.run([sys.executable, "-c", _TIMED.format(mod=mod)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("TIMED "))
    return json.loads(line[len("TIMED "):])


@pytest.mark.slow
def test_fleet_soak_verdict_ok(tmp_path):
    """The full autoscaling soak, verdict-gated: every acceptance bit
    must hold in one run (``tests/test_fleet_soak.py``'s asserts)."""
    runs = {}
    verdict = soak.run_fleet(rounds=6, lease_ms=2500,
                             snapshot_dir=str(tmp_path), runs=runs)
    print("FLEET_RUN " + json.dumps(runs))
    print(json.dumps(verdict, indent=1, default=str))
    assert verdict["ok"], verdict
    assert verdict["errors"] == {}
    assert verdict["parity"] is True
    assert verdict["resizes_served_on_metrics"] >= 2
    assert verdict["failovers_served_on_metrics"] >= 1
    assert verdict["generations_monotone"] is True
    assert verdict["fair_share"]["ok"] is True
    assert verdict["hb_threads_leaked"] == 0
    assert verdict["worlds_served"] >= 12
    assert verdict["pinned_names_scraped"] is True
    assert runs["restored_healthy_s"] < 20.0


@pytest.mark.slow
def test_lite_soak_in_turns_with_the_reference():
    """Both packages' lite soaks, the reference's first, each in its own
    process with the ring deadline at the tools' 30 s default: every
    gate holds in both, and the one ``FLEET_COMPARE`` line carries each
    drive's seconds and each coordinator child's seconds to health."""
    out = {"jax": _timed_lite_soak("fleet_soak"),
           "torch": _timed_lite_soak("torch_fleet_soak")}
    print("FLEET_COMPARE " + json.dumps(out))
    for side, res in out.items():
        assert res["ok"], (side, res)
        assert [c["ok"] for c in res["children"]] == [True, True], side
