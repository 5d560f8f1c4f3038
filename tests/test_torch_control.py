"""The port's control plane (``rocnrdma_tpu_torch/control/``) and the
coordinator path of its ``RingWorld``: the core cases of
``tests/test_control.py`` against the port's coordinator, plus its
interop with the JAX package's.

- coordinator: join gives one view; worlds get disjoint port ranges; a
  failure report bumps the generation once per incident; a lease that
  expires declares the member dead; heartbeats renew leases; the
  ``/metrics`` contract names; snapshot → restore is state-equal; a
  standby promotes itself when the primary dies; a world shrinks and
  grows back with generation and epoch moving forward;
- the port's ``RingWorld(controller=...)``: an arbitrated rebuild takes
  the coordinator's generation on both ranks; ``rank=-1`` adopts the
  coordinator's slot; ``base_port`` is optional with a controller;
- interop: a JAX ``RingWorld`` and a torch ``RingWorld`` (each on its
  own library) in one world of 2, arbitrated by the port's coordinator
  and by the JAX package's: allreduce bitwise ``a + b``, concurrent
  ``rebuild()``, generation 1 on both; both coordinators serve the same
  ``/metrics`` text after the same calls (clock readings masked);
- ``telemetry.collect_and_merge`` pulls a segment per rank process,
  each with ``ring_begin`` events, and merges them;
- ``examples/two_slice_dp_torch.py --controller --elastic-dir`` trains
  under the coordinator, and a second run on the same directory
  restores every rank's checkpoint and trains on from it; the
  example's first rendezvous retries until a late survivor parks.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.world import RingWorld as JaxWorld
from rocnrdma_tpu.control.client import ControlClient as JaxClient
from rocnrdma_tpu.control.coordinator import Coordinator as JaxCoordinator
from rocnrdma_tpu.transport.engine import Engine as JaxEngine
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import RingWorld, local_worlds
from rocnrdma_tpu_torch.control import ControlClient, Coordinator
from rocnrdma_tpu_torch.control.coordinator import Standby
from rocnrdma_tpu_torch.telemetry.recorder import events_from_wire
from rocnrdma_tpu_torch.transport.engine import (Engine, TransportError,
                                                 native_counters)
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import port_band
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PINNED_NAMES = (
    "tdr_ctl_worlds",
    'tdr_ctl_generation{world="w"}',
    'tdr_ctl_members{world="w"}',
    'tdr_ctl_rebuilds_total{world="w"}',
    'tdr_ctl_lease_expiries_total{world="w"}',
    'tdr_retransmit_rate{world="w"}',
    'tdr_integrity_sealed_total{world="w"}',
    'tdr_integrity_retransmitted_total{world="w"}',
)


def _coordinator(**kw):
    kw.setdefault("lease_ms", 1500)
    return Coordinator(port=0, port_base=port_band(64), **kw).start()


@pytest.fixture()
def coord():
    c = _coordinator()
    yield c
    c.stop()


def _join_all(client, world, size, **kw):
    out = [None] * size
    run_ranks([None] * size, lambda _w, r: out.__setitem__(
        r, client.join(world, size, rank=r, **kw)))
    return out


def _metric(body: str, series: str) -> float:
    for ln in body.splitlines():
        if ln.split(" ")[0] == series:
            return float(ln.split()[-1])
    raise AssertionError(f"{series} not served:\n{body}")


# ------------------------------------------------------- coordinator


def test_join_assigns_ranks_and_one_view(coord):
    views = _join_all(ControlClient(coord.address), "w", 3)
    assert all(v["ok"] for v in views)
    assert [v["rank"] for v in views] == [0, 1, 2]
    for key in ("generation", "epoch", "base_port"):
        assert len({v[key] for v in views}) == 1, key
    assert len({v["incarnation"] for v in views}) == 3


def test_worlds_get_disjoint_port_ranges(coord):
    client = ControlClient(coord.address)
    va = _join_all(client, "a", 2)
    vb = _join_all(client, "b", 2)
    assert abs(va[0]["base_port"] - vb[0]["base_port"]) >= 2


def test_report_bumps_generation_once_per_incident(coord):
    client = ControlClient(coord.address)
    views = _join_all(client, "w", 2)
    gen = views[0]["generation"]
    r0 = client.report("w", 0, views[0]["incarnation"], gen, "boom")
    r1 = client.report("w", 1, views[1]["incarnation"], gen, "boom")
    assert r0["generation"] == r1["generation"] == gen + 1
    assert r1["rebuilds"] == 0


def test_lease_expiry_declares_dead_and_bumps():
    coord = _coordinator(lease_ms=300)
    try:
        client = ControlClient(coord.address)
        views = _join_all(client, "w", 2)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if 'tdr_ctl_members{world="w"} 0' in client.metrics():
                break
            time.sleep(0.1)
        body = client.metrics()
        assert _metric(body, 'tdr_ctl_members{world="w"}') == 0
        assert _metric(body, 'tdr_ctl_lease_expiries_total{world="w"}') >= 2
        assert _metric(body, 'tdr_ctl_generation{world="w"}') > \
            views[0]["generation"]
        resp = client.sync("w", 0, views[0]["incarnation"], timeout_s=2)
        assert not resp["ok"] and resp["error"] == "superseded"
    finally:
        coord.stop()


def test_heartbeat_renews_lease():
    coord = _coordinator(lease_ms=400)
    try:
        client = ControlClient(coord.address)
        views = _join_all(client, "w", 2)
        for _ in range(6):
            for v in views:
                r = client.heartbeat("w", v["rank"], v["incarnation"],
                                     v["generation"])
                assert r["ok"] and not r["stale"]
            time.sleep(0.15)
        assert _metric(client.metrics(), 'tdr_ctl_members{world="w"}') == 2
    finally:
        coord.stop()


def test_metrics_contract_names_and_monotonicity(coord):
    client = ControlClient(coord.address)
    views = _join_all(client, "w", 2)
    client.heartbeat("w", 0, views[0]["incarnation"],
                     views[0]["generation"], counters=native_counters(),
                     hists={"chunk_lat_us": {4: 7, 9: 2}})
    body = client.metrics()
    for name in PINNED_NAMES:
        assert name in body, f"contract name {name} missing:\n{body}"
    assert 'tdr_chunk_lat_us{world="w",quantile="0.99"}' in body
    gen0 = _metric(body, 'tdr_ctl_generation{world="w"}')
    rb0 = _metric(body, 'tdr_ctl_rebuilds_total{world="w"}')
    client.report("w", 0, views[0]["incarnation"],
                  views[0]["generation"], "forced")
    out = [None, None]
    run_ranks([None] * 2, lambda _w, r: out.__setitem__(
        r, client.sync("w", r, views[r]["incarnation"], timeout_s=10)))
    assert all(v["ok"] for v in out)
    body2 = client.metrics()
    assert _metric(body2, 'tdr_ctl_generation{world="w"}') > gen0
    assert _metric(body2, 'tdr_ctl_rebuilds_total{world="w"}') == rb0 + 1


def test_snapshot_restore_roundtrip_equality(tmp_path):
    snapdir = str(tmp_path)
    c1 = _coordinator(snapshot_dir=snapdir)
    client = ControlClient(c1.address)
    views = _join_all(client, "w", 2, resizable=True)
    client.report("w", 0, views[0]["incarnation"],
                  views[0]["generation"], "boom")
    c1.stop()  # writes the final snapshot
    with open(os.path.join(snapdir, Coordinator.SNAPSHOT_FILE)) as f:
        snap = json.load(f)
    assert snap["format"] == "tdr-ctl-snapshot-v1"
    c2 = Coordinator(port=0, restore=True, snapshot_dir=snapdir).start()
    try:
        assert c2.address == c1.address
        with open(c2.snapshot_now()) as f:
            snap2 = json.load(f)
        assert snap2["failovers"] == snap["failovers"] + 1
        volatile = ("wall_time", "failovers")
        assert {k: v for k, v in snap.items() if k not in volatile} == \
            {k: v for k, v in snap2.items() if k not in volatile}
        for v in views:
            assert ControlClient(c2.address).heartbeat(
                "w", v["rank"], v["incarnation"], v["generation"])["ok"]
    finally:
        c2.stop()


def test_standby_promotes_on_primary_death(tmp_path):
    snapdir = str(tmp_path)
    c1 = _coordinator(snapshot_dir=snapdir, snapshot_interval_s=0.1)
    client = ControlClient(c1.address)
    views = _join_all(client, "w", 2, resizable=True)
    c1.snapshot_now()
    sb = Standby(snapdir, address=c1.address, probe_interval_s=0.1,
                 fail_threshold=2).start()
    try:
        time.sleep(0.5)
        assert not sb.promoted.is_set()
        c1.stop()
        assert sb.promoted.wait(10)
        assert sb.coordinator.address == c1.address
        assert client.heartbeat("w", 0, views[0]["incarnation"],
                                views[0]["generation"])["ok"]
        assert _metric(client.metrics(), "tdr_ctl_failovers_total") >= 1
    finally:
        sb.stop()


def test_shrink_then_grow_generation_monotone():
    c = _coordinator()
    try:
        client = ControlClient(c.address)
        views = _join_all(client, "w", 3, resizable=True)
        client.leave("w", 2, views[2]["incarnation"])
        out = [None, None]

        def sync(r, inc):
            out[r] = client.sync("w", r, inc, timeout_s=10)

        run_ranks([None] * 2, lambda _w, r: sync(r, views[r]["incarnation"]))
        assert all(v["ok"] for v in out)
        assert out[0]["world_size"] == 2 and out[0]["resizes"] == 1
        assert sorted(v["rank"] for v in out) == [0, 1]
        gen1 = out[0]["generation"]
        assert gen1 > views[0]["generation"]

        joined = [None]
        jt = threading.Thread(target=lambda: joined.__setitem__(
            0, client.join("w", 2, rank=-1, resizable=True, timeout_s=15)))
        jt.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with c._cv:
                if len(c._worlds["w"].members) == 3:
                    break
            time.sleep(0.02)
        incs = [v["incarnation"] for v in out]
        run_ranks([None] * 2, lambda _w, r: sync(r, incs[r]))
        jt.join()
        assert joined[0]["ok"] and joined[0]["rank"] == 2
        assert joined[0]["world_size"] == 3
        assert all(v["ok"] and v["world_size"] == 3 for v in out)
        assert out[0]["resizes"] == 2
        assert out[0]["generation"] > gen1
        assert out[0]["epoch"] > views[0]["epoch"]
    finally:
        c.stop()


# ------------------------------------------------ arbitrated RingWorld


def _allreduce_world2(worlds, a, b):
    run_ranks(worlds, lambda w, r: w.allreduce(a if r == 0 else b))


def test_arbitrated_world_rebuild_coordinator_owns_generation(coord):
    worlds = local_worlds(2, controller=coord.address, world_name="ring",
                          channels=1, timeout_ms=15000)
    try:
        w0, w1 = worlds
        assert w0.generation == w1.generation == 0
        assert w0._ctl_epoch == w1._ctl_epoch == 1
        assert w0.control_stamp == "ctl=ring:g0:e1"
        bufs = [torch.arange(16, dtype=torch.float32) * (r + 1)
                for r in range(2)]
        _allreduce_world2(worlds, *bufs)
        assert torch.equal(bufs[0], torch.arange(16.0) * 3)
        report0 = trace.counter("ctl.report")
        rebuild0 = trace.counter("ctl.rebuild")
        run_ranks(worlds, lambda w, r: w.rebuild(
            max_attempts=6, backoff_s=0.05, timeout_ms=10000))
        assert w0.generation == w1.generation == 1
        assert w0._ctl_epoch == w1._ctl_epoch == 2
        assert trace.counter("ctl.report") - report0 >= 1
        assert trace.counter("ctl.rebuild") - rebuild0 == 2
        bufs[0][:] = 1.0
        bufs[1][:] = 2.0
        _allreduce_world2(worlds, *bufs)
        assert torch.equal(bufs[0], torch.full((16,), 3.0))
        body = ControlClient(coord.address).metrics()
        assert _metric(body, 'tdr_ctl_generation{world="ring"}') == 1
        assert _metric(body, 'tdr_ctl_rebuilds_total{world="ring"}') == 1
    finally:
        for w in worlds:
            w.close()
    # close() leaves: the coordinator holds no member of the world.
    body = ControlClient(coord.address).metrics()
    assert _metric(body, 'tdr_ctl_members{world="ring"}') == 0


def test_rank_auto_assignment_adopted_by_ringworld(coord):
    worlds = [None, None]

    def boot(_w, i):
        worlds[i] = RingWorld(Engine("emu"), -1, 2,
                              controller=ControlClient(coord.address),
                              world_name="auto", channels=1,
                              timeout_ms=15000)

    run_ranks([None] * 2, boot)
    try:
        assert sorted(w.rank for w in worlds) == [0, 1]
        bufs = [torch.full((16,), 5, dtype=torch.int32) for _ in range(2)]
        _allreduce_world2(worlds, *bufs)
        assert torch.equal(bufs[0], torch.full((16,), 10, dtype=torch.int32))
    finally:
        for w in worlds:
            w.close()


def _example():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "two_slice_dp_torch",
        os.path.join(REPO, "examples", "two_slice_dp_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_first_rendezvous_outwaits_a_late_survivor(coord,
                                                           monkeypatch):
    """The example's ``join_world``: a rank that joins at once keeps
    re-joining, each rendezvous shorter than the survivor's delay,
    until the survivor parks; a fatal error is not retried."""
    ex = _example()
    monkeypatch.setattr(ex, "REBUILD", dict(
        max_attempts=20, backoff_s=0.05, backoff_cap_s=0.1,
        timeout_ms=1000))
    worlds = [None, None]

    def boot(_w, r):
        if r == 0:
            time.sleep(3.0)  # the survivor still inside its failed step
            worlds[0] = RingWorld(Engine("emu"), 0, 2,
                                  controller=coord.address,
                                  world_name="two-slice-dp", channels=1,
                                  timeout_ms=15000)
        else:
            worlds[1], attempts[0] = ex.join_world(
                lambda *a, **kw: RingWorld(*a, channels=1, **kw),
                Engine("emu"), 1, 2, None, coord.address)

    attempts = [0]
    run_ranks([None] * 2, boot)
    try:
        assert attempts[0] > 1
        bufs = [torch.full((16,), r + 1, dtype=torch.int32)
                for r in range(2)]
        _allreduce_world2(worlds, *bufs)
        assert all(torch.equal(b, torch.full((16,), 3, dtype=torch.int32))
                   for b in bufs)
    finally:
        for w in worlds:
            w.close()
    calls = []

    def fatal(*_a, **_kw):
        calls.append(1)
        raise TransportError("schedule mismatch", retryable=False)

    with pytest.raises(TransportError, match="schedule mismatch"):
        ex.join_world(fatal, None, 0, 2, None, coord.address)
    assert len(calls) == 1


def test_base_port_is_required_only_without_a_controller():
    with pytest.raises(ValueError, match="without a controller"):
        RingWorld(None, 0, 2)


# ----------------------------------------------------------- interop


@pytest.mark.parametrize("side", ["torch", "jax"])
def test_mixed_world_under_either_coordinator(side):
    """Rank 0 is the JAX package's RingWorld on its library, rank 1 the
    port's on its own; the coordinator is the port's or the JAX
    package's. Allreduce bitwise, concurrent rebuild, generation 1."""
    cls = Coordinator if side == "torch" else JaxCoordinator
    c = cls(port=0, lease_ms=3000, port_base=port_band(64)).start()
    worlds = [None, None]
    try:
        def boot(_w, r):
            if r == 0:
                worlds[0] = JaxWorld(JaxEngine("emu"), 0, 2,
                                     controller=c.address,
                                     world_name="mixed", timeout_ms=15000)
            else:
                worlds[1] = RingWorld(Engine("emu"), 1, 2,
                                      controller=c.address,
                                      world_name="mixed", timeout_ms=15000)

        run_ranks([None] * 2, boot)
        assert worlds[0].control_stamp == worlds[1].control_stamp
        rng = np.random.default_rng(7)
        a = rng.standard_normal(100_003).astype(np.float32)
        b = torch.from_numpy(rng.standard_normal(100_003).astype(np.float32))
        want = (torch.from_numpy(a) + b).numpy().tobytes()
        _allreduce_world2(worlds, a, b)
        assert a.tobytes() == want and b.numpy().tobytes() == want
        run_ranks(worlds, lambda w, r: w.rebuild(
            max_attempts=6, backoff_s=0.05, timeout_ms=10000))
        assert [w.generation for w in worlds] == [1, 1]
        a[:] = 1.5
        b[:] = 2.25
        _allreduce_world2(worlds, a, b)
        assert (a == 3.75).all() and bool((b == 3.75).all())
    finally:
        for w in worlds:
            if w is not None:
                w.close()
        c.stop()


def _same_calls(coordinator_cls, client_cls, port_base):
    """One fixed sequence of member calls; the /metrics text after it,
    its clock readings masked."""
    c = coordinator_cls(port=0, lease_ms=5000, port_base=port_base).start()
    try:
        client = client_cls(c.address)
        views = _join_all(client, "w", 2)
        client.heartbeat("w", 0, views[0]["incarnation"],
                         views[0]["generation"],
                         counters={"integrity.sealed": 5,
                                   "integrity.retransmitted": 1},
                         hists={"chunk_lat_us": {4: 7, 9: 2}})
        client.heartbeat("w", 1, views[1]["incarnation"],
                         views[1]["generation"],
                         counters={"integrity.sealed": 3})
        client.report("w", 0, views[0]["incarnation"],
                      views[0]["generation"], "boom")
        out = [None, None]
        run_ranks([None] * 2, lambda _w, r: out.__setitem__(
            r, client.sync("w", r, views[r]["incarnation"], timeout_s=10)))
        assert all(v["ok"] for v in out)
        body = client.metrics()
    finally:
        c.stop()
    return re.sub(r"^(tdr_clock_(offset|rtt)_us\{[^}]*\}) \S+$",
                  r"\1 <clock>", body, flags=re.M)


def test_metrics_text_equals_the_jax_coordinators():
    base = port_band(64)
    ours = _same_calls(Coordinator, ControlClient, base)
    ref = _same_calls(JaxCoordinator, JaxClient, base)
    assert 'tdr_ctl_rebuilds_total{world="w"} 1' in ours
    assert ours == ref


# ------------------------------------------------------ fleet tracing

_RANK_SCRIPT = r"""
import os, sys, time
import torch
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import RingWorld
from rocnrdma_tpu_torch.transport.engine import Engine

rank, coord, stop = int(sys.argv[1]), sys.argv[2], sys.argv[3]
telemetry.enable()
w = RingWorld(Engine("emu"), rank, 2, controller=coord,
              world_name="merge2", timeout_ms=20000)
print("READY", flush=True)
buf = torch.zeros(1 << 13)
deadline = time.monotonic() + 90
while time.monotonic() < deadline:
    buf[:] = rank + 1
    # The stop flag rides the allreduce, so both ranks leave after the
    # same one (a rank that saw the file alone would leave its peer
    # posting into a closed ring).
    buf[0] = float(os.path.exists(stop))
    w.allreduce(buf)
    assert bool((buf[1:] == 3).all())
    if buf[0] > 0:
        break
    time.sleep(0.02)
w.close()
"""


def test_collect_and_merge_pulls_a_segment_per_rank(tmp_path):
    c = _coordinator(lease_ms=3000)
    stop = str(tmp_path / "stop")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), c.address, stop],
        env=env, stdout=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "READY"
        time.sleep(2.0)  # past a heartbeat, collectives on the ring
        res = telemetry.collect_and_merge(c.address, "merge2",
                                          timeout_s=30.0)
    finally:
        open(stop, "w").close()
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        c.stop()
    assert rcs == [0, 0]
    assert not res["partial"] and res["world_size"] == 2
    assert sorted(res["segments"]) == ["0", "1"]
    for r, seg in res["segments"].items():
        names = {e.name for e in events_from_wire(seg["events"])}
        assert "ring_begin" in names, (r, sorted(names))
    doc = res["trace"]
    assert {e["pid"] // 1000 for e in doc["traceEvents"]} >= {1, 2}
    assert "ring_begin" in {e["name"] for e in doc["traceEvents"]}


def test_example_restores_and_trains_on_under_the_coordinator(tmp_path):
    """``examples/two_slice_dp_torch.py --controller --elastic-dir``: a
    2-step run under the port's coordinator, then a 3-step run on the
    same directory; each rank of the second restores step 2, prints
    ``RESTORED``, and trains step 3 to equal digests on both ranks."""
    coord = _coordinator(lease_ms=5000)
    args = [sys.executable, "examples/two_slice_dp_torch.py", "--cpu",
            "--batch", "2", "--seq", "16", "--engine", "emu",
            "--controller", coord.address, "--elastic-dir",
            str(tmp_path / "ck")]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    try:
        runs = [subprocess.run(args + ["--steps", str(n)], cwd=REPO,
                               capture_output=True, text=True, timeout=300,
                               env=env) for n in (2, 3)]
    finally:
        coord.stop()
    for proc in runs:
        assert proc.returncode == 0, proc.stderr[-3000:]
    out = runs[1].stdout
    assert "RESTORED 0 2" in out and "RESTORED 1 2" in out, out
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    firsts = [ln for ln in lines if ln.get("restored_step") == 2]
    steps = [ln for ln in lines if ln.get("step") == 3 and "loss" in ln]
    assert len(firsts) == 2 and len(steps) == 2
    assert len({ln["digest"] for ln in steps}) == 1
    assert all(ln["resumes"] == 0 and ln["ckpt_bytes"] > 0 for ln in steps)
    assert all(ln["generation"] >= 1 for ln in lines if "final_digest" in ln)
