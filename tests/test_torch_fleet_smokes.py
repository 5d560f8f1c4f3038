"""The port's control, trace and brownout smokes and its copy of
``tools/tdr_explain.py``'s analysis, against the reference's:
``tools/torch_control_smoke.py``, ``tools/torch_trace_smoke.py``,
``tools/torch_brownout_smoke.py`` and
``rocnrdma_tpu_torch/tools/explain.py`` beside ``tools/control_smoke.py``,
``tools/trace_smoke.py``, ``tools/brownout_smoke.py`` and
``tools/tdr_explain.py``.

Tier-1:

- ``analyze_segments`` and ``explain_postmortem`` of the port equal the
  reference's on the same input: hand-built segments (a straggler with
  its phases and a matched link, a degraded link that heals and one
  that does not, serving stream requests, clock offsets and a tainted
  rank), segments recorded from a port world-2 run with the recorder
  on, and postmortem bundles written by the port's ranks; on each,
  ``render_text`` gives the reference's text;
- the explainer's command line (``rocnrdma_tpu_torch.tools.explain``'s
  ``main``, ``python3 -m rocnrdma_tpu_torch.tools.explain`` and
  ``tools/torch_explain.py``) prints what ``tools/tdr_explain.py``
  prints in its ``--trace``, ``--postmortem`` and ``--json`` modes and
  writes the same ``--out`` trace; ``--collect`` pulls a port world's
  segments through the port's coordinator;
- the control smoke's lite drive, in a ``python -c`` subprocess (the
  tool sets ``TDR_TELEMETRY`` before the port's library loads), holds
  every gate, and its verdict has the reference tool's keys;
- the trace smoke's rank processes inherit the parent's environment,
  the sanitizer's variables included.

Slow: each tool's CLI with all its gates, the port's counterparts of
``make control-smoke``, ``make trace-smoke`` and ``make brownout-smoke``:
control's full mode on the CPU (``--cpu``) and its lite mode, the trace
smoke (four rank processes and a coordinator; its straggler attribution
rests on timing) and the brownout smoke (a ladder driven by timing).
Ring ports come from ``tests/test_hier.py``'s ``port_band``.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.serving.stream import make_stream_coll
from rocnrdma_tpu_torch.telemetry.recorder import TelEvent, events_to_wire
from rocnrdma_tpu_torch.tools import explain
from rocnrdma_tpu_torch.transport.engine import TransportError

from test_hier import port_band
from test_torch_telemetry import recording  # noqa: F401 (a fixture)
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import tdr_explain as ref_explain  # noqa: E402

MS = 1_000_000


def _both(segments):
    """The port's analysis of ``segments``, held equal to the
    reference's, and its text equal to the reference's."""
    got = explain.analyze_segments(segments)
    assert got == ref_explain.analyze_segments(segments)
    assert explain.render_text(got) == ref_explain.render_text(got)
    return got


# ------------------------------------------------ hand-built segments

def _world_up(rank, left, right, world="syn", size=2):
    return TelEvent(ts_ns=0, name="world.up", source="python",
                    fields={"world_name": world, "rank": rank,
                            "world": size, "tel_left": [left],
                            "tel_right": [right]})


def _seg(events, offset=0, dropped=0):
    return {"events": events_to_wire(events), "clock_offset_ns": offset,
            "dropped": dropped}


def _straggler_and_link():
    """``tests/test_fleet_trace.py``'s pair: rank 1 arrives 5 ms late,
    r0.right(12) -> r1.left(21) carries one 4 KiB frame, rank 1's ring
    dropped events."""
    r0 = [
        _world_up(0, 11, 12),
        TelEvent(ts_ns=1 * MS, name="ring_begin", engine=1, id=1,
                 arg=4096, coll=5),
        TelEvent(ts_ns=2 * MS, name="post_send", engine=1, qp=12, id=1,
                 arg=4096, coll=5),
        TelEvent(ts_ns=3 * MS, name="wire_tx", engine=1, qp=12, id=1,
                 arg=4096, coll=5),
        TelEvent(ts_ns=9 * MS, name="wc", engine=1, qp=12, id=1, arg=0,
                 coll=5),
        TelEvent(ts_ns=10 * MS, name="ring_end", engine=1, id=1, arg=0,
                 coll=5),
    ]
    r1 = [
        _world_up(1, 21, 22),
        TelEvent(ts_ns=6 * MS, name="ring_begin", engine=2, id=1,
                 arg=4096, coll=5),
        TelEvent(ts_ns=7 * MS, name="wire_rx", engine=2, qp=21, id=1,
                 arg=4096, coll=5),
        TelEvent(ts_ns=8 * MS, name="land", engine=2, qp=21, id=1,
                 arg=4096, coll=5),
        TelEvent(ts_ns=10 * MS, name="ring_end", engine=2, id=1, arg=0,
                 coll=5),
    ]
    return {"0": _seg(r0), "1": _seg(r1, dropped=7)}


def _degraded_link():
    """Rank 0 reports its delegate link to rank 1 degraded, and a second
    link that degrades and heals; rank 1 straggles behind it."""
    def ring(engine, begin_ms, end_ms, coll=5):
        return [TelEvent(ts_ns=begin_ms * MS, name="ring_begin",
                         engine=engine, id=1, arg=4096, coll=coll),
                TelEvent(ts_ns=end_ms * MS, name="ring_end",
                         engine=engine, id=1, arg=0, coll=coll)]

    def health_ev(ms, name, link, peer, rung, score):
        return TelEvent(ts_ns=ms * MS, name=name, source="python",
                        fields={"world_name": "syn", "link": link,
                                "peer": peer, "rung": rung,
                                "score": score})

    r0 = ring(1, 1, 10) + ring(1, 11, 14, coll=(1 << 63) | 6) + [
        health_ev(2, "health.degrade", "inter:r0", 1, "fallback", 0.31),
        health_ev(3, "health.degrade", "inter:r9", 3, "wire_down", 0.7),
        health_ev(4, "health.heal", "inter:r9", 3, "wire_down", 0.92),
    ]
    r1 = ring(2, 6, 10) + ring(2, 12, 14, coll=(1 << 63) | 6)
    return {"0": _seg(r0), "1": _seg(r1, offset=-250_000)}


def _stream_requests():
    """Three ranks of serving streams: batch-level weight traffic
    (request 0) and two requests' KV transfers, one retransmitted; the
    request-7 transfers wait on rank 2."""
    def xfer(engine, coll, begin_ms, end_ms, nbytes, retx=False):
        evs = [TelEvent(ts_ns=begin_ms * MS, name="ring_begin",
                        engine=engine, id=1, arg=nbytes, coll=coll),
               TelEvent(ts_ns=(begin_ms + 1) * MS, name="wire_tx",
                        engine=engine, qp=engine * 10, id=coll & 0xff,
                        arg=nbytes, coll=coll)]
        if retx:
            evs.append(TelEvent(ts_ns=(begin_ms + 2) * MS, name="retx",
                                engine=engine, qp=engine * 10, id=1,
                                arg=nbytes, coll=coll))
        evs.append(TelEvent(ts_ns=end_ms * MS, name="ring_end",
                            engine=engine, id=1, arg=0, coll=coll))
        return evs

    colls = [(make_stream_coll(0, 1), (1, 1, 1)),
             (make_stream_coll(7, 2), (2, 3, 9)),
             (make_stream_coll(7, 3), (12, 13, 20)),
             (make_stream_coll(9, 4), (22, 21, 22))]
    ranks = {r: [] for r in range(3)}
    for coll, begins in colls:
        for r, b in enumerate(begins):
            ranks[r] += xfer(r + 1, coll, b, 30, 65536 * (r + 1),
                             retx=(r == 1 and coll & 0xff == 3))
    return {str(r): _seg(evs, offset=1000 * r) for r, evs in ranks.items()}


@pytest.mark.parametrize("build", [_straggler_and_link, _degraded_link,
                                   _stream_requests],
                         ids=["straggler_phases_link", "degraded_link",
                              "stream_requests"])
def test_explain_hand_built_segments_equal_the_reference(build):
    a = _both(build())
    assert a["n_collectives"] >= 1
    assert a["straggler"]["rank"] is not None
    if build is _straggler_and_link:
        assert a["straggler"]["rank"] == 1
        assert len(a["links"]) == 1 and a["links"][0]["bytes"] == 4096
        assert a["tainted_ranks"] == {"1": 7}
    if build is _degraded_link:
        assert a["degraded_links"] == {"0": {"inter:r0": {
            "peer": 1, "rung": "fallback", "score": 0.31}}}
    if build is _stream_requests:
        assert set(a["serving"]) == {"0", "7", "9"}
        assert a["serving"]["7"]["transfers"] == 2
        assert a["serving"]["7"]["retx"] == 1
        assert a["serving"]["7"]["straggler_votes"] == {"2": 2}


# ----------------------------------------------- the port's own ranks

def _world2(**kw):
    worlds = local_worlds(2, port_band(8), **kw)
    rng = np.random.default_rng(5)
    for _ in range(3):
        bufs = [rng.integers(-9, 9, 1 << 15).astype(np.float32)
                for _ in range(2)]
        want = bufs[0] + bufs[1]
        run_ranks(worlds, lambda w, r: w.allreduce(bufs[r]))
        assert all(b.tobytes() == want.tobytes() for b in bufs)
    return worlds


def test_explain_recorded_port_segments_equal_the_reference(recording):
    """A port world-2 run's timeline, split into each rank's segment
    (native events by the rank's engine, python events by their rank
    field), analysed by both copies."""
    import time

    t0 = time.monotonic_ns()
    worlds = _world2()
    engines = {w.engine.telemetry_id: w.rank for w in worlds}
    for w in worlds:
        w.close()
    ranks = {0: [], 1: []}
    for e in telemetry.timeline():
        if e.ts_ns < t0:
            continue
        if e.source == "native" and e.engine in engines:
            ranks[engines[e.engine]].append(e)
        elif e.source == "python" and e.fields.get("rank") in ranks:
            ranks[e.fields["rank"]].append(e)
    segments = {str(r): _seg(evs, offset=500 * r, dropped=0)
                for r, evs in ranks.items()}
    a = _both(segments)
    assert a["joinable_collectives"] >= 3
    assert a["links"], "no tx->rx pair matched across the two ranks"


def _port_incident(monkeypatch, root):
    """A retryable failure, then a rebuild on both ranks of a port
    world-2 ring: the incident directory of the bundles the ranks
    write."""
    monkeypatch.setenv("TDR_POSTMORTEM_DIR", str(root))
    worlds = _world2(world_name="pmfleet")
    try:
        worlds[1]._teardown()
        with pytest.raises(TransportError) as err:
            worlds[1].allreduce(np.ones(8, np.float32))
        assert err.value.retryable
        run_ranks(worlds, lambda w, r: w.rebuild(reason="fleet incident"))
    finally:
        for w in worlds:
            w.close()
    return str(root / "pmfleet" / "incident-g0")


def test_explain_postmortem_of_port_bundles_equals_the_reference(
        recording, monkeypatch, tmp_path):
    """The bundles the port's ranks write, merged by both copies."""
    inc_dir = _port_incident(monkeypatch, tmp_path)
    got = explain.explain_postmortem(inc_dir)
    want = ref_explain.explain_postmortem(inc_dir)
    assert got == want
    text = explain.render_text(got)
    assert text == ref_explain.render_text(want)
    assert text.startswith(f"incident: world=pmfleet generation="
                           f"{got['incident']['generation']} ({inc_dir})")
    assert got["incident"]["world"] == "pmfleet"
    assert sorted(got["incident"]["ranks"]) == ["0", "1"]
    assert got["incident"]["ranks"]["1"]["error"] == "fleet incident"
    assert got["n_collectives"] >= 1
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit):
        explain.explain_postmortem(str(empty))


_DEGRADED = {"0": {"inter:r0": {"peer": 1, "rung": "fallback",
                                "score": 0.31},
                   "inter:r4": {"peer": 2, "rung": "wire_int8",
                                "score": 0.5}},
             "3": {"intra:r3": {"peer": 1, "rung": "wire_bf16",
                                "score": 0.8}}}


@pytest.mark.parametrize("rank", [None, 0, 1, 2, 3, 5])
def test_degraded_label_equals_the_reference(rank):
    """A straggler that reported a degraded link itself, one that is the
    peer behind a reporter's link (the first reporter in order), and one
    that is neither."""
    got = explain._degraded_label(rank, _DEGRADED)
    assert got == ref_explain._degraded_label(rank, _DEGRADED)
    assert got == {None: "", 5: "",
                   0: " [degraded link inter:r0 -> peer r1 (rung "
                      "fallback)]",
                   1: " [behind degraded link inter:r0 reported by r0 "
                      "(rung fallback)]",
                   2: " [behind degraded link inter:r4 reported by r0 "
                      "(rung wire_int8)]",
                   3: " [degraded link intra:r3 -> peer r1 (rung "
                      "wire_bf16)]"}[rank]


# ------------------------------------------------- the explainer's CLI

def _main_out(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("build", [_straggler_and_link, _degraded_link,
                                   _stream_requests],
                         ids=["straggler_phases_link", "degraded_link",
                              "stream_requests"])
def test_explain_cli_trace_modes_print_what_the_reference_prints(
        build, tmp_path, capsys):
    """``--trace`` over saved raw segments (the perfetto CLI's ``--raw``
    shape), as text and as ``--json``, and the ``--out`` trace."""
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps({"world": "syn", "segments": build()}))
    for extra in ([], ["--json"]):
        argv = ["--trace", str(raw)] + extra
        got = _main_out(explain.main, argv, capsys)
        assert got == _main_out(ref_explain.main, argv, capsys), extra
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    _main_out(explain.main, ["--trace", str(raw), "--out", str(ours)],
              capsys)
    _main_out(ref_explain.main, ["--trace", str(raw), "--out", str(ref)],
              capsys)
    assert ours.read_bytes() == ref.read_bytes()
    assert json.loads(ours.read_text())["traceEvents"]


def test_explain_cli_postmortem_and_subprocess_forms(
        recording, monkeypatch, tmp_path, capsys):
    """``--postmortem`` over the port ranks' bundles, as text, ``--json``
    and with ``--out``; then the two command forms of the port's CLI in
    subprocesses against the reference's text and JSON."""
    inc_dir = _port_incident(monkeypatch, tmp_path / "pm")
    outs = {}
    for extra in ([], ["--json"]):
        argv = ["--postmortem", inc_dir] + extra
        outs[tuple(extra)] = _main_out(explain.main, argv, capsys)
        assert outs[tuple(extra)] == _main_out(ref_explain.main, argv,
                                               capsys)
    assert outs[()].startswith("incident: world=pmfleet generation=")
    assert "  rank 0: error=" in outs[()] and "  rank 1: error=" in outs[()]
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    _main_out(explain.main, ["--postmortem", inc_dir, "--out", str(ours)],
              capsys)
    _main_out(ref_explain.main, ["--postmortem", inc_dir, "--out",
                                 str(ref)], capsys)
    assert ours.read_bytes() == ref.read_bytes()
    env = {k: v for k, v in os.environ.items() if k != "TDR_NATIVE_LIB"}
    for cmd, extra in (
            ([os.path.join(TOOLS, "torch_explain.py")], []),
            (["-m", "rocnrdma_tpu_torch.tools.explain"], ["--json"])):
        proc = subprocess.run([sys.executable] + cmd
                              + ["--postmortem", inc_dir] + extra,
                              cwd=REPO, capture_output=True, text=True,
                              timeout=120, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout == outs[tuple(extra)], cmd
    with pytest.raises(SystemExit):
        explain.main(["--collect", "127.0.0.1:1"])  # --world is required


def test_explain_cli_collect_pulls_a_port_world(recording, capsys):
    """``--collect`` through the port's coordinator: a segment from each
    rank of a port world-2 ring, analysed as the reference analyses the
    same segments."""
    from rocnrdma_tpu_torch.control import Coordinator

    c = Coordinator(port=0, lease_ms=1500, port_base=port_band(64)).start()
    worlds = []
    try:
        worlds = _world2(controller=c.address, world_name="collect2")
        out = _main_out(explain.main, ["--collect", c.address, "--world",
                                       "collect2", "--timeout", "20",
                                       "--json"], capsys)
    finally:
        for w in worlds:
            w.close()
        c.stop()
    a = json.loads(out)
    assert a["ranks"] == [0, 1]
    assert a["n_collectives"] >= 1


# ------------------------------------------------------------ control

# The tools run in the environment of their reference ``make`` targets,
# which leave the ring's stall deadline at its 30 s default. The suite's
# 120 s (``tests/conftest.py``) outlasts the drives' rebuild budgets
# (control lite: 8 attempts of 10 s): a rank whose ring op has not yet
# seen a peer's flap waits out the deadline while its peers give up on
# the rendezvous, in the reference's drive as in the port's.
_TOOL_ENV_DROP = ("TDR_NATIVE_LIB", "TDR_CONTROL_SMOKE_LITE",
                  "TDR_RING_TIMEOUT_MS")


def _tool_env(**env):
    full = {k: v for k, v in os.environ.items() if k not in _TOOL_ENV_DROP}
    full.update(env)
    return full


def _run(script, timeout=300, **env):
    full = _tool_env()
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


def _reference_verdict_keys(tool):
    """The keys of the ``verdict = {...}`` literal in a reference tool,
    then ``ok``."""
    with open(os.path.join(TOOLS, tool)) as f:
        tree = ast.parse(f.read())
    lit = next(node.value for node in ast.walk(tree)
               if isinstance(node, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "verdict"
                       for t in node.targets)
               and isinstance(node.value, ast.Dict))
    return [k.value for k in lit.keys] + ["ok"]


_CONTROL_LITE = """
import json
import torch_control_smoke as m
verdict, runs = m.control_smoke(lite=True, port_base={base})
print("CONTROL " + json.dumps(verdict))
print("RUNS " + json.dumps(runs))
"""


def test_control_lite_holds_every_gate():
    out = _run(_CONTROL_LITE.format(base=port_band(128)))
    v = _line(out, "CONTROL ")
    assert list(v) == _reference_verdict_keys("control_smoke.py")
    assert v["lite"] is True and v["world"] == 4
    assert v["parity"] and v["side_ok"]
    assert v["pinned_names_scraped"] and v["slo_names_on_final_scrape"]
    assert v["arbitrated_rebuilds"] >= 1
    assert v["rebuilds_served_on_metrics"] >= 1
    assert len(v["ctl_events_in_perfetto"]) >= 2
    assert "ctl.rebuild" in v["ctl_events_in_perfetto"]
    assert len(v["generations"]) == 1 and v["generations"][0] >= 1
    assert v["ok"] is True  # ctl.release >= 1 is inside it
    runs = _line(out, "RUNS ")
    assert len(runs["lite"]["rebuild_s"]) >= 1


# -------------------------------------------------------------- trace

def test_trace_smoke_ranks_inherit_the_environment(monkeypatch):
    """A rank process gets the parent's whole environment, so a
    sanitized run's ranks load the same ``libtdr_san.so`` under the same
    preloaded ASan, plus the recorder switch and the rank's own
    riders."""
    import torch_trace_smoke as m

    seen = {}

    class FakePopen:
        def __init__(self, argv, env, cwd):
            seen.update(argv=argv, env=env, cwd=cwd)

    san = {"LD_PRELOAD": "/lib/libasan.so",
           "TDR_NATIVE_LIB": "/native/libtdr_san.so",
           "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1"}
    for k, v in san.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(m.subprocess, "Popen", FakePopen)
    m.spawn_rank("tracefleet", "127.0.0.1:1", 2, 10,
                 {"TDR_FAULT_PLAN": "ring:stall_ms=8"})
    env = seen["env"]
    for k, v in san.items():
        assert env[k] == v
    assert env["TDR_TELEMETRY"] == "1"
    assert env["TDR_FAULT_PLAN"] == "ring:stall_ms=8"
    assert seen["argv"][1] == os.path.join(TOOLS, "torch_trace_smoke.py")
    assert seen["argv"][2] == "--rank-main"
    assert seen["cwd"] == REPO


# --------------------------------------------------- the CLIs (slow)

@pytest.mark.slow
@pytest.mark.parametrize("tool,args,env,marker", [
    ("torch_control_smoke.py", ["--cpu"], {}, '"ok": true'),
    ("torch_control_smoke.py", [], {"TDR_CONTROL_SMOKE_LITE": "1"},
     '"ok": true'),
    ("torch_trace_smoke.py", [], {}, "trace smoke OK"),
    ("torch_brownout_smoke.py", [], {}, '"ok": true'),
], ids=["control_cpu", "control_lite", "trace", "brownout"])
def test_fleet_smoke_cli_holds_every_gate(tool, args, env, marker):
    """Each tool's CLI with all its gates. The brownout case is known to
    fail its ``healed`` gate on timing in most plain runs on an 8-core
    host, as the reference's ``tools/brownout_smoke.py`` does there
    (ROADMAP Queue 3): read a red brownout run for the other gates
    first (the rung walk in order, zero rebuilds, bitwise parity, the
    thread census) before putting it down to timing."""
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, tool)]
                          + args, cwd=REPO, capture_output=True, text=True,
                          timeout=900, env=_tool_env(**env))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert marker in proc.stdout, proc.stdout[-2000:]
