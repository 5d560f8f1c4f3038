"""The port's fleet viewer (``tools/torch_top.py``) against the
reference's (``tools/tdr_top.py``): the same frames, byte for byte.

- ``render`` on the same snapshot, recorded from a sealed SEND/RECV over
  the port's loopback pair with the recorder on (as
  ``tests/test_telemetry.py`` records one), with and without the
  per-channel lanes that ``ChannelLats`` builds from the drained events;
- ``ChannelLats`` and ``sparkline`` on the same event list and buckets;
- ``parse_metrics`` and ``render_fleet`` on ``tests/test_fleet_trace.py``'s
  synthetic exposition, on an empty fleet and on a real scrape of the
  port's coordinator;
- the CLI in a subprocess: ``--demo --once`` prints a live frame of the
  port's own ring, and ``--connect`` (against the port's coordinator)
  and ``--file`` print what ``tools/tdr_top.py`` prints.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.control import ControlClient, Coordinator
from rocnrdma_tpu_torch.telemetry.recorder import TelEvent
from rocnrdma_tpu_torch.transport.engine import Engine, loopback_pair

from test_hier import port_band
from test_torch_telemetry import recording  # noqa: F401 (a fixture)
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import tdr_top as ref  # noqa: E402
import torch_top as top  # noqa: E402

# ``tests/test_fleet_trace.py``'s synthetic exposition.
FLEET_TEXT = "\n".join([
    "# tdr coordinator metrics v1",
    'tdr_ctl_generation{world="train"} 3',
    'tdr_ctl_epoch{world="train"} 5',
    'tdr_ctl_size{world="train"} 2',
    'tdr_ctl_members{world="train"} 2',
    'tdr_ctl_rebuilds_total{world="train"} 1',
    'tdr_postmortems_total{world="train"} 4',
    'tdr_retransmit_rate{world="train"} 0.0125',
    'tdr_chunk_lat_us{world="train",quantile="0.99"} 1234',
    'tdr_clock_offset_us{world="train",rank="0"} -12.5',
    'tdr_clock_offset_us{world="train",rank="1"} 40',
    'tdr_clock_rtt_us{world="train",rank="0"} 300',
    'tdr_clock_rtt_us{world="train",rank="1"} 500',
    'tdr_telemetry_dropped_total{world="train",rank="1"} 9',
    'tdr_ctl_worlds 1',
    'tdr_ctl_failovers_total 2',
    'tdr_ctl_snapshot_age_s 0.75',
    'tdr_ctl_resizes_total{world="train"} 6',
    'tdr_ctl_qp_share{world="train"} 18',
    'tdr_ctl_qp_reserved{world="train"} 12',
    'tdr_ctl_admission_rejects_total{world="train"} 3',
    'tdr_ctl_hb_throttled_total{world="train"} 7',
])


def _send_recv(engines, nbytes=4096, exchanges=3):
    """Sealed SEND/RECV exchanges over one port loopback pair."""
    a, b = loopback_pair(engines[0], port_band(1), engines[1])
    src = np.full(nbytes, 0x5A, dtype=np.uint8)
    dst = np.zeros(nbytes, dtype=np.uint8)
    smr, dmr = engines[0].reg_mr(src), engines[1].reg_mr(dst)
    try:
        for wr in range(1, exchanges + 1):
            b.post_recv(dmr, 0, nbytes, wr_id=wr)
            a.post_send(smr, 0, nbytes, wr_id=wr)
            assert a.wait(wr, timeout_ms=30000).ok
            assert b.wait(wr, timeout_ms=30000).ok
        np.testing.assert_array_equal(src, dst)
    finally:
        smr.deregister()
        dmr.deregister()
        a.close()
        b.close()


def test_render_snapshot_frames_equal_the_reference(recording):
    engines = [Engine("emu"), Engine("emu")]
    try:
        _send_recv(engines)
    finally:
        for e in engines:
            e.close()
    snap = json.loads(json.dumps(telemetry.snapshot()))
    events = telemetry.drain()
    ours, theirs = top.ChannelLats(), ref.ChannelLats()
    ours.feed(events)
    theirs.feed(events)
    assert ours.hists and ours.hists == theirs.hists
    assert ours.events == theirs.events == len(events)
    frame = top.render(snap, ours)
    assert frame == ref.render(snap, theirs)
    assert top.render(snap) == ref.render(snap)
    assert "flight recorder" in frame and "recording=ON" in frame
    assert "chunk_lat_us" in frame and "integrity.sealed" in frame
    assert "chunk_lat_us by channel (qp lane):" in frame


def test_channel_lats_and_sparkline_equal_the_reference():
    """Posts paired with their completions per QP lane, a completion
    with no post, one at or before its post, and the bound on the
    pairing table."""
    evs = []
    for i in range(40):
        qp = 3 + i % 3
        evs.append(TelEvent(ts_ns=1000 * i, name=("post_send", "post_recv",
                                                  "post_write")[i % 3],
                            qp=qp, id=i))
        evs.append(TelEvent(ts_ns=1000 * i + (i * 7919) % 400_000,
                            name="wc", qp=qp, id=i))
    evs += [TelEvent(ts_ns=5, name="wc", qp=9, id=77),
            TelEvent(ts_ns=10, name="post_read", qp=9, id=78),
            TelEvent(ts_ns=10, name="wc", qp=9, id=78),
            TelEvent(ts_ns=11, name="post_send", qp=0, id=1)]
    evs += [TelEvent(ts_ns=20 + i, name="post_send", qp=12, id=i)
            for i in range(65600)]
    ours, theirs = top.ChannelLats(), ref.ChannelLats()
    ours.feed(evs)
    theirs.feed(evs)
    assert ours.hists == theirs.hists and sorted(ours.hists) == [3, 4, 5]
    assert ours.posts == theirs.posts and len(ours.posts) < 65536
    assert ours.render() == theirs.render()
    assert top.ChannelLats().render() == ref.ChannelLats().render() == []
    for buckets in ([0] * 64, [1] * 64, [0] * 10 + [5000] + [1] * 53,
                    list(range(64)), [3, 0, 0, 9]):
        for width in (32, 8, 64):
            assert (top.sparkline(buckets, width)
                    == ref.sparkline(buckets, width))


def _coordinator_scrape():
    """A real scrape of the port's coordinator with two worlds, one of
    them heartbeating counters and clock readings."""
    c = Coordinator(port=0, lease_ms=5000, port_base=port_band(64),
                    qp_budget=64, qp_fair=True).start()
    try:
        client = ControlClient(c.address)
        views = {}
        for name in ("train", "serve"):
            got = [None, None]
            run_ranks([None] * 2, lambda _w, r: got.__setitem__(
                r, client.join(name, 2, rank=r, resizable=True)))
            views[name] = got
        v = views["train"][1]
        client.heartbeat("train", 1, v["incarnation"], v["generation"],
                         counters={"integrity.sealed": 5,
                                   "telemetry.dropped": 2},
                         hists={"chunk_lat_us": {4: 7, 9: 2}},
                         clock_offset_ns=-3500, clock_rtt_ns=120000,
                         clock_samples=4)
        return client.metrics()
    finally:
        c.stop()


@pytest.mark.parametrize("source", ["synthetic", "empty", "coordinator"])
def test_fleet_frames_equal_the_reference(source):
    text = {"synthetic": lambda: FLEET_TEXT,
            "empty": lambda: "# tdr coordinator metrics v1\n",
            "coordinator": _coordinator_scrape}[source]()
    assert top.parse_metrics(text) == ref.parse_metrics(text)
    frame = top.render_fleet(text)
    assert frame == ref.render_fleet(text)
    if source == "synthetic":
        assert "fleet: worlds=1 failovers=2 snapshot_age=0.8s" in frame
        assert "world train: gen=3 epoch=5 members=2/2" in frame
        assert "rebuilds=1 resizes=6 postmortems=4" in frame
        assert ("qp_share=18 qp_reserved=12 admission_rejects=3 "
                "hb_throttled=7") in frame
        assert "retransmit_rate=0.0125" in frame
        assert "chunk_p99_us=1234" in frame
        assert ("rank 0: clock_offset=-12.5us (rtt 300.0us) dropped=0"
                in frame)
        assert "rank 1: clock_offset=+40.0us" in frame
        assert "dropped=9  TAINTED" in frame
    elif source == "empty":
        assert frame.endswith("(no worlds registered)")
    else:
        assert "world serve: gen=" in frame and "world train: gen=" in frame
        assert "rank 1: clock_offset=" in frame


# ------------------------------------------------------------ the CLI

def _cli(tool, *args):
    env = {k: v for k, v in os.environ.items() if k != "TDR_NATIVE_LIB"}
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, tool)]
                          + list(args), cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_cli_demo_once_prints_a_live_frame():
    out = _cli("torch_top.py", "--demo", "--once")
    assert out.startswith("tdr_top — flight recorder  [recording=ON ")
    assert "histograms (log2 buckets; p50/p90/p99 upper-edge):" in out
    assert "chunk_lat_us by channel (qp lane):" in out
    assert "progress: shards=" in out and "counters:" in out


def test_cli_connect_and_file_print_what_the_reference_prints(tmp_path):
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({
        "enabled": True, "recorded": 12, "dropped": 1,
        "counters": {"integrity.sealed": 4, "progress.shards": 2,
                     "fold.jobs": 3, "zero.skipped": 0},
        "histograms": {"chunk_lat_us": [0] * 6 + [4, 9, 1] + [0] * 55},
        "percentiles": {"chunk_lat_us": {"p50": 128, "p90": 256,
                                         "p99": 512}}}))
    # A lease past the test's end: no heartbeat renews these members,
    # and an expiry between two CLI calls would change the frame.
    c = Coordinator(port=0, lease_ms=600_000,
                    port_base=port_band(64)).start()
    try:
        client = ControlClient(c.address)
        run_ranks([None] * 2, lambda _w, r: client.join("train", 2, rank=r))
        for args in (["--connect", c.address], ["--file", str(snap)],
                     ["--connect", c.address, "--file", str(snap)],
                     ["--file", str(tmp_path / "missing.json")]):
            out = _cli("torch_top.py", "--once", *args)
            assert out == _cli("tdr_top.py", "--once", *args), args
            if "--connect" in args:
                assert "world train: gen=" in out
    finally:
        c.stop()
