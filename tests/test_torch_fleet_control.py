"""The port's elastic-fleet control plane: the fifteen units of
``tests/test_control.py`` that ``tests/test_torch_control.py`` does not
run, over the port's coordinator, client, engine and ``RingWorld``.
They are the units under the fleet soak's gates
(``tools/torch_fleet_soak.py``): grow RESIZE, admission, fair share,
rate limits and heartbeat-after-leave.

Where the reference's unit is deterministic, ``_on_both`` makes every
call on the port's coordinator (and client) and on the reference's, in
turn, with the reference's asserts on each, and holds what they return
and serve equal: retry-after values, fair-share division, the views of
one coalesced grow, the ``/metrics`` text (clock readings masked), the
429 and throttle counters, the heartbeat's pushes. The rebuild jitter
is held the same way over both packages' worlds: the same seed gives
the same backoff sleeps. The units that bring rings up — engines
shared by two worlds, the two QP budgets, the EADDRINUSE fast retry —
run on the port's engine and worlds.

Ports come from ``tests/test_hier.py``'s ``port_band``.
"""

import re
import socket
import time

import numpy as np
import pytest

from rocnrdma_tpu.collectives.world import local_worlds as jax_local_worlds
from rocnrdma_tpu.collectives.world import rebuild_jitter_seed as \
    jax_jitter_seed
from rocnrdma_tpu.control.client import ControlClient as JaxClient
from rocnrdma_tpu.control.client import ControlError as JaxControlError
from rocnrdma_tpu.control.coordinator import Coordinator as JaxCoordinator
from rocnrdma_tpu.transport.engine import TransportError as JaxTransportError
from rocnrdma_tpu.utils.trace import trace as jax_trace
from rocnrdma_tpu_torch.collectives.world import (RingWorld, local_worlds,
                                                  rebuild_jitter_seed)
from rocnrdma_tpu_torch.control import ControlClient, Coordinator
from rocnrdma_tpu_torch.control.client import ControlError
from rocnrdma_tpu_torch.transport.engine import (Engine, TransportError,
                                                 loopback_pair,
                                                 native_counters)
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import port_band
from test_torch_world import run_ranks

SIDES = {
    "torch": (Coordinator, ControlClient, ControlError),
    "jax": (JaxCoordinator, JaxClient, JaxControlError),
}


def _on_both(unit, **coord_kw):
    """``unit(coordinator, client, control_error)`` against a fresh
    coordinator of each package (``coord_kw`` its options, one port
    base for both); asserts the two results equal and returns the
    port's."""
    base = port_band(64)
    got = {}
    for side, (coord_cls, client_cls, err_cls) in SIDES.items():
        c = coord_cls(port=0, port_base=base, **coord_kw).start()
        try:
            got[side] = unit(c, client_cls(c.address), err_cls)
        finally:
            c.stop()
    assert got["torch"] == got["jax"]
    return got["torch"]


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


def _masked(body: str) -> str:
    """A ``/metrics`` text with its clock readings masked."""
    return re.sub(r"^(tdr_clock_(offset|rtt)_us\{[^}]*\}) \S+$",
                  r"\1 <clock>", body, flags=re.M)


def _view(v: dict) -> dict:
    """A join or sync view without its clock readings and without its
    incarnation, which concurrent joins take in arrival order."""
    return {k: v[k] for k in sorted(v)
            if k not in ("t1_ns", "t2_ns", "incarnation")}


# ------------------------------------------------- worlds and budgets


def test_concurrent_worlds_share_engines():
    """One engine pair hosting two named worlds: both rings reduce
    correctly (the multi-tenant path clears the engine-wide seal stamp
    instead of letting the worlds fence each other)."""
    c = Coordinator(port=0, lease_ms=1500, port_base=port_band(64)).start()
    engines = [Engine("emu") for _ in range(2)]
    worlds = []
    try:
        wa = local_worlds(2, engines=engines, controller=c.address,
                          world_name="tenant-a", channels=1,
                          timeout_ms=15000)
        worlds += wa
        wb = local_worlds(2, engines=engines, controller=c.address,
                          world_name="tenant-b", channels=1,
                          timeout_ms=15000)
        worlds += wb
        assert engines[0].world_count == 2
        bufs = {(tag, r): np.full(32, val * (r + 1), dtype=np.int32)
                for tag, val in (("a", 1), ("b", 10)) for r in range(2)}
        run_ranks(wa + wb, lambda w, i: w.allreduce(
            bufs[("a" if i < 2 else "b", i % 2)]))
        for r in range(2):
            np.testing.assert_array_equal(bufs[("a", r)],
                                          np.full(32, 3, dtype=np.int32))
            np.testing.assert_array_equal(bufs[("b", r)],
                                          np.full(32, 30, dtype=np.int32))
    finally:
        for w in worlds:
            w.close()
        for e in engines:
            e.close()
        c.stop()


def test_native_qp_limit_enforced_at_bringup():
    eng = Engine("emu")
    try:
        eng.set_qp_limit(2)
        assert eng.qp_limit == 2
        base = port_band(3)
        a, b = loopback_pair(eng, base)
        assert eng.qp_live == 2
        with pytest.raises(TransportError) as ei:
            eng.connect("127.0.0.1", base + 1, timeout_ms=500)
        assert "qp budget exhausted" in str(ei.value)
        # Budget exhaustion is a configuration condition: rebuilding
        # cannot create headroom, so it must not be retryable.
        assert not ei.value.retryable
        a.close()
        b.close()
        assert eng.qp_live == 0
        # Headroom restored: bring-up works again.
        a, b = loopback_pair(eng, base + 2)
        a.close()
        b.close()
    finally:
        eng.close()


def test_world_qp_budget_enforced_at_bringup():
    eng = Engine("emu")
    try:
        with pytest.raises(TransportError) as ei:
            RingWorld(eng, 0, 2, port_band(4), channels=2, qp_budget=2,
                      timeout_ms=2000)
        assert "qp_budget" in str(ei.value)
        assert not ei.value.retryable
        # The refusal happened before any connection was attempted.
        assert eng.qp_live == 0
    finally:
        eng.close()


def test_eaddrinuse_is_fast_retry_not_full_backoff():
    """A lingering listener from a torn-down incarnation blocks the
    accept port briefly; ``RingWorld._listen`` must ride it out INSIDE
    one attempt (50 ms fast retry against the attempt's own deadline)
    instead of failing the bootstrap and burning a backoff attempt."""
    port = port_band(1)
    squatter = socket.socket()
    squatter.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    squatter.bind(("127.0.0.1", port))
    squatter.listen(1)
    eng = Engine("emu")
    eng2 = Engine("emu")
    # A bare RingWorld shell: _listen only needs .engine.
    shell = RingWorld.__new__(RingWorld)
    shell.engine = eng
    try:
        with pytest.raises(TransportError) as ei:
            eng.listen("127.0.0.1", port, 100)
        assert "address already in use" in str(ei.value).lower()
        result = [None]
        t0 = time.monotonic()

        def serve(_w, _r):
            result[0] = shell._listen("127.0.0.1", port, 10000)

        def release(_w, _r):
            time.sleep(0.4)
            squatter.close()  # the lingering incarnation lets go
            time.sleep(0.2)
            result.append(eng2.connect("127.0.0.1", port,
                                       timeout_ms=8000))

        run_ranks([None, None], lambda w, r: (serve, release)[r](w, r))
        elapsed = time.monotonic() - t0
        assert result[0] is not None
        # Converged promptly after release: fast retry, not a failed
        # attempt plus exponential backoff.
        assert elapsed < 5.0, elapsed
        result[1].close()
        result[0].close()
    finally:
        squatter.close()
        eng.close()
        eng2.close()


def _failed_rebuild_sleeps(make_worlds, trace_obj, error_cls):
    """Rank 0 of a world-2 ring rebuilds with every bootstrap refused:
    the backoff sleeps its trace records between the attempts."""
    worlds = make_worlds()
    try:
        w = worlds[0]

        def refuse(timeout_ms):
            raise error_cls("refused", retryable=True)

        w._bootstrap = refuse
        since = time.monotonic()
        with pytest.raises(error_cls):
            w.rebuild(max_attempts=5, backoff_s=0.004,
                      backoff_cap_s=0.05)
        return [(f["generation"], f["sleep_s"])
                for at, _, f in trace_obj.events("world.rebuild")
                if at >= since and f.get("phase") == "retry"
                and f.get("rank") == 0]
    finally:
        for w in worlds:
            w.close()


def test_rebuild_jitter_is_deterministic(monkeypatch):
    """The jitter stream is a pure function of (seed, rank, generation):
    a soak failure replays with the same sleeps under the same
    ``TDR_REBUILD_SEED``. Both packages' worlds sleep the same."""
    import random as _random

    monkeypatch.setenv("TDR_REBUILD_SEED", "7")
    assert rebuild_jitter_seed() == jax_jitter_seed() == 7
    a = _random.Random("7:1:3")
    b = _random.Random("7:1:3")
    c = _random.Random("7:2:3")
    seq_a = [a.random() for _ in range(4)]
    assert seq_a == [b.random() for _ in range(4)]
    assert seq_a != [c.random() for _ in range(4)]

    ours = _failed_rebuild_sleeps(lambda: local_worlds(2, port_band(8)),
                                  trace, TransportError)
    ref = _failed_rebuild_sleeps(
        lambda: jax_local_worlds(2, port_band(8)), jax_trace,
        JaxTransportError)
    assert len(ours) == 4 and ours == ref
    gen = ours[0][0]
    rng = _random.Random(f"7:0:{gen}")
    want, delay = [], 0.004
    for _ in range(4):
        want.append((gen, round(delay * (1.0 + 0.25 * rng.random()), 3)))
        delay = min(delay * 2.0, 0.05)
    assert ours == want


# ------------------------------------------------------------ metrics


def test_metrics_match_native_registry_snapshot():
    """The /metrics values for registry counters are EXACTLY the
    ``tdr_counters_read`` snapshot the member pushed (single member, so
    the per-world sum is the identity); both coordinators serve the
    same text for the same snapshot."""
    snap = native_counters()
    names = ("integrity.sealed", "integrity.verified", "integrity.failed",
             "integrity.retransmitted", "fault.hits", "telemetry.recorded")

    def unit(c, client, _err):
        views = _join_all(client, "solo", 2)
        client.heartbeat("solo", 0, views[0]["incarnation"],
                         views[0]["generation"], counters=snap)
        body = client.metrics()
        for name in names:
            served = _metric(
                body, f'tdr_{name.replace(".", "_")}_total{{world="solo"}}')
            assert served == snap[name], name
        return _masked(body)

    _on_both(unit, lease_ms=1500)


def test_metrics_per_member_rank_labels():
    """Member-pushed registry series are ALSO served per ring slot with
    a ``rank=`` label: each rank's series carries exactly its own pushed
    snapshot, while the aggregate ``{world=}`` series keeps its pinned
    label shape and value (the sum over slots)."""
    def unit(c, client, _err):
        views = _join_all(client, "ranked", 2)
        pushed = ({"integrity.sealed": 100, "integrity.retransmitted": 4},
                  {"integrity.sealed": 23, "integrity.retransmitted": 1})
        for r in range(2):
            client.heartbeat("ranked", r, views[r]["incarnation"],
                             views[r]["generation"], counters=pushed[r])
        body = client.metrics()
        for name in ("integrity.sealed", "integrity.retransmitted"):
            metric = f"tdr_{name.replace('.', '_')}_total"
            for r in range(2):
                assert _metric(body, f'{metric}{{world="ranked",'
                               f'rank="{r}"}}') == pushed[r][name]
            assert _metric(body, f'{metric}{{world="ranked"}}') == \
                pushed[0][name] + pushed[1][name]
        return _masked(body)

    _on_both(unit, lease_ms=1500)


def test_link_health_metrics_contract():
    """Quarantine reporting: the ladder state a member pushes with its
    heartbeat is served under the pinned names and label shapes —
    ``tdr_link_health{world=,rank=,peer=,link=}``,
    ``tdr_degraded_total{world=}`` as the sum of the members' rung
    engagements, and the probe counters bridged from the native
    registry."""
    for k in ("probe.sent", "probe.pong", "probe.timeout"):
        assert k in native_counters(), k  # the port's bridge exports them

    def unit(c, client, _err):
        views = _join_all(client, "w", 2)
        client.heartbeat(
            "w", 0, views[0]["incarnation"], views[0]["generation"],
            counters={"probe.sent": 5, "probe.pong": 4,
                      "probe.timeout": 1},
            link_health={
                "inter:r0": {"peer": 1, "score": 0.42, "degraded": 1,
                             "faults": 2},
                "intra:r0": {"peer": -1, "score": 0.97, "degraded": 0,
                             "faults": 0},
            },
            degraded_total=2)
        client.heartbeat(
            "w", 1, views[1]["incarnation"], views[1]["generation"],
            link_health={"inter:r1": {"peer": 0, "score": 0.9,
                                      "degraded": 0, "faults": 0}},
            degraded_total=1)
        body = client.metrics()
        assert _metric(body, 'tdr_link_health{world="w",rank="0",'
                       'peer="1",link="inter:r0"}') == pytest.approx(0.42)
        assert _metric(body, 'tdr_link_health{world="w",rank="0",'
                       'peer="-1",link="intra:r0"}') == pytest.approx(0.97)
        assert _metric(body, 'tdr_link_health{world="w",rank="1",'
                       'peer="0",link="inter:r1"}') == pytest.approx(0.9)
        assert _metric(body, 'tdr_degraded_total{world="w"}') == 3.0
        assert _metric(body, 'tdr_probe_sent_total{world="w"}') == 5.0
        assert _metric(body, 'tdr_probe_pong_total{world="w"}') == 4.0
        assert _metric(body, 'tdr_probe_timeout_total{world="w"}') == 1.0
        return _masked(body)

    _on_both(unit, lease_ms=1500)


# -------------------------------------------------- admission, health


def test_grow_admissions_coalesce_into_one_resize():
    """Batch admission: two joiners landing inside the grow-hold window
    ride ONE resize (one generation bump, one repack) instead of two
    back-to-back."""
    def unit(c, client, _err):
        views = _join_all(client, "w", 2, resizable=True)
        jr = [None, None]
        out = [None, None]

        def joiner(i):
            jr[i] = client.join("w", 2, rank=-1, resizable=True,
                                timeout_s=15)

        def incumbent(r):
            # Park once both joiners are parked at the coordinator.
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                with c._cv:
                    if len(c._worlds["w"].members) == 4:
                        break
                time.sleep(0.02)
            out[r] = client.sync("w", r, views[r]["incarnation"],
                                 timeout_s=10)

        run_ranks([None] * 4, lambda _w, i: joiner(i) if i < 2
                  else incumbent(i - 2))
        assert all(v["ok"] for v in out) and all(r["ok"] for r in jr)
        assert sorted(r["rank"] for r in jr) == [2, 3]
        assert all(v["world_size"] == 4 for v in out + jr)
        assert out[0]["resizes"] == 1  # ONE resize for both admissions
        return (sorted((_view(v) for v in out + jr),
                       key=lambda v: v["rank"]),
                _masked(client.metrics()))

    _on_both(unit, lease_ms=1500, grow_hold_ms=300)


def test_healthz_and_unknown_path():
    def unit(c, _client, _err):
        heads = []
        for path in (b"/healthz", b"/nope"):
            with socket.create_connection(("127.0.0.1", c.port),
                                          timeout=5) as s:
                s.sendall(b"GET " + path + b" HTTP/1.0\r\n\r\n")
                heads.append(s.recv(4096).split(b"\r\n", 1)[0])
        assert heads[0].startswith(b"HTTP/1.0 200")
        assert heads[1].startswith(b"HTTP/1.0 404")
        return heads

    _on_both(unit)


def test_admission_backpressure_retryable_with_retry_after():
    """A join the fleet cannot admit is RETRYABLE backpressure with a
    deterministic retry-after, not a hard failure: both the full
    non-resizable world and the world quota say so."""
    def unit(c, client, _err):
        _join_all(client, "w", 2)
        r = client.join("w", 2, rank=-1, timeout_s=5)
        assert not r["ok"] and r["retryable"]
        assert r["error"] == "fleet full"
        assert r["retry_after_s"] == pytest.approx(1.5)
        # Deterministic spread: the second reject backs off longer.
        r2 = client.join("w", 2, rank=-1, timeout_s=5)
        assert r2["retry_after_s"] == pytest.approx(3.0)
        q = client.join("other", 2, rank=0, timeout_s=5)
        assert not q["ok"] and q["retryable"]
        assert "quota" in q["error"]
        body = client.metrics()
        assert _metric(
            body, 'tdr_ctl_admission_rejects_total{world="w"}') == 2.0
        return [r, r2, q], _masked(body)

    _on_both(unit, lease_ms=1500, max_worlds=1)


def test_fair_share_division_with_floor():
    """``qp_fair`` divides the engine QP pool across worlds by join-time
    weight with a per-world floor; the share rides the view's
    ``qp_budget`` so members adopt it at the next rendezvous."""
    def unit(c, client, _err):
        va = _join_all(client, "a", 2, resizable=True)
        assert va[0]["qp_budget"] == 90  # alone: the whole pool
        vb = _join_all(client, "b", 2, resizable=True, weight=2.0)
        assert vb[0]["qp_budget"] == 60  # 90 * 2/(1+2)
        body = client.metrics()
        assert _metric(body, 'tdr_ctl_qp_share{world="a"}') == 30.0
        assert _metric(body, 'tdr_ctl_qp_share{world="b"}') == 60.0
        # The floor beats the proportional share for a featherweight.
        vt = _join_all(client, "tiny", 2, resizable=True, weight=0.01)
        body2 = client.metrics()
        assert _metric(body2, 'tdr_ctl_qp_share{world="tiny"}') == 5.0
        return ([v["qp_budget"] for v in va + vb + vt], _masked(body),
                _masked(body2))

    _on_both(unit, lease_ms=1500, qp_budget=90, qp_fair=True, qp_floor=5)


def test_heartbeat_after_leave_stops_and_is_rejected():
    """The heartbeat-after-leave fix, both sides: the coordinator
    refuses (never re-adopts) a push under a superseded identity, and
    the member-side Heartbeat stops sending under that identity until
    ``state_fn`` reports a different (incarnation, rank)."""
    def unit(c, client, _err):
        views = _join_all(client, "w", 2)
        inc1 = views[1]["incarnation"]
        client.leave("w", 1, inc1)
        r = client.heartbeat("w", 1, inc1, views[1]["generation"],
                             counters={"integrity.sealed": 7})
        assert not r["ok"] and r["error"] == "superseded"
        body = client.metrics()
        assert 'tdr_integrity_sealed_total{world="w",rank="1"}' \
            not in body
        state = {"v": (inc1, views[1]["generation"], 1)}
        sent = []
        real_hb = client.heartbeat
        client.heartbeat = (lambda *a, **kw:
                            sent.append(a) or real_hb(*a, **kw))
        hb = client.start_heartbeat("w", 1, lambda: state["v"],
                                    interval_s=3600)
        try:
            assert hb.beat() and hb._dead_key == (inc1, 1)
            n = len(sent)
            assert hb.beat() and len(sent) == n  # superseded: no push
            # ...and resumes the moment the identity changes (a RESIZE
            # moves the rank under the same incarnation).
            state["v"] = (inc1, views[1]["generation"], 0)
            hb.beat()
            assert len(sent) == n + 1
        finally:
            client.heartbeat = real_hb
            hb.stop()
        # (world, rank, generation) of each push; incarnations go in
        # the order the two joins arrived.
        return (_view(r), [(a[0], a[1], a[3]) for a in sent],
                _masked(body))

    _on_both(unit, lease_ms=1500)


def test_metrics_scrape_rate_limit_429():
    """A hot scraper gets 429 backpressure, not the render cost: the
    first scrape in the window is served, the second refused and
    counted."""
    def unit(c, client, err_cls):
        body = client.metrics()
        assert "tdr_ctl_scrape_throttled_total 0" in body
        with pytest.raises(err_cls, match="429") as ei:
            client.metrics()
        assert c._scrape_throttled == 1
        return _masked(body), str(ei.value), c._scrape_throttled

    _on_both(unit, scrape_min_interval_ms=30000)


def test_heartbeat_rate_limit_sheds_payload_keeps_lease():
    """Per-world heartbeat rate limit: an over-eager beater still renews
    its lease but the telemetry payload is shed and the shed counted —
    sealed stays at the first push."""
    def unit(c, client, _err):
        views = _join_all(client, "w", 2)
        inc, gen = views[0]["incarnation"], views[0]["generation"]
        r1 = client.heartbeat("w", 0, inc, gen,
                              counters={"integrity.sealed": 1})
        assert r1["ok"] and not r1.get("throttled")
        r2 = client.heartbeat("w", 0, inc, gen,
                              counters={"integrity.sealed": 2})
        assert r2["ok"] and r2["throttled"]  # lease renewed, payload shed
        body = client.metrics()
        assert _metric(body, 'tdr_ctl_hb_throttled_total{world="w"}') == 1
        assert _metric(body, 'tdr_integrity_sealed_total{world="w"}') == 1
        return _view(r1), _view(r2), _masked(body)

    _on_both(unit, lease_ms=1500, hb_min_interval_ms=60000)
