"""The port's link-health scoring and degradation ladder
(``rocnrdma_tpu_torch/collectives/health.py``) against the reference's,
as ``tests/test_health.py`` holds the JAX package's.

The nine units are the reference's, run through ``both``: every call
goes to the port's registry and to the reference's with the same
arguments under the same environment, the two answers must be equal,
and after each call the two registries' whole state must be equal —
each link's EWMA, peak, sample and fault counts, engaged rungs and
per-rung streaks, the degraded totals and the frozen schedule and wire
verdicts.

The two world-8 pins run over the port's worlds (eight ranks emulating
two hosts of four, ``tests/test_torch_hier.py``'s construction): a
netem brownout on the delegate links' a->b direction degrades hier to
flat with bitwise parity and ZERO rebuilds, while the same brownout
under ``TDR_NO_DEGRADE=1`` escalates deadline -> probe verdict ->
retryable error -> rebuild.
"""

import numpy as np
import pytest

from rocnrdma_tpu.collectives import health as ref_health
from rocnrdma_tpu_torch.collectives import health as port_health
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.transport.engine import (TransportError,
                                                 fault_plan_clauses,
                                                 fault_plan_hits,
                                                 fault_plan_reset)
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import KEYS8, port_band, run_all

W = "hw"
MB = 1 << 20


def _state(mod):
    """A registry's whole state, as plain values."""
    reg = mod._REG
    with reg._mu:
        return {
            "links": {w: {name: {s: (list(getattr(ln, s))
                                     if s == "streak" else getattr(ln, s))
                                 for s in ln.__slots__}
                          for name, ln in links.items()}
                      for w, links in reg._worlds.items()},
            "degraded_total": dict(reg._degraded_total),
            "verdicts": {w: dict(v) for w, v in reg._verdicts.items()},
            "wire_verdicts": {w: dict(v)
                              for w, v in reg._wire_verdicts.items()},
        }


class _Both:
    """``both.f(...)`` calls ``f`` on the port's module and on the
    reference's, asserts equal answers and equal registry state after
    the call, and returns the port's answer."""

    def __getattr__(self, name):
        def call(*args, **kwargs):
            got = getattr(port_health, name)(*args, **kwargs)
            want = getattr(ref_health, name)(*args, **kwargs)
            assert got == want, (name, args, got, want)
            assert _state(port_health) == _state(ref_health), name
            return got
        return call


both = _Both()


@pytest.fixture(autouse=True)
def clean_health():
    both.reset()
    yield
    both.reset()


def _feed(link, mbps, n=1, peer=1, world=W):
    """n goodput samples at `mbps` on `link` (2 MiB phases — above the
    default observation floor), fed to both registries."""
    for _ in range(n):
        both.observe(world, link, peer, 2 * MB, (2 * MB / 1e6) / mbps)


# ------------------------------------------------------------- units


def test_observe_floor_ignores_small_phases(monkeypatch):
    """Phases below TDR_HEALTH_MIN_BYTES measure latency and scheduler
    jitter, not link bandwidth — they must not move the score."""
    monkeypatch.setenv("TDR_HEALTH_MIN_BYTES", str(MB))
    both.observe(W, "inter:r0", 1, 4096, 10.0)  # 0.0004 MB/s "link"
    assert both.snapshot(W) == {}
    assert both.score(W, "inter:r0") == 1.0
    both.observe(W, "inter:r0", 1, 2 * MB, 0.02)
    assert "inter:r0" in both.snapshot(W)


def test_score_is_relative_to_own_peak(monkeypatch):
    """No absolute MB/s threshold: the score is EWMA/peak, and the
    peak only chases the EWMA up."""
    monkeypatch.setenv("TDR_HEALTH_ALPHA", "1.0")
    monkeypatch.setenv("TDR_HEALTH_ENGAGE_STREAK", "64")
    _feed("inter:r0", 100, n=3)
    assert both.score(W, "inter:r0") == 1.0
    _feed("inter:r0", 25)
    assert both.score(W, "inter:r0") == pytest.approx(0.25)
    _feed("inter:r0", 200)  # new sustained best
    assert both.score(W, "inter:r0") == 1.0
    _feed("inter:r0", 100)  # the old "healthy" is now half speed
    assert both.score(W, "inter:r0") == pytest.approx(0.5)


def test_streak_gates_soft_engagement(monkeypatch):
    """Soft (goodput) evidence engages a rung only after
    TDR_HEALTH_ENGAGE_STREAK consecutive below-threshold samples, and a
    good sample resets the run. Healing needs threshold +
    TDR_HEALTH_HEAL (hysteresis)."""
    monkeypatch.setenv("TDR_HEALTH_ALPHA", "1.0")
    monkeypatch.setenv("TDR_HEALTH_ENGAGE_STREAK", "3")
    monkeypatch.setenv("TDR_HEALTH_WIRE", "0.75")
    monkeypatch.setenv("TDR_HEALTH_FALLBACK", "0.25")
    _feed("inter:r0", 100, n=3)
    _feed("inter:r0", 60, n=2)  # score 0.6 < 0.75, streak 2/3
    assert not both.wire_downgrade(W)
    assert port_health._REG._worlds[W]["inter:r0"].streak[0] == 2
    _feed("inter:r0", 100)      # good sample resets the streak
    assert port_health._REG._worlds[W]["inter:r0"].streak[0] == 0
    _feed("inter:r0", 60, n=2)
    assert not both.wire_downgrade(W)
    _feed("inter:r0", 60)       # third consecutive: engage
    assert both.wire_downgrade(W)
    assert not both.fallback_active(W)  # 0.6 > fallback rung
    assert both.degraded_total(W) == 1
    assert both.snapshot(W)["inter:r0"]["degraded"] == 1
    _feed("inter:r0", 100)      # 1.0 > 0.75 + heal margin: disengage
    assert not both.wire_downgrade(W)
    assert both.degraded_total(W) == 1  # monotone incident count


def test_fallback_rung_and_degraded_links(monkeypatch):
    monkeypatch.setenv("TDR_HEALTH_ALPHA", "1.0")
    monkeypatch.setenv("TDR_HEALTH_ENGAGE_STREAK", "1")
    _feed("inter:r2", 100, n=3, peer=6)
    _feed("inter:r2", 10, peer=6)  # 0.1: below all three rungs at once
    assert both.wire_downgrade(W)
    assert both.wire_int8(W)
    assert both.fallback_active(W)
    assert both.degraded_links(W) == {"inter:r2": 6}
    assert both.degraded_total(W) == 3  # every rung counted


def test_wire_verdict_frozen_per_collective(monkeypatch):
    """One frozen 'f32'|'bf16'|'int8' wire answer per (world,
    collective seq); TDR_NO_WIRE_Q8 gates the int8 answer down to
    bf16."""
    monkeypatch.setenv("TDR_HEALTH_ALPHA", "1.0")
    monkeypatch.setenv("TDR_HEALTH_ENGAGE_STREAK", "1")
    _feed("inter:r0", 100, n=3)
    _feed("inter:r0", 55)  # 0.55: bf16 + int8 rungs, not fallback
    assert both.wire_int8(W) and both.wire_downgrade(W)
    assert not both.fallback_active(W)
    assert both.wire_verdict(W, 7) == "int8"
    monkeypatch.setenv("TDR_NO_WIRE_Q8", "1")
    assert both.wire_verdict(W, 8) == "bf16"  # q8 not negotiable
    monkeypatch.delenv("TDR_NO_WIRE_Q8")
    _feed("inter:r0", 100)  # heal: disengage both rungs
    assert not both.wire_int8(W)
    assert both.wire_verdict(W, 7) == "int8"  # frozen replay
    assert both.wire_verdict(W, 9) == "f32"   # fresh seq, healed


def test_intra_links_never_steer_schedule(monkeypatch):
    """Both rungs mitigate the DELEGATE link, so a collapsed intra score
    is reported but never engages a rung."""
    monkeypatch.setenv("TDR_HEALTH_ALPHA", "1.0")
    monkeypatch.setenv("TDR_HEALTH_ENGAGE_STREAK", "1")
    _feed("intra:r1", 100, n=3, peer=-1)
    _feed("intra:r1", 5, n=4, peer=-1)
    assert not both.wire_downgrade(W)
    assert not both.fallback_active(W)
    assert both.degraded_links(W) == {}
    assert both.degraded_total(W) == 0
    assert both.snapshot(W)["intra:r1"]["score"] < 0.1
    both.fault(W, "intra:r1", -1, kind="stall")  # hard intra evidence
    assert not both.fallback_active(W)


def test_fault_hard_engages_without_history():
    """Hard evidence (stall/deadline/hung verdicts) engages immediately,
    with no streak and no goodput history."""
    both.fault(W, "inter:r3", 7, kind="hung")
    assert both.fallback_active(W)
    assert both.wire_downgrade(W)
    assert both.degraded_links(W) == {"inter:r3": 7}
    snap = both.snapshot(W)["inter:r3"]
    assert snap["faults"] == 1 and snap["score"] == 0.0


def test_no_degrade_disables_ladder(monkeypatch):
    """TDR_NO_DEGRADE=1: scoring continues but no query reports an
    engaged rung and every schedule verdict is 'hier'."""
    monkeypatch.setenv("TDR_NO_DEGRADE", "1")
    assert not both.ladder_enabled()
    both.fault(W, "inter:r0", 1, kind="stall")
    assert not both.fallback_active(W)
    assert not both.wire_downgrade(W)
    assert both.schedule_verdict(W, 8) == "hier"
    assert both.snapshot(W)["inter:r0"]["degraded"] == 1


def test_schedule_verdict_frozen_and_canary_cadence(monkeypatch):
    """One verdict per (world, collective seq), frozen at first ask,
    with every TDR_HEALTH_PROBE_EVERY-th candidate a 'canary'."""
    monkeypatch.setenv("TDR_HEALTH_ALPHA", "1.0")
    monkeypatch.setenv("TDR_HEALTH_PROBE_EVERY", "4")
    both.fault(W, "inter:r0", 1, kind="stall")
    assert both.schedule_verdict(W, 4) == "canary"
    assert both.schedule_verdict(W, 5) == "flat"
    assert both.schedule_verdict(W, 7) == "flat"
    assert both.schedule_verdict(W, 8) == "canary"
    _feed("inter:r0", 100, n=2)
    assert not both.fallback_active(W)
    assert both.schedule_verdict(W, 5) == "flat"   # frozen
    assert both.schedule_verdict(W, 9) == "hier"   # fresh


# ---------------------------------------- world-8 chaos (acceptance)


@pytest.fixture(scope="module")
def world8():
    last = None
    for _ in range(3):
        try:
            worlds = local_worlds(8, port_band(8 * 4 + 8), channels=1,
                                  topology=list(KEYS8))
            break
        except (TransportError, TimeoutError, OSError) as e:
            last = e
    else:
        raise last
    try:
        yield worlds
    finally:
        for w in worlds:
            try:
                w.close()
            except Exception:
                pass


# The reference's brownout: netem riders scoped to the delegate links'
# a->b direction (the inter tier rings are the only stream-tier,
# rank-0->peer-1 links in the process), so the flat fallback path is
# clean.
CHAOS_PLAN = ("send:tier=stream:rank=0:peer=1:delay=2000:1000,"
              "send:tier=stream:rank=0:peer=1:reorder=4,"
              "send:tier=stream:rank=0:peer=1:throttle=8")


def _chaos_env(monkeypatch):
    """The reference's ladder tuning for the soak, the q8 rung off (its
    data is not in the int8-exact regime)."""
    monkeypatch.setenv("TDR_HEALTH_MIN_BYTES", "262144")
    monkeypatch.setenv("TDR_HEALTH_WIRE", "0.6")
    monkeypatch.setenv("TDR_HEALTH_FALLBACK", "0.4")
    monkeypatch.setenv("TDR_HEALTH_ENGAGE_STREAK", "2")
    monkeypatch.setenv("TDR_HEALTH_PROBE_EVERY", "4")
    monkeypatch.setenv("TDR_NO_WIRE_Q8", "1")
    monkeypatch.delenv("TDR_COLL_DEADLINE_MS", raising=False)
    monkeypatch.delenv("TDR_NO_DEGRADE", raising=False)


def _sweep(worlds, data, expect, n):
    for _ in range(n):
        bufs = [data[r].copy() for r in range(len(worlds))]
        run_all(worlds, lambda r: worlds[r].allreduce(bufs[r],
                                                      algo="hier"))
        for r in range(len(worlds)):
            assert bufs[r].tobytes() == expect.tobytes(), f"rank {r}"


def test_world8_chaos_soak_degrades_without_rebuild(world8, monkeypatch):
    """A world-8 hier soak with the delegate direction browned out
    (delay+reorder+throttle) keeps BITWISE parity with zero rebuilds:
    the port's ladder reroutes hier->flat instead of escalating."""
    _chaos_env(monkeypatch)
    wname = world8[0].world_name
    count = (2 * MB) // 4  # 2 MiB f32 -> 512 KiB inter shard
    rng = np.random.default_rng(7)
    data = rng.integers(-64, 64, (8, count)).astype(np.float32)
    expect = data.sum(axis=0)
    rebuilds0 = trace.counter("world.rebuild")
    degraded0 = trace.counter("algo.degraded")

    _sweep(world8, data, expect, 3)  # baseline: peaks define healthy
    assert not port_health.fallback_active(wname)

    monkeypatch.setenv("TDR_FAULT_PLAN", CHAOS_PLAN)
    fault_plan_reset()
    try:
        for _ in range(14):
            _sweep(world8, data, expect, 1)
            if port_health.fallback_active(wname):
                break
        hits = sum(fault_plan_hits(i)
                   for i in range(fault_plan_clauses()))
        assert hits > 0                            # riders fired
        assert port_health.fallback_active(wname)  # the ladder engaged
        links = port_health.degraded_links(wname)
        assert links and all(k.startswith("inter") for k in links)
        _sweep(world8, data, expect, 2)  # the flat reroute, same bits
        assert trace.counter("algo.degraded") > degraded0
    finally:
        monkeypatch.delenv("TDR_FAULT_PLAN", raising=False)
        fault_plan_reset()
    assert trace.counter("world.rebuild") == rebuilds0  # ZERO rebuilds


def test_world8_no_degrade_escalates_to_rebuild(world8, monkeypatch):
    """The same brownout with the ladder disabled walks the escalation
    ladder: the per-collective deadline fires, the probe classifies the
    peers alive-but-slow, every rank surfaces a RETRYABLE error, and
    the world rebuilds and carries traffic."""
    _chaos_env(monkeypatch)
    monkeypatch.setenv("TDR_NO_DEGRADE", "1")
    monkeypatch.setenv("TDR_COLL_DEADLINE_MS", "400")
    count = MB // 4  # 1 MiB f32 -> 256 KiB inter shard
    rng = np.random.default_rng(11)
    data = rng.integers(-64, 64, (8, count)).astype(np.float32)
    expect = data.sum(axis=0)
    rebuilds0 = trace.counter("world.rebuild")
    gen0 = world8[0].generation

    # Every delegate frame pays 700 ms: no inter ring can finish inside
    # the 400 ms deadline, and the peers stay alive (a SLOW fleet).
    monkeypatch.setenv("TDR_FAULT_PLAN", "send:tier=stream:delay=700000")
    fault_plan_reset()
    errs = [None] * 8

    def run(r):
        try:
            world8[r].allreduce(data[r].copy(), algo="hier")
        except TransportError as e:
            errs[r] = e

    try:
        run_all(world8, run)
    finally:
        monkeypatch.delenv("TDR_FAULT_PLAN", raising=False)
        fault_plan_reset()
    assert all(e is not None for e in errs), errs
    assert all(e.retryable for e in errs), errs
    msgs = " | ".join(str(e) for e in errs)
    assert "deadline exceeded" in msgs, msgs
    assert "peer alive (slow link)" in msgs, msgs
    assert all(e.kind != "hung" for e in errs), msgs

    monkeypatch.delenv("TDR_COLL_DEADLINE_MS", raising=False)
    run_all(world8, lambda r: world8[r].rebuild(
        max_attempts=8, backoff_s=0.05, timeout_ms=15000))
    assert [w.generation for w in world8] == [gen0 + 1] * 8
    assert trace.counter("world.rebuild") >= rebuilds0 + 8
    _sweep(world8, data, expect, 1)
