"""The PyTorch port's flight recorder (``rocnrdma_tpu_torch/telemetry/``)
and postmortem writer against the JAX package's:

- native events recorded by the port's library during a world-2
  allreduce, drained once, go through both packages' wire encoding,
  decoding and Perfetto writers (single-rank export and fleet merge)
  to equal JSON;
- the histogram bucket math equals the reference's (and the port's
  native fine-bucket edges), and ``overlap_fraction`` splits compute
  from staging overlap as ``tests/test_overlap.py`` holds the
  reference's;
- ``ring_phase_split`` charges each interval of a collective to the
  phase of the event that ends it, as ``tools/tdr_explain.py`` does;
- a forced rebuild with ``TDR_POSTMORTEM_DIR`` writes one bundle per
  rank with the reference's keys, which ``tools/tdr_explain.py``
  merges.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rocnrdma_tpu.telemetry import perfetto as ref_perfetto
from rocnrdma_tpu.telemetry import recorder as ref_recorder
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.telemetry import perfetto, recorder
from rocnrdma_tpu_torch.transport import engine as eng
from rocnrdma_tpu_torch.transport.engine import TransportError

from test_hier import port_band
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recording(monkeypatch):
    monkeypatch.setenv("TDR_TELEMETRY", "1")
    telemetry.enable()
    yield
    telemetry.disable()


def _allreduce_world2(**kw):
    worlds = local_worlds(2, port_band(8), **kw)
    bufs = [torch.ones(1 << 14) * (r + 1) for r in range(2)]
    run_ranks(worlds, lambda w, r: w.allreduce(bufs[r]))
    assert all(torch.equal(b, torch.full_like(b, 3.0)) for b in bufs)
    return worlds


def _as_ref(events):
    return [ref_recorder.TelEvent(**vars(e)) for e in events]


def test_recorder_and_perfetto_equal_the_reference(recording):
    worlds = _allreduce_world2()
    for w in worlds:
        w.close()
    native = telemetry.drain()
    assert {"ring_begin", "wire_tx", "wire_rx"} <= {e.name for e in native}
    events = telemetry.timeline(native=native)
    wire = recorder.events_to_wire(events)
    assert json.dumps(wire) == json.dumps(
        ref_recorder.events_to_wire(_as_ref(events)))
    back = recorder.events_from_wire(json.loads(json.dumps(wire)))
    ref_back = ref_recorder.events_from_wire(json.loads(json.dumps(wire)))
    assert [vars(e) for e in back] == [vars(e) for e in ref_back]
    labels = {1: "rank0/emu", 2: "rank1/emu"}
    got = perfetto.export_trace(events=back, engine_labels=labels)
    want = ref_perfetto.export_trace(events=ref_back, engine_labels=labels)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    segments = {r: {"events": wire, "clock_offset_ns": 1000 * r,
                    "dropped": r} for r in range(2)}
    assert json.dumps(perfetto.merge_fleet(segments), sort_keys=True) == \
        json.dumps(ref_perfetto.merge_fleet(segments), sort_keys=True)


def test_histogram_math_equals_the_reference():
    for b in range(-1, 70):
        assert recorder.bucket_upper(b) == ref_recorder.bucket_upper(b)
    n = eng.telemetry_hist_fine_buckets()
    assert n > 64
    for b in range(n):
        assert recorder.fine_bucket_upper(b) == \
            ref_recorder.fine_bucket_upper(b)
    # The native edges saturate at 2^64 near the top; the reference's
    # own pins (tests/test_telemetry.py) are these indices.
    for b in list(range(48)) + [80, 81, 87, 100, 495]:
        assert recorder.fine_bucket_upper(b) == \
            eng.telemetry_hist_fine_upper(b), b
    rng = np.random.default_rng(2)
    for size in (64, n):
        row = [int(x) for x in rng.integers(0, 5, size)]
        for q in (0, 1, 50, 90, 99, 100):
            assert recorder.hist_percentile(row, q) == \
                ref_recorder.hist_percentile(row, q)
        assert recorder.hist_percentiles(row) == \
            ref_recorder.hist_percentiles(row)
    assert recorder.hist_percentile([0] * 64, 50) == 0


def test_overlap_fraction_compute_staging_split():
    t0, ms = 1_000_000_000, 1_000_000

    def span(name, start_ms, dur_ms):
        return recorder.TelEvent(ts_ns=t0 + (start_ms + dur_ms) * ms,
                                 name=name, source="python",
                                 fields={"dur_s": dur_ms / 1000.0})

    def wire(at_ms):
        return recorder.TelEvent(ts_ns=t0 + at_ms * ms, name="wire_tx",
                                 source="native")

    events = [span("trainer.grads", 0, 100),
              span("trainer.backward", 0, 60),
              wire(10), wire(30), wire(50), wire(70), wire(90),
              wire(150), wire(170)]
    out = recorder.overlap_fraction(events, dropped=0)
    assert out == ref_recorder.overlap_fraction(_as_ref(events), dropped=0)
    assert (out["wire_events"], out["wire_in_span"],
            out["wire_in_compute"]) == (7, 5, 3)
    assert out["compute_overlap_fraction"] == round(3 / 7, 4)
    assert out["staging_overlap_fraction"] == round(2 / 7, 4)
    tainted = recorder.overlap_fraction(events, dropped=3)
    assert tainted["tainted"] and tainted["dropped"] == 3
    weird = [span("trainer.backward", 0, 60), wire(10), wire(30)]
    w = recorder.overlap_fraction(weird, dropped=0)
    assert w["wire_in_compute"] <= w["wire_in_span"]


def test_ring_phase_split_charges_the_ending_event():
    ns = 1_000_000

    def ev(name, at_ms, coll):
        return recorder.TelEvent(ts_ns=at_ms * ns, name=name, coll=coll)

    events = [ev("ring_begin", 0, 7), ev("post_send", 1, 7),
              ev("wire_tx", 4, 7), ev("wire_rx", 5, 7), ev("land", 9, 7),
              ev("fold", 10, 7), ev("ring_end", 12, 7),
              ev("post_send", 100, 8), ev("wire_tx", 102, 8),
              ev("wire_tx", 50, 0)]       # no collective: not counted
    out = recorder.ring_phase_split(events)
    assert out["collectives"] == 2
    assert out["post"] == pytest.approx(1e-3)
    assert out["wire"] == pytest.approx(4e-3 + 2e-3)
    assert out["land"] == pytest.approx(4e-3)
    assert out["fold"] == pytest.approx(1e-3)
    assert out["stall"] == pytest.approx(2e-3)
    phases = sum(out[p] for p in recorder.PHASES)
    assert phases == pytest.approx(12e-3 + 2e-3)


def test_postmortem_bundles_write_and_merge(recording, monkeypatch,
                                            tmp_path):
    """A retryable failure, then a rebuild on both ranks: one bundle per
    rank with the reference's keys (incarnation None and clock offset 0
    without a coordinator), merged by ``tools/tdr_explain.py``."""
    monkeypatch.setenv("TDR_POSTMORTEM_DIR", str(tmp_path))
    worlds = _allreduce_world2(world_name="pmworld")
    try:
        worlds[1]._teardown()
        with pytest.raises(TransportError) as err:
            worlds[1].allreduce(torch.ones(8))
        assert err.value.retryable
        run_ranks(worlds, lambda w, r: w.rebuild(reason="test incident"))
        assert [w._postmortems for w in worlds] == [1, 1]
    finally:
        for w in worlds:
            w.close()
    inc_dir = tmp_path / "pmworld" / "incident-g0"
    assert sorted(p.name for p in inc_dir.iterdir()) == ["rank0.json",
                                                         "rank1.json"]
    b0 = json.loads((inc_dir / "rank0.json").read_text())
    assert set(b0) == {"format", "world", "rank", "generation",
                       "incarnation", "error", "wall_time", "monotonic_ns",
                       "digest", "seal_config", "coll_seq", "counters",
                       "dropped", "clock_offset_ns", "events"}
    assert b0["format"] == "tdr-postmortem-v1"
    assert (b0["world"], b0["rank"], b0["generation"]) == ("pmworld", 0, 0)
    assert b0["incarnation"] is None and b0["clock_offset_ns"] == 0
    assert b0["error"] == "test incident"
    assert "integrity.sealed" in b0["counters"]
    assert isinstance(b0["events"], list) and b0["events"]

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from tdr_explain import explain_postmortem

    merged = explain_postmortem(str(inc_dir))
    inc = merged["incident"]
    assert inc["world"] == "pmworld"
    assert sorted(inc["ranks"]) == ["0", "1"]
    assert inc["ranks"]["1"]["error"] == "test incident"


def test_postmortem_noop_without_dir(monkeypatch):
    monkeypatch.delenv("TDR_POSTMORTEM_DIR", raising=False)
    worlds = local_worlds(2, port_band(8))
    try:
        for w in worlds:
            w._write_postmortem("x")
            assert w._postmortems == 0
    finally:
        for w in worlds:
            w.close()
