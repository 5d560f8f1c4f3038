"""Flight recorder — the unified telemetry subsystem (the port's own
copy of ``rocnrdma_tpu/telemetry/``).

The native engine (``telemetry.cc``) records the full chunk lifecycle
— post → wire tx/rx → land → seal verify/NAK/retransmit → fold →
completion, plus copy-pool and ring-collective activity — into a
bounded ring of fixed-size timestamped events, with log2-bucket
latency/bandwidth histograms and a unified counter registry
alongside. The Python tracer (``utils.trace``) covers the framework
tiers (collectives, trainer, recovery ladder). The two share one
clock, CLOCK_MONOTONIC, so this package can merge them into a single
timeline: a training step renders from ``ring_allreduce`` down to an
individual chunk retransmit. ``torch.profiler`` stamps wall time
(CLOCK_REALTIME), another clock: a span meets the device trace through
the ``record_function`` range it opens while the profiler records, and
carries its device time as ``dev_s`` (``utils.trace``), which the
Perfetto export passes on as a slice argument.

Knobs:
  TDR_TELEMETRY       1 = record (default off; off costs one branch
                      per native event site); on, device spans carry
                      dev_s
  TDR_TELEMETRY_RING  native ring capacity in events (default 65536)
  TDR_TRACE_RING      Python tracer ring capacity (pre-existing)

Typical use::

    from rocnrdma_tpu_torch import telemetry
    telemetry.enable()
    ... run a workload ...
    events = telemetry.timeline()           # merged native + python
    telemetry.export_trace("trace.json", events=events)  # Perfetto
    print(telemetry.snapshot())             # counters + histograms
"""

from rocnrdma_tpu_torch.telemetry.recorder import (  # noqa: F401
    PHASES, TelEvent, counters, disable, drain, enable, enabled,
    events_from_wire, events_to_wire, histograms, hist_percentile,
    hist_percentiles, overlap_fraction, python_events, reset,
    ring_phase_split, snapshot, start_snapshot_writer, timeline)
from rocnrdma_tpu_torch.telemetry.perfetto import (  # noqa: F401
    collect_and_merge, export_trace, merge_fleet)

__all__ = [
    "PHASES", "TelEvent", "collect_and_merge", "counters", "disable",
    "drain", "enable", "enabled", "events_from_wire", "events_to_wire",
    "export_trace", "histograms", "hist_percentile", "hist_percentiles",
    "merge_fleet", "overlap_fraction", "python_events", "reset",
    "ring_phase_split", "snapshot", "start_snapshot_writer", "timeline",
]
