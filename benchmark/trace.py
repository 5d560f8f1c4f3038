"""The traced segment: a few of the cell's units under ``torch.profiler``
after the window, reduced to what the per-layer readers take.

The reduction reads the profiler's raw events: device operations
(kernels, copies, sets; not the ranges code marks on the device
timeline), and the host operations that were running meanwhile. It
gives the segment's wall time (``bench.segment``, a host range around
the units and the closing synchronise), the device's busy time (the
union of its operations), each operation's time and count by symbol,
the launches of kernels, and the idle gaps by what the host was doing
at each gap's middle (the innermost host operation there, else the
benchmark's own span, else ``python``).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SEGMENT = "bench.segment"
NOT_KERNELS = ("memcpy", "memset")


def run_segment(units: int, unit: Callable[[], dict],
                launches: Callable[[], Dict[str, int]], cuda: bool) -> dict:
    """Profile ``units`` calls of ``unit``; each record gets the port's
    own launch counts over its call (``launches`` reads the counter).
    Without ``cuda`` (a test on the CPU) the device is not traced."""
    def sync():
        if cuda:
            torch.cuda.synchronize()

    records = []
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SEGMENT):
            for _ in range(units):
                before = launches()
                rec = unit()
                after = launches()
                rec["launches"] = {k: after[k] - before.get(k, 0)
                                   for k in after}
                records.append(rec)
            sync()
    summary = summarize(prof.profiler.kineto_results.events())
    summary["units"] = records
    return summary


def _is_kernel(e) -> bool:
    """Copies and sets are named ``Memcpy ...`` and ``Memset ...``."""
    return not e.name().lower().startswith(NOT_KERNELS)


def summarize(events) -> dict:
    from torch.autograd import DeviceType

    dev, host = [], []
    seg = None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name(), _is_kernel(e)))
        elif e.device_type() == DeviceType.CPU:
            if e.name() == SEGMENT:
                seg = (e.start_ns(), e.end_ns())
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
    if seg is None:
        raise RuntimeError(f"the profile holds no {SEGMENT} range")
    dev.sort()
    by_name: Dict[str, List[float]] = {}
    for s, t, name, _ in dev:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (t - s) * 1e-9
        acc[1] += 1
    # The device's busy intervals and the gaps between them.
    busy, gaps, cur = 0, [], seg[0]
    for s, t, _, _ in dev:
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if t > cur:
            busy += t - cur
            cur = t
    if seg[1] > cur:
        gaps.append((cur, seg[1]))
    return {"window_s": (seg[1] - seg[0]) * 1e-9, "busy_s": busy * 1e-9,
            "ops": by_name,
            "kernels": sum(1 for *_, k in dev if k),
            "idle_by_host": _attribute(gaps, host)}


def _attribute(gaps, host) -> Dict[str, float]:
    """Seconds of device idle by the innermost host operation running at
    each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("bench.")]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = next((h[2] for h in spans if h[0] <= mid <= h[1]), "python")
        j = bisect.bisect_right(starts, mid) - 1
        # The innermost is the latest-starting one still running; a few
        # hundred back is deeper than any nesting below the benchmark's
        # own spans.
        for k in range(j, max(-1, j - 512), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(((n, v[0]) for n, v in summary["ops"].items()),
                 key=lambda x: -x[1])[:top]
    idle = sorted(summary["idle_by_host"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle]}
