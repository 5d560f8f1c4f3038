"""Shared arithmetic of the readers of the program's device-timed spans
(``metrics/{forward,backward,optimizer}_ms.train.py``,
``metrics/{prefill,decode_step}_ms.<cell>.py``).

The port's tracer (``rocnrdma_tpu_torch.utils.trace``) gives a span
opened with a CUDA device its device seconds, ``dev_s``, while
``torch.profiler`` records. In a traced run only the traced segment's
units run under the profiler, so the spans that carry ``dev_s`` are the
segment's own. A reader returns None where the program records no such
span (a tree without them), or where their number does not match the
segment's units: one ``trainer.forward``, ``trainer.backward`` and
``trainer.apply`` a step; one ``generate.prefill`` and one
``generate.decode`` a call, of the call's rows and prompt, the decode of
the call's new tokens less one steps.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def _timed(name: str) -> List[dict]:
    """The fields of every span ``name`` that carries ``dev_s``, oldest
    first."""
    from rocnrdma_tpu_torch.utils.trace import trace

    return [f for _, _, f in trace.events(name) if "dev_s" in f]


def train_ms(run, name: str) -> Optional[float]:
    """Device ms a step of span ``name``, over the segment's steps."""
    units = run.trace["units"] if run.trace else []
    spans = _timed(name)
    if not units or any("s" not in u for u in units) \
            or len(spans) != len(units):
        return None
    return 1e3 * sum(f["dev_s"] for f in spans) / len(spans)


def _calls(run) -> Optional[Tuple[List[dict], List[dict]]]:
    """The prefill and decode spans of the segment's calls, in order, or
    None where they do not match the calls one to one."""
    units = run.trace["units"] if run.trace else []
    pre, dec = _timed("generate.prefill"), _timed("generate.decode")
    if not units or len(pre) != len(units) or len(dec) != len(units):
        return None
    for p, d, u in zip(pre, dec, units):
        if "new" not in u or (p.get("b"), p.get("p"), d.get("steps")) != (
                u["b"], u["p"], u["new"] - 1):
            return None
    return pre, dec


def prefill_ms(run) -> Optional[float]:
    """Device ms of a call's prefill (the cache zeroed, the eager
    forward over the prompt, the first token picked)."""
    calls = _calls(run)
    if calls is None:
        return None
    pre, _ = calls
    return 1e3 * sum(f["dev_s"] for f in pre) / len(pre)


def decode_step_ms(run) -> Optional[float]:
    """Device ms of one graphed decode step: the calls' decode time over
    their steps."""
    calls = _calls(run)
    if calls is None:
        return None
    _, dec = calls
    steps = sum(f["steps"] for f in dec)
    return 1e3 * sum(f["dev_s"] for f in dec) / steps if steps else None
