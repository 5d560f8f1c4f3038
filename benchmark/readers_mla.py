"""Readers of the latent-attention, routed-expert cells
(``metrics/<name>.decode-mla.py``), on the arithmetic of
:mod:`benchmark.roofline_mla`.

Each takes the :class:`~benchmark.harness.Run` of a traced run and
returns the metric's value, or None where the run holds nothing to read
(no device trace, no launch of the kernel, launches that the cell's
shapes do not account for, or a program without the span). The sizes
come from the cell's configuration file, found by the run's name.
"""

from __future__ import annotations

from typing import Optional

from benchmark import roofline_mla as rl


def _config(run) -> dict:
    from benchmark import harness

    return harness.Bench().config(run.shape.name)


def mfu_generate(run) -> Optional[float]:
    """The least time the chip's peaks allow for every call of the
    window (:func:`roofline_mla.generate_call_min_s`), as a share of the
    window's time."""
    win = run.window
    if not win["units"]:
        return None
    cfg = _config(run)
    need = sum(rl.generate_call_min_s(cfg, u["b"], u["p"], u["new"],
                                      run.shape.dtype) for u in win["units"])
    return 100.0 * need / win["elapsed"]


def _spent(run, symbol: str) -> float:
    return sum(v[0] for name, v in run.trace["ops"].items() if symbol in name)


def mla_decode_roofline(run) -> Optional[float]:
    """K7's Σ least time over its launches / Σ device time of its
    symbols in the traced segment. A call launches it once a layer in
    each of its ``new - 1`` decode steps, step j over ``p + j`` live
    positions; other counts are not accounted for."""
    seg = run.trace
    if not seg:
        return None
    cfg = _config(run)
    layers, need = cfg["num_hidden_layers"], 0.0
    for u in seg["units"]:
        if u["launches"].get("mla_decode", 0) != layers * (u["new"] - 1):
            return None
        need += layers * sum(
            rl.mla_decode_bound_s(cfg, u["b"], u["p"] + j, run.shape.dtype)
            for j in range(1, u["new"]))
    spent = _spent(run, rl.MLA_DECODE)
    return 100.0 * need / spent if spent > 0 and need > 0 else None


def moe_roofline(run) -> Optional[float]:
    """The grouped GEMMs' Σ least time over their launches / Σ device
    time of their symbols in the traced segment. Each expert layer of a
    decode step launches each kernel once over the call's b tokens; the
    rest of a unit's launches are the prefill's, which covers b·p tokens
    in equal chunks of rows (one launch of each kernel an expert layer a
    chunk)."""
    seg = run.trace
    if not seg:
        return None
    cfg = _config(run)
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    need = 0.0
    for u in seg["units"]:
        n = u["launches"]
        ups, downs = n.get("moe_gemm_up", 0), n.get("moe_gemm_down", 0)
        decode = moe_layers * (u["new"] - 1)
        chunks, rest = divmod(ups - decode, moe_layers)
        if ups != downs or rest or chunks < 1:
            return None
        dec = rl.moe_gemm_bounds_s(cfg, u["b"], run.shape.dtype)
        pre = rl.moe_gemm_bounds_s(cfg, u["b"] * u["p"] // chunks,
                                   run.shape.dtype)
        need += decode * sum(dec) + chunks * moe_layers * sum(pre)
    spent = _spent(run, rl.MOE_GEMM)
    return 100.0 * need / spent if spent > 0 and need > 0 else None


def moe_ms(run) -> Optional[float]:
    """Device ms a call of the expert layers in its prefill: Σ ``dev_s``
    of the program's ``moe.experts`` spans (the eager prefill's; the
    decode step's replays record none) over the segment's calls."""
    from benchmark.spans import _timed

    units = run.trace["units"] if run.trace else []
    spans = _timed("moe.experts")
    if not units or not spans:
        return None
    return 1e3 * sum(f["dev_s"] for f in spans) / len(units)
